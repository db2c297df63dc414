"""RG-LRU linear recurrence (B5): the Hopper kernel's wrapper, plain version.

``rglru_scan`` has the signature of ``repro.kernels.rglru.rglru_scan``
minus the TPU-only ``interpret``: log_a, b (B, S, R), optional h0 (B, R),
returning (h (B, S, R), h_last (B, R)) in fp32 (inputs of another float
dtype are cast to fp32 first, as the reference's kernel does at load).
``chunk`` and ``r_block`` left as None resolve through the find-db
(``kernels.findb``) for the tensors' device; any S and R are taken.

* On CUDA tensors it launches ``csrc/rglru.cu`` (built by
  ``repro_torch.kernels.build``) on the current stream, or raises. There is
  no fallback. One call is one CUDA launch of B5: a single pass over time,
  each block carrying h for ``r_block`` channels through a shared-memory
  ring of tiles of ``chunk`` steps that its threads fill by cp.async (see
  the source's header); ``plan`` says what a launch will use.
* On CPU tensors it runs ``rglru_reference``, the plain PyTorch version of
  ``repro.kernels.ref.rglru_ref``: an associative scan with h0 folded into
  the first step.
* On meta tensors (the dry-run) it returns empty h and h_last, reporting
  B5's work to ``analysis.cost``; nothing launches.

``launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

launches = 0
_fns = {}


def exp_cpu_f64(x):
    """exp of an fp32 tensor. On the CPU it is taken in float64 and rounded
    once: PyTorch's fp32 CPU exp has returned one intra-op thread's share
    of a large tensor with relative errors up to 1.5e-4 on the first call
    in a process run on several threads (tools/probe_cpu_exp.py, torch
    2.13: fp32 33 of 240 fresh processes, on one thread 0, float64 0)."""
    if x.device.type == "cpu":
        return torch.exp(x.double()).to(x.dtype)
    return torch.exp(x)


def rglru_reference(log_a, b, h0=None):
    """Plain version: h_t = exp(log_a_t) * h_{t-1} + b_t in fp32.

    A Hillis-Steele associative scan over S with the reference's combine
    ``(la1 + la2, exp(la2) * b1 + b2)``; h0 is folded into the first step,
    as ``ref.rglru_ref`` does. Returns (h (B, S, R), h_last (B, R)).
    """
    la, h = log_a.float(), b.float()
    if h0 is not None:
        first = h[:, :1] + exp_cpu_f64(la[:, :1]) * h0.float()[:, None]
        h = torch.cat([first, h[:, 1:]], dim=1)
    S, d = la.shape[1], 1
    while d < S:
        h = torch.cat(
            [h[:, :d], exp_cpu_f64(la[:, d:]) * h[:, :-d] + h[:, d:]], dim=1)
        la = torch.cat([la[:, :d], la[:, d:] + la[:, :-d]], dim=1)
        d *= 2
    return h, h[:, -1]


def _kernel():
    if not _fns:
        from repro_torch.kernels import build
        lib = build.load("rglru")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.rglru_fwd.restype = i32
        lib.rglru_plan.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
        lib.rglru_plan.restype = i32
        lib.rglru_error_string.argtypes = [i32]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _fns.update(fwd=lib.rglru_fwd, plan=lib.rglru_plan,
                    err=lib.rglru_error_string)
    return _fns


def _check_r_block(r_block):
    if not 1 <= r_block <= 1024:
        raise ValueError(f"r_block {r_block}: a block holds 1..1024 channels")


def plan(S, R, chunk, r_block):
    """The launch plan of the kernel for a shape and config: {"depth": steps
    of a ring tile, "stages", "smem": bytes of shared memory a block,
    "threads"}."""
    _check_r_block(r_block)
    fns = _kernel()
    out = (ctypes.c_int * 4)()
    rc = fns["plan"](S, R, chunk, r_block, out)
    if rc != 0:
        raise ValueError(f"rglru plan for S={S} R={R} chunk={chunk} "
                         f"r_block={r_block}: {fns['err'](rc).decode()}")
    return {"depth": out[0], "stages": out[1], "smem": out[2],
            "threads": out[3]}


def _launch(log_a, b, h0, chunk, r_block):
    global launches
    B, S, R = log_a.shape
    dev = log_a.device
    if b.device != dev or (h0 is not None and h0.device != dev):
        raise ValueError("rglru_scan: log_a, b and h0 must be on one device")
    _check_r_block(r_block)
    if dev.type != "cuda":
        raise ValueError(f"the rglru kernel runs on CUDA tensors, not {dev}")
    fns = _kernel()
    la = log_a.float().contiguous()
    bb = b.float().contiguous()
    h0c = None if h0 is None else h0.float().contiguous()
    h = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, R), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fns["fwd"](la.data_ptr(), bb.data_ptr(),
                    None if h0c is None else h0c.data_ptr(), h.data_ptr(),
                    h_last.data_ptr(), B, S, R, chunk, r_block, stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel launch failed: "
                           f"{fns['err'](rc).decode()} ({rc})")
    launches += 1
    return h, h_last


def resolve_blocks(log_a, chunk=None, r_block=None):
    """(chunk, r_block), each left as None taken from the find-db's config
    for log_a's shape and device (``findb.DEFAULTS`` on a miss)."""
    if chunk is None or r_block is None:
        from repro_torch.kernels import findb
        B, S, R = log_a.shape
        tuned = findb.lookup_or_default(
            "rglru", findb.rglru_shape_key(B=B, S=S, R=R),
            hardware=findb.hardware_key(log_a.device))
        chunk = tuned["chunk"] if chunk is None else chunk
        r_block = tuned["r_block"] if r_block is None else r_block
    return int(chunk), int(r_block)


def _meta(log_a, b, h0, r_block):
    """B5's outputs on the meta device, their work reported."""
    from repro_torch.analysis import cost, roofline
    _check_r_block(r_block)
    B, S, R = log_a.shape
    cost.report_kernel("B5", roofline.rglru_work(B, S, R, h0 is not None))
    dev = log_a.device
    return (torch.empty((B, S, R), dtype=torch.float32, device=dev),
            torch.empty((B, R), dtype=torch.float32, device=dev))


def rglru_scan(log_a, b, h0=None, *, chunk=None, r_block=None):
    """log_a, b: (B, S, R); h0: (B, R) or None. Returns (h, h_last)."""
    B, S, R = log_a.shape
    if b.shape != log_a.shape or (h0 is not None and h0.shape != (B, R)):
        raise ValueError(f"log_a {tuple(log_a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {None if h0 is None else tuple(h0.shape)} do "
                         "not match")
    if S == 0 or R == 0:
        raise ValueError(f"empty recurrence: S={S}, R={R}")
    chunk, r_block = resolve_blocks(log_a, chunk, r_block)
    chunk, r_block = min(chunk, S), min(r_block, R)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if log_a.device.type == "cuda":
        return _launch(log_a, b, h0, chunk, r_block)
    if log_a.device.type == "cpu" and b.device == log_a.device and (
            h0 is None or h0.device == log_a.device):
        return rglru_reference(log_a, b, h0)
    if log_a.device.type == "meta" and b.device == log_a.device and (
            h0 is None or h0.device == log_a.device):
        return _meta(log_a, b, h0, r_block)
    raise ValueError(f"log_a on {log_a.device}, b on {b.device}, h0 on "
                     f"{None if h0 is None else h0.device}")
