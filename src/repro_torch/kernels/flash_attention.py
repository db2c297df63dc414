"""Flash-attention forward (B1): the Hopper kernel's wrapper, plain version.

``flash_attention`` has the signature and layout of
``repro.kernels.flash_attention.flash_attention`` minus the TPU-only
``interpret``. ``q_block`` and ``kv_block`` name one of the kernel's
compiled tile plans (``findb.flash_attention_plans``). ``q_block`` counts
the block's FLATTENED (position, head) rows, because the kernel packs the G
query heads of a kv head into one block: that equals the reference's
positions at G = 1. Left None, they resolve through the find-db
(``findb.lookup_or_default``, kernel ``"flash_attention"``, key
``findb.attention_shape_key`` with the dtype rule, the inputs' device's
hardware key); on a miss they are the kernel's plan of before it took tiles
for the dtype and padded head dim (``findb.flash_attention_defaults``). An
explicit value wins; a pair outside the plan set raises ``ValueError`` on
every device, so a CPU caller finds a plan the card would refuse.

* On CUDA tensors it launches ``csrc/flash_attention.cu`` (built by
  ``repro_torch.kernels.build``) on the current stream, or raises. There is
  no fallback: a tensor on the card reaches the kernel or an exception.
* On CPU tensors it runs ``flash_attention_reference``, the plain PyTorch
  version of the same function, built on the online-softmax recurrence of
  ``layers.chunked_attention``, with the resolved tiles as its
  ``q_chunk``/``kv_chunk`` (so a test can see which find-db row a call
  read; the result does not depend on them).
* On meta tensors (the dry-run, ``launch/dryrun.py``) it validates the
  tiles, returns empty outputs of the kernel's shapes and dtypes and
  reports the kernel's work to ``analysis.cost`` (the same whatever plan
  runs); nothing launches and nothing is computed.

``launches`` counts kernel launches (never plain-version calls), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.models import layers

launches = 0

_DTYPES = {torch.bfloat16: "fa_fwd_bf16", torch.float32: "fa_fwd_f32"}
_MAX_G = {torch.bfloat16: 64, torch.float32: 32}
_fns = {}


def flash_attention_reference(q, k, v, *, causal=True, window=None,
                              softmax_scale=None, q_chunk=1024,
                              kv_chunk=1024):
    """Plain version: (out (B,S,K,G,D) in q's dtype, lse (B,S,K,G) fp32)."""
    return layers.online_softmax_attention(
        q, k, v, causal=causal, window=window, q_chunk=q_chunk,
        kv_chunk=kv_chunk, softmax_scale=softmax_scale)


def _kernel(dtype):
    if dtype not in _fns:
        from repro_torch.kernels import build
        lib = build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in _DTYPES.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 5 + [i32] * 6 + [ctypes.c_float] + \
                [i32] * 4 + [ptr]
            fn.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _fns.update({dt: (getattr(lib, n), lib.fa_error_string)
                     for dt, n in _DTYPES.items()})
    return _fns[dtype]


def resolve_tiles(q, k, *, causal=True, window=None, q_block=None,
                  kv_block=None, find_db=True):
    """(q_block, kv_block) of a call on q (B, S, K, G, D) and k (B, T, K, D).

    Explicit values win. None resolves through the find-db row
    ``"flash_attention"`` for these inputs' shape, dtype and device, or,
    on a miss or with ``find_db`` False, to the kernel's default plan.
    Raises ``ValueError`` for a pair outside the kernel's plans.
    """
    from repro_torch.kernels import findb
    B, S, K, G, D = q.shape
    default = findb.flash_attention_defaults("B1", q.dtype, D)
    if q_block is None or kv_block is None:
        tuned = default
        if find_db:
            tuned = findb.lookup_or_default(
                "flash_attention", findb.attention_shape_key(
                    B=B, S=S, K=K, G=G, D=D, T=k.shape[1], causal=causal,
                    window=window, dtype=q.dtype),
                default=default, hardware=findb.hardware_key(q.device))
        q_block = tuned["q_block"] if q_block is None else q_block
        kv_block = tuned["kv_block"] if kv_block is None else kv_block
    plans = findb.flash_attention_plans(q.dtype, D)
    if (q_block, kv_block) not in plans:
        raise ValueError(
            f"flash_attention has no plan q_block={q_block}, "
            f"kv_block={kv_block} for {q.dtype} at head_dim {D}; its "
            f"(q_block, kv_block) plans there: {list(plans)}")
    return int(q_block), int(kv_block)


def _launch(q, k, v, causal, window, scale, q_block, kv_block):
    global launches
    B, S, K, G, D = q.shape
    T = k.shape[1]
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q on {dev}, k on {k.device}, v on {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if D > 256 or (q.dtype == torch.bfloat16 and D % 8):
        raise ValueError(f"head_dim {D}: the kernel takes D <= 256 "
                         "(a multiple of 8 in bf16)")
    if G > _MAX_G[q.dtype]:
        raise ValueError(f"{G} query heads per kv head; the kernel takes at "
                         f"most {_MAX_G[q.dtype]} in {q.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k, v")
    if S == 0 or T == 0:
        raise ValueError(f"empty sequence: S={S}, T={T}")
    fn, err_str = _kernel(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((B, S, K, G), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, T, K, G, D, scale, int(causal),
            int(window or 0), q_block, kv_block, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")
    launches += 1
    return out, lse


def _meta(q, k, v, causal, window):
    """The kernel's outputs on the meta device, its work reported."""
    from repro_torch.analysis import cost, roofline
    B, S, K, G, D = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D > 256 or G > _MAX_G[q.dtype]:
        raise ValueError(f"head_dim {D}, {G} query heads per kv head: the "
                         f"kernel takes D <= 256, G <= {_MAX_G[q.dtype]}")
    cost.report_kernel("B1", roofline.flash_work(
        "B1", B, S, k.shape[1], K, G, D, q.element_size(), causal, window))
    return (torch.empty_like(q),
            torch.empty((B, S, K, G), dtype=torch.float32, device=q.device))


def flash_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                    q_block: Optional[int] = None,
                    kv_block: Optional[int] = None, softmax_scale=None,
                    return_lse=False):
    """q: (B, S, K, G, D); k, v: (B, T, K, D) -> (B, S, K, G, D).

    return_lse additionally returns the per-row logsumexp (B, S, K, G) fp32.
    ``q_block`` (flattened (position, head) rows a block) and ``kv_block``
    pick the kernel's tile plan; None resolves through the find-db (see
    the module docstring and ``resolve_tiles``).
    """
    B, S, K, G, D = q.shape
    if k.shape != (B, k.shape[1], K, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if B == 0 or K == 0:
        # a rank's empty share of an uneven split of the batch or the kv
        # heads (the sharded step): nothing to compute, nothing launched
        out = torch.empty_like(q)
        lse = torch.empty((B, S, K, G), dtype=torch.float32, device=q.device)
        return (out, lse) if return_lse else out
    q_block, kv_block = resolve_tiles(q, k, causal=causal, window=window,
                                      q_block=q_block, kv_block=kv_block)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cuda":
        out, lse = _launch(q, k, v, causal, window, scale, q_block, kv_block)
    elif q.device.type == "cpu" and k.device == q.device == v.device:
        out, lse = flash_attention_reference(q, k, v, causal=causal,
                                             window=window,
                                             softmax_scale=scale,
                                             q_chunk=q_block,
                                             kv_chunk=kv_block)
    elif q.device.type == "meta" and k.device == q.device == v.device:
        out, lse = _meta(q, k, v, causal, window)
    else:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    return (out, lse) if return_lse else out
