"""Chunkwise mLSTM forward (B4): the Hopper kernel's wrapper, plain version.

``mlstm_chunkwise`` has the signature and layout of
``repro.kernels.mlstm.mlstm_chunkwise`` minus the TPU-only ``interpret``:
q, k, v (B, S, H, D) in fp32, bf16 or fp16, gates (B, S, H), h in q's
dtype; ``chunk=None`` resolves through the find-db (``kernels.findb``) for
the tensors' device, and ``S % chunk`` must be 0.

* On CUDA tensors it launches ``csrc/mlstm.cu`` (built by
  ``repro_torch.kernels.build``) on the current stream, or raises. There is
  no fallback: a tensor on the card reaches the kernel or an exception.
  One call is one launch of B4: a scores kernel (each chunk's q k^T, once)
  and the chunk kernel that walks the sequence, its column blocks in
  thread-block clusters (see the source's header).
* On CPU tensors it runs ``mlstm_chunkwise_reference``, the plain PyTorch
  version: the port of ``repro.models.xlstm.mlstm_chunkwise`` in fp32
  einsums, which also takes and returns the carried state.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

launches = 0

_NAMES = {torch.float32: "mlstm_fwd_f32", torch.bfloat16: "mlstm_fwd_bf16",
          torch.float16: "mlstm_fwd_f16"}
_MAX_SMEM = 232448          # bytes of shared memory a block may use (H100)
_fns = {}


def mlstm_chunkwise_reference(q, k, v, i_gate, f_gate, chunk=256,
                              state=None):
    """Plain version: (h (B,S,H,D) in q's dtype, (C (B,H,D,D), n (B,H,D),
    m (B,H)) fp32), as ``repro.models.xlstm.mlstm_chunkwise``.

    state: optional (C, n, m) fp32 carry; C is indexed (value, key).
    """
    B, S, H, D = q.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    N = S // Q
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    def split(x):                                   # (N, B, Q, ...)
        return x.float().reshape(B, N, Q, *x.shape[2:]).transpose(0, 1)

    qs, ks, vs, igs, fgs = (split(x) for x in (q, k, v, i_gate, f_gate))
    if state is None:
        C = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)
    else:
        C, n, m = (x.float() for x in state)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    hs = []
    for qc, kc, vc, ig, fg in zip(qs, ks, vs, igs, fgs):
        Fc = torch.cumsum(F.logsigmoid(fg), dim=1)     # (B,Q,H)
        Ftot = Fc[:, -1]                                # (B,H)
        m_inter = Fc + m[:, None, :]
        logw = Fc[:, :, None, :] - Fc[:, None, :, :] + ig[:, None]
        logw = logw.masked_fill(~causal[None, :, :, None], float("-inf"))
        m_row = torch.maximum(m_inter, logw.amax(dim=2))
        w = torch.exp(logw - m_row[:, :, None, :])
        a = torch.einsum("bshd,bthd->bsth", qc, kc) * scale * w
        num = torch.einsum("bsth,bthd->bshd", a, vc)
        den = a.sum(dim=2)
        w_state = torch.exp(m_inter - m_row)
        num = num + w_state[..., None] * torch.einsum("bshe,bhde->bshd",
                                                      qc, C)
        den = den + w_state * torch.einsum("bshd,bhd->bsh", qc, n)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_row))[..., None])
        m_new = torch.maximum(Ftot + m,
                              (ig + Ftot[:, None] - Fc).amax(dim=1))
        carry_w = torch.exp(Ftot + m - m_new)
        in_w = torch.exp(ig + Ftot[:, None] - Fc - m_new[:, None])
        ksc = kc * scale
        C = carry_w[..., None, None] * C + torch.einsum(
            "bthd,bthe->bhde", in_w[..., None] * vc, ksc)
        n = carry_w[..., None] * n + torch.einsum("bth,bthd->bhd", in_w, ksc)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h.to(q.dtype), (C, n, m)


def _kernel(dtype):
    if dtype not in _fns:
        from repro_torch.kernels import build
        lib = build.load("mlstm")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in _NAMES.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float, ptr]
            fn.restype = i32
        lib.mlstm_smem_bytes.argtypes = [i32, i32]
        lib.mlstm_smem_bytes.restype = ctypes.c_longlong
        lib.mlstm_error_string.argtypes = [i32]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        _fns.update({dt: (getattr(lib, n), lib.mlstm_smem_bytes,
                          lib.mlstm_error_string)
                     for dt, n in _NAMES.items()})
    return _fns[dtype]


def _launch(q, k, v, i_gate, f_gate, Q):
    global launches
    B, S, H, D = q.shape
    dev = q.device
    if any(t.device != dev for t in (k, v, i_gate, f_gate)):
        raise ValueError("mlstm_chunkwise: q, k, v and the gates must be on "
                         "one device")
    if q.dtype not in _NAMES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mlstm_chunkwise takes fp32, bf16 or fp16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mlstm_chunkwise needs contiguous q, k, v")
    if Q > 256:
        raise ValueError(f"chunk {Q}: the kernel takes chunks of at most 256 "
                         "steps")
    if D * q.element_size() % 16:
        raise ValueError(f"head_dim {D} in {q.dtype}: the kernel's TMA "
                         "loads need rows of a multiple of 16 bytes")
    if S * H * D >= 2 ** 31:
        raise ValueError(f"S*H*D = {S * H * D}: the kernel indexes one "
                         "batch row with 32-bit offsets")
    fn, smem_bytes, err_str = _kernel(q.dtype)
    smem = smem_bytes(D, Q)
    if smem > _MAX_SMEM:
        raise ValueError(f"head_dim {D} with chunk {Q} needs {smem} bytes of "
                         f"shared memory a block; the card has {_MAX_SMEM}")
    ig = i_gate.float().contiguous()
    fg = f_gate.float().contiguous()
    h = torch.empty_like(q)
    scores = torch.empty((B * H, S // Q, Q, Q), dtype=torch.float32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
            fg.data_ptr(), h.data_ptr(), scores.data_ptr(), B, S, H, D, Q,
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")
    launches += 1
    return h


def resolve_chunk(q, chunk=None) -> int:
    """``chunk``, or when None the find-db's chunk for q's shape and
    device (``findb.DEFAULTS`` on a miss)."""
    if chunk is None:
        from repro_torch.kernels import findb
        B, S, H, D = q.shape
        chunk = findb.lookup_or_default(
            "mlstm", findb.mlstm_shape_key(B=B, S=S, H=H, D=D),
            hardware=findb.hardware_key(q.device))["chunk"]
    return int(chunk)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, *, chunk=None):
    """q, k, v: (B, S, H, D); gates: (B, S, H). Returns h (B, S, H, D)."""
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            i_gate.shape != (B, S, H) or f_gate.shape != (B, S, H):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, gates {tuple(i_gate.shape)}, "
                         f"{tuple(f_gate.shape)} do not match")
    Q = min(resolve_chunk(q, chunk), S)
    if Q < 1 or S % Q:
        raise ValueError(f"S={S} must be divisible by chunk={Q}")
    if q.device.type == "cuda":
        return _launch(q, k, v, i_gate, f_gate, Q)
    if q.device.type == "cpu" and all(
            t.device == q.device for t in (k, v, i_gate, f_gate)):
        return mlstm_chunkwise_reference(q, k, v, i_gate, f_gate, chunk=Q)[0]
    raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}, "
                     f"gates on {i_gate.device}, {f_gate.device}")
