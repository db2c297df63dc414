"""Flash-attention backward (B2 dq, B3 dk/dv): the Hopper kernels' wrappers
and their plain version.

``flash_attention_bwd`` has the signature and layouts of
``repro.kernels.flash_attention_bwd.flash_attention_bwd`` minus the TPU-only
``q_block``, ``kv_block`` and ``interpret``: the kernels' tiles are their own.
As in the reference, ``delta = rowsum(dO * O)`` is computed in fp32 outside
the kernels, by a torch op.

* On CUDA tensors it launches ``csrc/flash_attention_bwd.cu`` (built by
  ``repro_torch.kernels.build``) on the current stream: ``dq_kernel`` (B2)
  and ``dkv_kernel`` (B3), or raises. There is no fallback.
* On CPU tensors it runs ``flash_attention_bwd_reference``, the plain
  PyTorch version: chunked, fp32 inside, recomputing
  ``p = exp(s * scale - lse)`` from the saved LSE with the reference
  kernels' masks and ``NEG_INF``.

``launches_dq`` and ``launches_dkv`` count kernel launches (never
plain-version calls), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.models.layers import NEG_INF

launches_dq = 0
launches_dkv = 0

_NAMES = {torch.bfloat16: ("fa_bwd_dq_bf16", "fa_bwd_dkv_bf16"),
          torch.float32: ("fa_bwd_dq_f32", "fa_bwd_dkv_f32")}
_fns = {}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def attention_delta(out, do):
    """delta = rowsum(dO * O) in fp32: (B, S, K, G)."""
    return (do.float() * out.float()).sum(-1)


def _spans(n, chunk):
    return [(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _block_visible(qs, qe, ks, ke, causal, window):
    """Some pair of query rows [qs, qe) and keys [ks, ke) is visible."""
    if causal and ks > qe - 1:
        return False
    return window is None or ke - 1 > qs - window


def _probs(qc, kc, lse_c, qs, ks, causal, window, scale):
    """p (B, K, G, sq, sk) = exp(s * scale - lse) with masked s = NEG_INF."""
    dev = qc.device
    s = torch.einsum("bskgd,btkd->bkgst", qc, kc) * scale
    q_pos = qs + torch.arange(qc.shape[1], device=dev)
    k_pos = ks + torch.arange(kc.shape[1], device=dev)
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=dev)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    s = s.masked_fill(~ok, NEG_INF)
    return torch.exp(s - lse_c.permute(0, 2, 3, 1)[..., None])


def _chunk(x, lo, hi):
    return x[:, lo:hi].float()


def dq_reference(q, k, v, do, lse, delta, *, causal=True, window=None,
                 scale, q_chunk=1024, kv_chunk=1024):
    """Plain version of B2: dq (B, S, K, G, D) in q's dtype."""
    S, T = q.shape[1], k.shape[1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for qs, qe in _spans(S, q_chunk):
        qc, doc = _chunk(q, qs, qe), _chunk(do, qs, qe)
        lse_c, dl_c = lse[:, qs:qe], delta[:, qs:qe].permute(0, 2, 3, 1)
        for ks, ke in _spans(T, kv_chunk):
            if not _block_visible(qs, qe, ks, ke, causal, window):
                continue
            kc, vc = _chunk(k, ks, ke), _chunk(v, ks, ke)
            p = _probs(qc, kc, lse_c, qs, ks, causal, window, scale)
            dp = torch.einsum("bskgd,btkd->bkgst", doc, vc)
            ds = p * (dp - dl_c[..., None]) * scale
            dq[:, qs:qe] += torch.einsum("bkgst,btkd->bskgd", ds, kc)
    return dq.to(q.dtype)


def dkv_reference(q, k, v, do, lse, delta, *, causal=True, window=None,
                  scale, q_chunk=1024, kv_chunk=1024):
    """Plain version of B3: (dk, dv) (B, T, K, D) in k's dtype, summed over
    the G query heads of each kv head."""
    S, T = q.shape[1], k.shape[1]
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for ks, ke in _spans(T, kv_chunk):
        kc, vc = _chunk(k, ks, ke), _chunk(v, ks, ke)
        for qs, qe in _spans(S, q_chunk):
            if not _block_visible(qs, qe, ks, ke, causal, window):
                continue
            qc, doc = _chunk(q, qs, qe), _chunk(do, qs, qe)
            lse_c = lse[:, qs:qe]
            dl_c = delta[:, qs:qe].permute(0, 2, 3, 1)
            p = _probs(qc, kc, lse_c, qs, ks, causal, window, scale)
            dv[:, ks:ke] += torch.einsum("bkgst,bskgd->btkd", p, doc)
            dp = torch.einsum("bskgd,btkd->bkgst", doc, vc)
            ds = p * (dp - dl_c[..., None]) * scale
            dk[:, ks:ke] += torch.einsum("bkgst,bskgd->btkd", ds, qc)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal=True,
                                  window=None, softmax_scale=None,
                                  q_chunk=1024, kv_chunk=1024):
    """Plain version of the whole backward: (dq, dk, dv)."""
    scale = _scale(q, softmax_scale)
    delta = attention_delta(out, do)
    kw = dict(causal=causal, window=window, scale=scale, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    dq = dq_reference(q, k, v, do, lse, delta, **kw)
    dk, dv = dkv_reference(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _kernels(dtype):
    if dtype not in _fns:
        from repro_torch.kernels import build
        lib = build.load("flash_attention_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for names in _NAMES.values():
            for name in names:
                fn = getattr(lib, name)
                fn.argtypes = [ptr] * 8 + [i32] * 6 + [ctypes.c_float, i32,
                                                       i32, ptr]
                fn.restype = i32
        lib.fa_bwd_error_string.argtypes = [i32]
        lib.fa_bwd_error_string.restype = ctypes.c_char_p
        _fns.update({dt: (getattr(lib, dq), getattr(lib, dkv),
                          lib.fa_bwd_error_string)
                     for dt, (dq, dkv) in _NAMES.items()})
    return _fns[dtype]


def _check(q, k, v, do, lse, delta):
    """Raise unless the kernels take these tensors (all on one CUDA device)."""
    B, S, K, G, D = q.shape
    dev = q.device
    tensors = (q, k, v, do, lse, delta)
    if any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_bwd needs every tensor on "
                         f"{dev}, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _NAMES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(f"flash_attention_bwd takes bf16 or fp32 q/k/v/do of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{do.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be fp32")
    if tuple(do.shape) != tuple(q.shape) or \
            tuple(lse.shape) != (B, S, K, G) or \
            tuple(delta.shape) != (B, S, K, G):
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_bwd needs contiguous tensors")
    if D > 256 or (q.dtype == torch.bfloat16 and D % 8):
        raise ValueError(f"head_dim {D}: the kernels take D <= 256 "
                         "(a multiple of 8 in bf16)")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_bwd needs 16-byte aligned tensors")
    if S == 0 or k.shape[1] == 0:
        raise ValueError(f"empty sequence: S={S}, T={k.shape[1]}")


def _call(fn, err_str, q, k, v, do, lse, delta, out0, out1, causal, window,
          scale):
    B, S, K, G, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
            0 if out1 is None else out1.data_ptr(), B, S, k.shape[1], K, G,
            D, scale, int(causal), int(window or 0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"{err_str(rc).decode()} ({rc})")


def dq_kernel(q, k, v, do, lse, delta, *, causal=True, window=None, scale):
    """B2 on CUDA tensors: dq in q's dtype."""
    global launches_dq
    _check(q, k, v, do, lse, delta)
    fn, _, err_str = _kernels(q.dtype)
    dq = torch.empty_like(q)
    _call(fn, err_str, q, k, v, do, lse, delta, dq, None, causal, window,
          scale)
    launches_dq += 1
    return dq


def dkv_kernel(q, k, v, do, lse, delta, *, causal=True, window=None, scale):
    """B3 on CUDA tensors: (dk, dv) in k's dtype."""
    global launches_dkv
    _check(q, k, v, do, lse, delta)
    _, fn, err_str = _kernels(q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(fn, err_str, q, k, v, do, lse, delta, dk, dv, causal, window, scale)
    launches_dkv += 1
    return dk, dv


def _scale(q, softmax_scale):
    if softmax_scale is not None:
        return softmax_scale
    return 1.0 / math.sqrt(q.shape[-1])


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True,
                        window: Optional[int] = None, softmax_scale=None):
    """q, out, do: (B, S, K, G, D); k, v: (B, T, K, D); lse: (B, S, K, G)
    fp32 from the forward. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, K, G, D = q.shape
    if k.shape != (B, k.shape[1], K, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    do = do.contiguous()        # autograd may hand in a strided gradient
    scale = _scale(q, softmax_scale)
    if q.device.type == "cuda":
        delta = attention_delta(out, do)
        kw = dict(causal=causal, window=window, scale=scale)
        dq = dq_kernel(q, k, v, do, lse, delta, **kw)
        dk, dv = dkv_kernel(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv
    if q.device.type == "cpu" and all(
            t.device == q.device for t in (k, v, out, lse, do)):
        return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             causal=causal, window=window,
                                             softmax_scale=scale)
    raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
