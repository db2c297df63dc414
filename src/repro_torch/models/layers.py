"""Layers of the port's models: RMSNorm and LayerNorm, RoPE, GQA attention,
SwiGLU and the GELU MLP.

PyTorch counterpart of ``repro.models.layers``, with the same names and the
same conventions:

* Params are plain nested dicts of tensors; ``init_*`` builds them from an
  explicit ``torch.Generator`` (tensors land on the generator's device), the
  functional ops consume them.
* Attention uses the grouped layout q ``(B, S, K, G, D)``, k/v ``(B, T, K, D)``
  with K = n_kv_heads, G = n_heads // n_kv_heads, D = head_dim.
* A product the reference takes with ``preferred_element_type=float32`` is
  taken here on float32 copies of its operands: the products of bf16 values
  are exact in float32, so both accumulate the same terms in float32.
* ``chunked_attention`` is the online-softmax (flash) recurrence; the plain
  version of the flash kernel (``repro_torch.kernels.flash_attention``) is
  built on the same recurrence.

* The int8 KV cache (``init_kv_cache(quant=True)``, ``quantize_kv``,
  ``dequantize_kv``) keeps int8 values with one bf16 scale per (token, kv
  head), as the reference does.

* GELU is the tanh approximation, ``jax.nn.gelu``'s default.

* On DTensors (the sharded step, ``distributed.spmd``) ``shard_batch`` and
  ``shard_heads`` pin the batch and the kv heads as the reference's
  sharding constraints do, and every product with a weight goes through
  ``spmd.contract`` (weights gathered over the batch axes, never the
  activations). On plain tensors both pins return ``x`` and the products
  are the plain ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch import spmd

Params = Any

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis_size=None,
               dtype=torch.float32):
    """Truncated-normal (±3σ) fan-in init, σ = 1/sqrt(fan_in)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return t.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm in float32, cast back to the input dtype."""
    if spmd.is_dtensor(x):
        y = spmd.rowwise(lambda a, s: rmsnorm({"scale": s}, a, eps), x,
                         params["scale"])
        if y is not None:
            return y
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def init_layernorm(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """LayerNorm in float32, cast back to the input dtype."""
    if spmd.is_dtensor(x):
        y = spmd.rowwise(lambda a, s, b: layernorm({"scale": s, "bias": b},
                                                   a, eps),
                         x, params["scale"], params["bias"])
        if y is not None:
            return y
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, *H, D); positions (B, S).

    Rotates ADJACENT pairs (2i, 2i+1), as the reference does, not the
    half-split ``rotate_half`` layout common in PyTorch code. On DTensors
    each rank rotates its own shard with its own slice of the frequencies
    (``spmd.rope_pieces``).
    """
    if spmd.is_dtensor(x):
        x, positions, lo = spmd.rope_pieces(x, positions)
        d = x.shape[-1]

        def rotate(a, pos):
            freqs = rope_freqs(d, theta, device=a.device)
            return _rotate(a, pos, freqs[lo:lo + a.shape[-1] // 2])
        return spmd.local_apply(rotate, (x, positions),
                                (x.placements, positions.placements),
                                x.placements, x.shape)
    return _rotate(x, positions, rope_freqs(x.shape[-1], theta,
                                            device=x.device))


def _rotate(x, positions, freqs):
    """``apply_rope`` with the frequencies (D/2,) of x's pairs given."""
    d = x.shape[-1]
    angles = positions.float()[..., None] * freqs           # (B, S, D/2)
    while angles.ndim < x.ndim:                             # over head axes
        angles = angles.unsqueeze(-2)
    cos, sin = angles.cos(), angles.sin()
    xr = x.float().reshape(x.shape[:-1] + (d // 2, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    y = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (reference path; the flash kernel computes the same function)
# ---------------------------------------------------------------------------

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def shard_batch(x, batch_axes):
    """Pin dim 0 (batch) to the data axes; the other mesh dims keep their
    placements, less any split of dim 0.

    The reference's constraint: with FSDP weights (d_in over "data") the
    batch must stay split, or every device computes every row. A plain
    tensor (no mesh in scope) comes back as it is, and so does a batch that
    does not split evenly over the axes (the reference's ``input_specs``
    leaves such a batch replicated).
    """
    if not batch_axes or not spmd.is_dtensor(x):
        return x
    names = x.device_mesh.mesh_dim_names
    axes = [a for a in batch_axes if a in names]
    if not axes or x.shape[0] % spmd.mesh_size(x.device_mesh, axes):
        return x
    return spmd.placed(x, [
        Shard(0) if name in axes else
        (Replicate() if p.is_shard(0) else p)
        for name, p in zip(names, x.placements)])


def shard_heads(x, enabled: bool, axis: int = 2):
    """Pin the kv-head axis to the "model" mesh dim.

    Head-sharded attention keeps softmax and score math local to a device.
    Active only on a DTensor whose mesh has a "model" dim, and with
    ``enabled`` (sys.shard_attn). An uneven split leaves the last ranks
    without heads (``torch.chunk``; GSPMD pads instead).
    """
    if not enabled or not spmd.is_dtensor(x):
        return x
    names = x.device_mesh.mesh_dim_names
    if "model" not in names:
        return x
    out = list(x.placements)
    out[names.index("model")] = Shard(axis)
    return spmd.placed(x, out)


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Additive bias (Sq, Sk) in fp32: 0 where visible, NEG_INF elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def attention(q, k, v, *, causal=True, window=None, q_offset=0,
              kv_mask=None, softmax_scale=None):
    """Direct (materialised-scores) GQA attention.

    q: (B, Sq, K, G, D)  k, v: (B, Sk, K, D)  ->  (B, Sq, K, G, D)
    kv_mask: optional (B, Sk) bool validity mask (plain tensors only).
    On DTensors each rank attends over its own heads (``spmd.local_heads``).
    """
    if spmd.is_dtensor(q, k, v) and kv_mask is None:
        return spmd.local_heads(
            lambda a, b, c: attention(a, b, c, causal=causal, window=window,
                                      q_offset=q_offset,
                                      softmax_scale=softmax_scale), q, k, v)
    B, Sq, K, G, D = q.shape
    Sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())
    return out.to(q.dtype)


def online_softmax_attention(q, k, v, *, causal=True, window=None,
                             q_offset=0, kv_mask=None, q_chunk=1024,
                             kv_chunk=1024, softmax_scale=None):
    """The flash recurrence over (q_chunk, kv_chunk) blocks.

    Returns (out (B, Sq, K, G, D) in q's dtype, lse (B, Sq, K, G) fp32), with
    ``l`` floored at 1e-30 and ``lse = m + log l`` as in the flash kernel.
    """
    B, Sq, K, G, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // kv_chunk)
    pad_q, pad_k = nq * q_chunk - Sq, nk * kv_chunk - Sk

    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    kmask = (torch.ones((B, Sk), dtype=torch.bool, device=dev)
             if kv_mask is None else kv_mask)
    kmask = F.pad(kmask, (0, pad_k))

    outs, lses = [], []
    for qi in range(nq):
        qc = qp[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev) + q_offset
        acc = torch.zeros((B, K, G, q_chunk, D), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kc, vc, mc = kp[:, sl], vp[:, sl], kmask[:, sl]
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bskgd,btkd->bkgst", qc, kc.float()) * scale
            ok = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                ok &= k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                ok &= k_pos[None, :] > (q_pos[:, None] - window)
            s = s.masked_fill(~ok, NEG_INF)
            s = s.masked_fill(~mc[:, None, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))
        lses.append((m + torch.log(l)).permute(0, 3, 1, 2))
    out = torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)
    lse = torch.cat(lses, dim=1)[:, :Sq]
    return out, lse


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_mask=None, q_chunk=1024, kv_chunk=1024,
                      softmax_scale=None):
    """Online-softmax attention; memory O(q_chunk * kv_chunk) per step. On
    DTensors each rank attends over its own heads (``spmd.local_heads``)."""
    if spmd.is_dtensor(q, k, v) and kv_mask is None:
        return spmd.local_heads(
            lambda a, b, c: chunked_attention(
                a, b, c, causal=causal, window=window, q_offset=q_offset,
                q_chunk=q_chunk, kv_chunk=kv_chunk,
                softmax_scale=softmax_scale), q, k, v)
    out, _ = online_softmax_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_mask=kv_mask, q_chunk=q_chunk, kv_chunk=kv_chunk,
        softmax_scale=softmax_scale)
    return out


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None         # sliding-window size; None = full
    causal: bool = True

    @property
    def groups(self):
        return self.n_heads // self.n_kv_heads


def init_attention(gen: torch.Generator, cfg: AttnConfig,
                   dtype=torch.float32) -> Params:
    K, G, D, d = cfg.n_kv_heads, cfg.groups, cfg.head_dim, cfg.d_model
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, K, G, D), in_axis_size=d, dtype=dtype),
        "wk": dense_init(gen, (d, K, D), in_axis_size=d, dtype=dtype),
        "wv": dense_init(gen, (d, K, D), in_axis_size=d, dtype=dtype),
        "wo": dense_init(gen, (K, G, D, d), in_axis_size=K * G * D,
                         dtype=dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((K, G, D), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((K, D), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((K, D), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(D, dtype, dev)
        p["k_norm"] = init_rmsnorm(D, dtype, dev)
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, *out) -> (B, S, *out), contiguous."""
    return spmd.contract(x, w, 1)


def attention_qkv(params, x, cfg: AttnConfig, positions):
    """Project to grouped q, k, v; qk-norm comes before RoPE."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(out, wo):
    """(B, S, K, G, D) @ wo (K, G, D, d) -> (B, S, d)."""
    return spmd.contract(out, wo, 3)


def apply_attention_decode(params, x, cfg: AttnConfig, cache, pos: int):
    """Single-token decode with a (possibly ring-buffered) KV cache.

    x: (B, 1, d); cache: {"k": (B, W, K, D), "v": ...}, plus "k_scale" and
    "v_scale" (B, W, K) for an int8 cache; pos: number of tokens already in
    context. Returns (out, cache). Unlike the reference, which returns a
    fresh cache, the new k/v row (and its scales) is written into ``cache``
    in place: a copy of every layer's cache per token would move the whole
    cache for one row.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per sequence, got {S}")
    W = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = attention_qkv(params, x, cfg, positions)
    slot = pos % W                                        # ring buffer for SWA
    if "k_scale" in cache:
        for name, new in (("k", k), ("v", v)):
            values, scale = quantize_kv(new[:, 0])
            spmd.write_row(cache[name], slot, values)
            spmd.write_row(cache[name + "_scale"], slot, scale)
        ck = dequantize_kv(cache["k"], cache["k_scale"])
        cv = dequantize_kv(cache["v"], cache["v_scale"])
    else:
        spmd.write_row(cache["k"], slot, k[:, 0].to(cache["k"].dtype))
        spmd.write_row(cache["v"], slot, v[:, 0].to(cache["v"].dtype))
        ck, cv = cache["k"], cache["v"]
    # validity + causality via explicit per-slot positions
    idx = torch.arange(W, device=x.device)
    slot_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot - W + idx)
    valid = slot_pos >= 0
    if cfg.window is not None:
        valid &= slot_pos > (pos - cfg.window)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def scores(q, ck):
        return torch.einsum("bskgh,btkh->bkgst", q.float(), ck.float()) * scale

    def mix(s, cv):
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        return torch.einsum("bkgst,btkh->bskgh", p.float(),
                            cv.to(x.dtype).float()).to(x.dtype)

    if spmd.is_dtensor(q, ck):
        B, _, K, G, _ = q.shape
        out = decode_attention_sharded(scores, mix, q, ck, cv,
                                       (B, K, G, 1, ck.shape[1]))
    else:
        out = mix(scores(q, ck), cv)
    return attn_out(out, params["wo"]), cache


def decode_attention_sharded(scores, mix, q, ck, cv, s_shape):
    """``mix(scores(q, ck), cv)`` on each rank's shards, following the
    cache's split (B, W, K, D). q is (B, 1, K, G, D) or (B, 1, K, D), the
    scores ``s_shape`` with the batch first and the kv heads second. The
    batch and the kv heads split q, the scores and the output alike; a
    split head_dim leaves partial scores, summed across ranks before the
    softmax."""
    last = q.ndim - 1
    qp, sp, op, reduce = [], [], [], False
    for p in ck.placements:
        if p.is_shard(0) or p.is_replicate():
            qp.append(p), sp.append(p), op.append(p)
        elif p.is_shard(2):
            qp.append(Shard(2)), sp.append(Shard(1)), op.append(Shard(2))
        elif p.is_shard(3):
            qp.append(Shard(last)), sp.append(Partial())
            op.append(Shard(last))
            reduce = True
        else:
            raise ValueError(f"a decode cache split as {ck.placements}")
    s = spmd.local_apply(scores, (q, ck), (qp, ck.placements), sp, s_shape)
    if reduce:
        s = spmd.placed(s, [Replicate() if p.is_partial() else p
                            for p in sp])
    return spmd.local_apply(mix, (s, cv), (s.placements, ck.placements), op,
                            q.shape)


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, quant: bool = False, device=None):
    """{"k", "v"}: (B, W, K, D) zeros, W the window or ``max_len``. With
    ``quant``: int8 values and bf16 per-(token, head) scales "k_scale",
    "v_scale" (B, W, K). That halves the cache's memory, not decode's
    traffic: ``apply_attention_decode`` dequantizes the whole cache to fp32
    copies every step before it reads them."""
    W = max_len if cfg.window is None else min(cfg.window, max_len)
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x):
    """(..., D) -> (int8 values, per-row bf16 scale): the row's max |x| over
    127 (plus 1e-8), values rounded half to even and clipped to ±127."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-8
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale):
    """int8 values and their bf16 scales -> fp32."""
    return q.float() * scale[..., None].float()


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d_model, d_ff,
                dtype=torch.float32) -> Params:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), in_axis_size=d_ff,
                             dtype=dtype),
    }


def apply_swiglu(params, x):
    g = spmd.contract(x, params["w_gate"], 1)
    u = spmd.contract(x, params["w_up"], 1)
    if spmd.is_dtensor(g):
        h = spmd.local_apply(lambda a, b: F.silu(a) * b, (g, u),
                             (g.placements, g.placements), g.placements,
                             g.shape)
    else:
        h = F.silu(g) * u
    return spmd.contract(h, params["w_down"], 1)


def init_mlp(gen: torch.Generator, d_model, d_ff,
             dtype=torch.float32) -> Params:
    dev = gen.device
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, (d_ff, d_model), in_axis_size=d_ff,
                             dtype=dtype),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def apply_mlp(params, x):
    """GELU (tanh approximation) MLP with biases. On DTensors the products
    go through ``spmd.contract`` (up column-parallel, down row-parallel),
    as ``apply_swiglu``'s do, and each rank adds its own slice of the
    up-projection's bias."""
    if spmd.is_dtensor(x):
        u = spmd.contract(x, params["w_up"], 1)
        bias = spmd.channels(u.placements, u.ndim)
        h = spmd.local_apply(
            lambda a, b: F.gelu(a + b, approximate="tanh"),
            (u, params["b_up"]), (u.placements, bias), u.placements, u.shape)
        y = spmd.contract(h, params["w_down"], 1)
        out = spmd.rowwise(lambda a, b: a + b, y, params["b_down"])
        return y + params["b_down"] if out is None else out
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]
