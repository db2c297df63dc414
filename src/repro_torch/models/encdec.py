"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

PyTorch counterpart of ``repro.models.encdec``, with its names. As there,
the conv frontend is stubbed: the encoder takes precomputed frame
embeddings (B, S_enc, d). Whisper's absolute (sinusoidal) positions (no
RoPE), LayerNorm and GELU MLPs; the head is tied to the embedding table.
Attention uses the grouped layout with K = n_heads and G = 1 through
``layers.attention``, or ``layers.chunked_attention`` past 2048 positions,
as the reference's does: no TPU kernel is on this path.

Decode carries a decoder self-attention KV ring plus the encoder's cross
K/V (``build_cross_cache``). As in the reference, ``decode_step`` takes the
ring's length W from the cache, writes position ``pos`` at slot
``pos % W`` and adds the sinusoid of ``pos % W``. A cache from
``launch.steps.make_prefill_step`` is prompt-long (the reference's prefill
ignores ``max_len``), so decoding past the prompt overwrites its oldest
positions and wraps the position embedding (ROADMAP.md §C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import device as device_lib
from repro_torch.models import layers
from repro_torch.models.transformer import (DEFAULT_SYS, SystemConfig, _cast,
                                            _layer, _remat, _stack_init,
                                            _unstack, lm_loss)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int                # per stack (encoder and decoder)
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_enc_frames: int = 1500
    family: str = "audio"
    dtype: Any = torch.float32

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self):
        return -(-self.vocab // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        return False

    @property
    def takes_embeddings(self) -> bool:
        return True              # the encoder consumes frame embeddings


def sinusoid(length, dim, device=None):
    """(length, dim) fp32: sin on the even columns, cos on the odd."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim)
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _init_mha(gen, d, H, D, dtype):
    return {"wq": layers.dense_init(gen, (d, H, D), dtype=dtype),
            "wk": layers.dense_init(gen, (d, H, D), dtype=dtype),
            "wv": layers.dense_init(gen, (d, H, D), dtype=dtype),
            "wo": layers.dense_init(gen, (H, D, d), in_axis_size=H * D,
                                    dtype=dtype)}


def _heads_out(o, wo):
    """(B, S, H, D) @ wo (H, D, d) -> (B, S, d)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _mha(p, xq, xkv, *, causal, chunked=False, q_chunk=1024,
         kv_chunk=1024):
    # grouped layout with K = n_heads, G = 1 -> q (B, S, H, 1, D)
    q = layers._proj(xq, p["wq"])[:, :, :, None, :]
    k = layers._proj(xkv, p["wk"])
    v = layers._proj(xkv, p["wv"])
    if chunked:
        out = layers.chunked_attention(q, k, v, causal=causal,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:
        out = layers.attention(q, k, v, causal=causal)
    return _heads_out(out[:, :, :, 0, :], p["wo"])


def _init_block(gen, cfg: EncDecConfig, cross: bool, dtype):
    d, H, D, dev = cfg.d_model, cfg.n_heads, cfg.head_dim, gen.device
    p = {"self_norm": layers.init_layernorm(d, dtype, dev),
         "self": _init_mha(gen, d, H, D, dtype),
         "mlp_norm": layers.init_layernorm(d, dtype, dev),
         "mlp": layers.init_mlp(gen, d, cfg.d_ff, dtype=dtype)}
    if cross:
        p["cross_norm"] = layers.init_layernorm(d, dtype, dev)
        p["cross"] = _init_mha(gen, d, H, D, dtype)
    return p


def init(gen: torch.Generator, cfg: EncDecConfig, device=None):
    """Parameters of ``cfg`` on ``device``, drawn from ``gen`` (which must
    live there), with the reference's distributions."""
    dev = device_lib.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    n, d = cfg.n_layers, cfg.d_model
    return {
        "embed": layers.embed_init(gen, (cfg.padded_vocab, d), cfg.dtype),
        "enc_layers": _stack_init(
            lambda: _init_block(gen, cfg, False, cfg.dtype), n),
        "dec_layers": _stack_init(
            lambda: _init_block(gen, cfg, True, cfg.dtype), n),
        "enc_norm": layers.init_layernorm(d, cfg.dtype, dev),
        "dec_norm": layers.init_layernorm(d, cfg.dtype, dev),
    }


def encode(params, frames, cfg: EncDecConfig, sys: SystemConfig = DEFAULT_SYS):
    """frames: (B, S_enc, d) precomputed embeddings (the conv stub's
    output)."""
    S = frames.shape[1]
    x = frames + sinusoid(S, cfg.d_model, frames.device).to(frames.dtype)

    def body(lp, x):
        h = layers.layernorm(lp["self_norm"], x)
        x = x + _mha(lp["self"], h, h, causal=False, chunked=S > 2048)
        h = layers.layernorm(lp["mlp_norm"], x)
        return x + layers.apply_mlp(lp["mlp"], h)
    body = _remat(body, sys)
    for lp in _unstack(params["enc_layers"], cfg.n_layers):
        x = body(lp, x)
    return layers.layernorm(params["enc_norm"], x)


def _self_kv(lp, h):
    """The decoder self-attention's k, v of ``h`` for the cache, bf16."""
    return (layers._proj(h, lp["self"]["wk"]).to(torch.bfloat16),
            layers._proj(h, lp["self"]["wv"]).to(torch.bfloat16))


def decode_train(params, tokens, enc_out, cfg: EncDecConfig,
                 sys: SystemConfig = DEFAULT_SYS, collect_cache=False,
                 last_only=False):
    """The decoder over whole token rows: logits (B, S, V) fp32, and with
    ``collect_cache`` also the self-attention k and v (L, B, S, H, D)
    bf16."""
    S = tokens.shape[1]
    x = params["embed"][tokens]
    x = x + sinusoid(S, cfg.d_model, x.device).to(x.dtype)

    def body(lp, x):
        h = layers.layernorm(lp["self_norm"], x)
        kv = _self_kv(lp, h) if collect_cache else None
        x = x + _mha(lp["self"], h, h, causal=True, chunked=S > 2048,
                     q_chunk=sys.q_chunk, kv_chunk=sys.kv_chunk)
        h = layers.layernorm(lp["cross_norm"], x)
        x = x + _mha(lp["cross"], h, enc_out, causal=False,
                     chunked=S > 2048)
        h = layers.layernorm(lp["mlp_norm"], x)
        return x + layers.apply_mlp(lp["mlp"], h), kv
    body = _remat(body, sys)
    kvs = []
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x, kv = body(lp, x)
        kvs.append(kv)
    if last_only:
        x = x[:, -1:]
    x = layers.layernorm(params["dec_norm"], x)
    logits = x.float() @ params["embed"].float().T
    if collect_cache:
        return (logits, torch.stack([k for k, _ in kvs]),
                torch.stack([v for _, v in kvs]))
    return logits


def forward(params, batch, cfg: EncDecConfig, sys: SystemConfig = DEFAULT_SYS):
    """batch: {"frames": (B, S_enc, d), "tokens": (B, S) int} -> (logits
    (B, S, V) fp32, aux loss 0)."""
    dtype = sys.compute_dtype
    cparams = _cast(params, dtype)
    enc_out = encode(cparams, batch["frames"].to(dtype), cfg, sys)
    logits = decode_train(cparams, batch["tokens"], enc_out, cfg, sys)
    return logits, torch.zeros((), device=logits.device)


def loss_fn(params, batch, cfg: EncDecConfig, sys: SystemConfig = DEFAULT_SYS):
    """``transformer.loss_fn`` on the encoder-decoder's logits; batch also
    carries "labels" (B, S), < 0 = ignored."""
    logits, aux = forward(params, batch, cfg, sys)
    return lm_loss(logits, aux, batch["labels"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: EncDecConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """{"self_k", "self_v"}: (L, B, max_len, H, D) and {"cross_k",
    "cross_v"}: (L, B, n_enc_frames, H, D) zeros in ``dtype``."""
    dev = device_lib.resolve(device)
    H, D, L = cfg.n_heads, cfg.head_dim, cfg.n_layers

    def zeros(T):
        return torch.zeros((L, batch, T, H, D), dtype=dtype, device=dev)
    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.n_enc_frames),
            "cross_v": zeros(cfg.n_enc_frames)}


def build_cross_cache(params, enc_out, cfg: EncDecConfig,
                      dtype=torch.bfloat16):
    """Every decoder layer's cross-attention k and v of ``enc_out``:
    (L, B, S_enc, H, D) each, in ``dtype``."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = layers.layernorm(lp["cross_norm"], enc_out)
        ks.append(layers._proj(h, lp["cross"]["wk"]).to(dtype))
        vs.append(layers._proj(h, lp["cross"]["wv"]).to(dtype))
    return torch.stack(ks), torch.stack(vs)


def _cached_attention(q, k, v, scale, valid=None):
    """One query row against cached k, v: q (B, 1, H, D), k/v (B, T, H, D)
    -> (B, 1, H, D) in q's dtype; probabilities rounded to v's dtype."""
    s = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    if valid is not None:
        s = s.masked_fill(~valid, layers.NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthk->bshk", p.float(),
                        v.float()).to(q.dtype)


def decode_step(params, cache, tokens, pos: int, cfg: EncDecConfig,
                sys: SystemConfig = DEFAULT_SYS):
    """tokens: (B, 1). The cache holds the decoder's self KV ring and the
    encoder's cross KV; the new k/v row is written into it in place.
    Returns (logits (B, 1, V) fp32, cache)."""
    pos = int(pos)
    cparams = _cast(params, sys.compute_dtype)
    x = cparams["embed"][tokens]
    W = cache["self_k"].shape[2]
    pe = sinusoid(W, cfg.d_model, x.device)
    x = x + pe[pos % W][None, None].to(x.dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    slot = pos % W
    idx = torch.arange(W, device=x.device)
    slot_pos = torch.where(idx <= slot, pos - slot + idx,
                           pos - slot - W + idx)
    valid = slot_pos >= 0
    for i in range(cfg.n_layers):
        lp = _layer(cparams["dec_layers"], i)
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        h = layers.layernorm(lp["self_norm"], x)
        q = layers._proj(h, lp["self"]["wq"])
        sk[:, slot] = layers._proj(h, lp["self"]["wk"])[:, 0].to(sk.dtype)
        sv[:, slot] = layers._proj(h, lp["self"]["wv"])[:, 0].to(sv.dtype)
        o = _cached_attention(q, sk, sv, scale, valid)
        x = x + _heads_out(o, lp["self"]["wo"])
        # cross attention against the precomputed encoder k, v
        h = layers.layernorm(lp["cross_norm"], x)
        q = layers._proj(h, lp["cross"]["wq"])
        o = _cached_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                              scale)
        x = x + _heads_out(o, lp["cross"]["wo"])
        h = layers.layernorm(lp["mlp_norm"], x)
        x = x + layers.apply_mlp(lp["mlp"], h)
    # the uncast final norm, as in the reference
    x = layers.layernorm(params["dec_norm"], x)
    logits = x.float() @ cparams["embed"].float().T
    return logits, cache
