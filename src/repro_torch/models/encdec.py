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
from repro_torch import spmd
from repro_torch.models import layers
from repro_torch.models.transformer import (DEFAULT_SYS, SystemConfig, _cast,
                                            _heads_pinned, _layer, _remat,
                                            _stack_init, _unstack, lm_loss)


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


def _mha(p, xq, xkv, *, causal, chunked=False, q_chunk=1024,
         kv_chunk=1024, shard=False):
    # grouped layout with K = n_heads, G = 1 -> q (B, S, H, 1, D); the
    # heads pinned on the weights (and on q, k, v, as the reference's
    # ``shard=sys.shard_attn`` pins them)
    p = _heads_pinned(p, shard)
    q = layers.shard_heads(layers._proj(xq, p["wq"]), shard)
    k = layers.shard_heads(layers._proj(xkv, p["wk"]), shard)
    v = layers.shard_heads(layers._proj(xkv, p["wv"]), shard)
    q = q.unsqueeze(3)
    if chunked:
        out = layers.chunked_attention(q, k, v, causal=causal,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:
        out = layers.attention(q, k, v, causal=causal)
    return spmd.contract(out.squeeze(3), p["wo"], 2)


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
    x = _add_rows(frames, sinusoid(S, cfg.d_model,
                                   frames.device).to(frames.dtype))

    def body(lp, x):
        x = layers.shard_batch(x, sys.batch_axes)
        h = layers.layernorm(lp["self_norm"], x)
        x = x + _mha(lp["self"], h, h, causal=False, chunked=S > 2048,
                     shard=sys.shard_attn)
        h = layers.layernorm(lp["mlp_norm"], x)
        return x + layers.apply_mlp(lp["mlp"], h)
    body = _remat(body, sys)
    for lp in _unstack(params["enc_layers"], cfg.n_layers):
        x = body(lp, x)
    return layers.layernorm(params["enc_norm"], x)


def _add_rows(x, pe):
    """x (B, S, d) + pe (S, d), the same for every row (on DTensors each
    rank adds it to its own rows)."""
    if spmd.is_dtensor(x):
        out = spmd.rowwise(lambda a, b: a + b, x, pe)
        if out is not None:
            return out
    return x + pe


def _self_kv(lp, h, shard=False):
    """The decoder self-attention's k, v of ``h`` for the cache, bf16."""
    p = _heads_pinned(lp["self"], shard)
    return (layers._proj(h, p["wk"]).to(torch.bfloat16),
            layers._proj(h, p["wv"]).to(torch.bfloat16))


def decode_train(params, tokens, enc_out, cfg: EncDecConfig,
                 sys: SystemConfig = DEFAULT_SYS, collect_cache=False,
                 last_only=False):
    """The decoder over whole token rows: logits (B, S, V) fp32, and with
    ``collect_cache`` also the self-attention k and v (L, B, S, H, D)
    bf16."""
    S = tokens.shape[1]
    x = spmd.embed(params["embed"], tokens)
    x = _add_rows(x, sinusoid(S, cfg.d_model, x.device).to(x.dtype))

    def body(lp, x):
        x = layers.shard_batch(x, sys.batch_axes)
        h = layers.layernorm(lp["self_norm"], x)
        kv = _self_kv(lp, h, sys.shard_attn) if collect_cache else None
        x = x + _mha(lp["self"], h, h, causal=True, chunked=S > 2048,
                     q_chunk=sys.q_chunk, kv_chunk=sys.kv_chunk,
                     shard=sys.shard_attn)
        h = layers.layernorm(lp["cross_norm"], x)
        x = x + _mha(lp["cross"], h, enc_out, causal=False,
                     chunked=S > 2048, shard=sys.shard_attn)
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
    # the tied head, accumulated in fp32 (on DTensors the vocab stays split)
    logits = spmd.contract(x.float(), params["embed"].float().T, 1)
    if collect_cache:
        return (logits, spmd.stack([k for k, _ in kvs]),
                spmd.stack([v for _, v in kvs]))
    return logits


def forward(params, batch, cfg: EncDecConfig, sys: SystemConfig = DEFAULT_SYS):
    """batch: {"frames": (B, S_enc, d), "tokens": (B, S) int} -> (logits
    (B, S, V) fp32, aux loss 0)."""
    with spmd.replication(params, batch):
        dtype = sys.compute_dtype
        cparams = _cast(params, dtype)
        enc_out = encode(cparams, batch["frames"].to(dtype), cfg, sys)
        logits = decode_train(cparams, batch["tokens"], enc_out, cfg, sys)
        return logits, torch.zeros((), device=logits.device)


def loss_fn(params, batch, cfg: EncDecConfig, sys: SystemConfig = DEFAULT_SYS):
    """``transformer.loss_fn`` on the encoder-decoder's logits; batch also
    carries "labels" (B, S), < 0 = ignored."""
    logits, aux = forward(params, batch, cfg, sys)
    with spmd.replication(logits):
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
                      dtype=torch.bfloat16, shard=False):
    """Every decoder layer's cross-attention k and v of ``enc_out``:
    (L, B, S_enc, H, D) each, in ``dtype`` (head-split on DTensors with
    ``shard``, as the prefill's attention computed them)."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = layers.layernorm(lp["cross_norm"], enc_out)
        p = _heads_pinned(lp["cross"], shard)
        ks.append(layers._proj(h, p["wk"]).to(dtype))
        vs.append(layers._proj(h, p["wv"]).to(dtype))
    return spmd.stack(ks), spmd.stack(vs)


def _cached_attention(q, k, v, scale, valid=None):
    """One query row against cached k, v: q (B, 1, H, D), k/v (B, T, H, D)
    -> (B, 1, H, D) in q's dtype; probabilities rounded to v's dtype. On
    DTensors each rank takes its own rows and heads of the cache's split
    (a split head_dim sums partial scores first:
    ``layers.decode_attention_sharded``)."""
    def scores(q, k):
        return torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale

    def mix(s, v):
        if valid is not None:
            s = s.masked_fill(~valid, layers.NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthk->bshk", p.float(),
                            v.float()).to(q.dtype)
    if spmd.is_dtensor(q, k):
        B, _, H, _ = q.shape
        return layers.decode_attention_sharded(scores, mix, q, k, v,
                                               (B, H, 1, k.shape[1]))
    return mix(scores(q, k), v)


def decode_step(params, cache, tokens, pos: int, cfg: EncDecConfig,
                sys: SystemConfig = DEFAULT_SYS):
    """tokens: (B, 1). The cache holds the decoder's self KV ring and the
    encoder's cross KV; the new k/v row is written into it in place.
    Returns (logits (B, 1, V) fp32, cache)."""
    with spmd.replication(params, cache):
        return _decode_step(params, cache, tokens, int(pos), cfg, sys)


def _decode_step(params, cache, tokens, pos: int, cfg: EncDecConfig, sys):
    # the leaves decode reads: no encoder weight, and of the cross
    # attention only wq and wo (its k and v are in the cache)
    layers_ = dict(params["dec_layers"])
    layers_["cross"] = {k: layers_["cross"][k] for k in ("wq", "wo")}
    cparams = _cast({"embed": params["embed"], "dec_layers": layers_},
                    sys.compute_dtype)
    x = spmd.embed(cparams["embed"], tokens)
    W = cache["self_k"].shape[2]
    pe = sinusoid(W, cfg.d_model, x.device)
    x = _add_rows(x, pe[pos % W][None].to(x.dtype))
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
        spmd.write_row(sk, slot,
                       layers._proj(h, lp["self"]["wk"])[:, 0].to(sk.dtype))
        spmd.write_row(sv, slot,
                       layers._proj(h, lp["self"]["wv"])[:, 0].to(sv.dtype))
        o = _cached_attention(q, sk, sv, scale, valid)
        x = x + spmd.contract(o, lp["self"]["wo"], 2)
        # cross attention against the precomputed encoder k, v
        h = layers.layernorm(lp["cross_norm"], x)
        q = layers._proj(h, lp["cross"]["wq"])
        o = _cached_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                              scale)
        x = x + spmd.contract(o, lp["cross"]["wo"], 2)
        h = layers.layernorm(lp["mlp_norm"], x)
        x = x + layers.apply_mlp(lp["mlp"], h)
    # the uncast final norm, as in the reference
    x = layers.layernorm(params["dec_norm"], x)
    return spmd.contract(x.float(), cparams["embed"].float().T, 1), cache
