"""TransformerLM, every LM family: ``forward``, ``loss_fn`` and
``decode_step``.

PyTorch counterpart of ``repro.models.transformer``:

* dense, moe and vlm: attention blocks whose MLP is a SwiGLU or
  ``models.moe``. The vlm takes precomputed patch embeddings (the
  reference's stub frontend) through one linear ``adapter``; its decode
  takes tokens, ``embed[tokens] @ adapter``, as the reference's does.
* hybrid (Griffin): groups of ``rec_per_attn`` recurrent blocks
  (``models.recurrent``) and one sliding-window attention block, then a tail
  of leftover recurrent blocks.
* ssm (xLSTM): groups of ``mlstm_per_slstm`` mLSTM blocks and one sLSTM
  block (``models.xlstm``). As in the reference, its ``forward`` returns no
  cache, so it decodes from ``init_cache``.

Parameters stay stacked on a leading layer
(or group) axis as in the reference, and a loop over the layers takes the
place of its ``lax.scan``. Parameters are fp32 masters; ``forward`` casts
them to the compute dtype, so their gradients arrive in fp32, as in the
reference. A cast that widens the leaves (bf16 weights run at fp32) goes one
layer at a time, so that no fp32 copy of the whole model is held
(``_stacked``). An unknown family raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.tree import tree_leaves, tree_map

PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")


def require_ported(cfg) -> None:
    """Raise ``ValueError`` unless ``cfg``'s family is one of
    ``PORTED_FAMILIES``."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    capacity_factor: float = 1.25
    moe_dropless: bool = True
    # --- hybrid (Griffin) ---
    rec_per_attn: int = 2                 # recurrent layers per attn layer
    d_rnn: Optional[int] = None
    # --- ssm (xlstm) ---
    mlstm_per_slstm: int = 7
    proj_factor: float = 2.0
    # --- misc ---
    tie_embeddings: bool = False
    dtype: Any = torch.float32            # param dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256, as in the reference."""
        return -(-self.vocab // 256) * 256

    def attn_cfg(self, window=None) -> layers.AttnConfig:
        return layers.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
            window=window if window is not None else self.window)

    def moe_cfg(self) -> moe_lib.MoEConfig:
        return moe_lib.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, n_shared=self.n_shared,
            capacity_factor=self.capacity_factor,
            dropless=self.moe_dropless)

    def rec_cfg(self) -> rec_lib.RecurrentConfig:
        return rec_lib.RecurrentConfig(d_model=self.d_model,
                                       d_rnn=self.d_rnn or self.d_model)

    def mlstm_cfg(self) -> xlstm_lib.MLSTMConfig:
        return xlstm_lib.MLSTMConfig(d_model=self.d_model,
                                     n_heads=self.n_heads,
                                     proj_factor=self.proj_factor)

    @property
    def sub_quadratic(self) -> bool:
        """True if serve memory/compute is O(window) or O(1) per token."""
        return self.family in ("hybrid", "ssm") or self.window is not None

    @property
    def takes_embeddings(self) -> bool:
        return self.family == "vlm"

    @property
    def hybrid_groups(self) -> int:
        return self.n_layers // (self.rec_per_attn + 1)

    @property
    def hybrid_tail(self) -> int:
        return self.n_layers - self.hybrid_groups * (self.rec_per_attn + 1)

    @property
    def ssm_groups(self) -> int:
        return self.n_layers // (self.mlstm_per_slstm + 1)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """The paper's 'system parameters', with the reference's fields.

    ``use_pallas`` keeps its name and, unlike the reference, defaults to True:
    it routes prefill attention through ``kernels.ops.flash_attention``,
    whose wrapper launches the hand-written Hopper kernel on CUDA tensors.
    On the card that kernel is the normal runtime path, the counterpart of
    the reference's TPU runtime; on the CPU the wrapper runs its plain
    PyTorch version. ``q_chunk``/``kv_chunk`` size the plain chunked path;
    the kernel's tiles are its own.
    """
    dp: int = 1
    tp: int = 1
    pods: int = 1
    microbatches: int = 1
    remat: str = "none"                 # none | block | dots
    precision: str = "bf16"             # bf16 | fp32
    donate: bool = True
    zero1: bool = True
    compression: str = "none"           # none | int8 | topk
    param_sharding: str = "2d"          # 2d (TP+FSDP) | tp (model axis only)
    shard_attn: bool = False            # constrain q/k/v to head sharding
    batch_axes: tuple = ()              # mesh axes carrying the batch dim
    q_chunk: int = 1024
    kv_chunk: int = 1024
    use_pallas: bool = True             # flash kernel (see docstring)
    kv_quant: bool = False              # int8 KV cache

    @property
    def compute_dtype(self) -> torch.dtype:
        return device_lib.compute_dtype(self.precision)

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.pods


DEFAULT_SYS = SystemConfig()


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _cast(params, dtype):
    """Floating leaves to ``dtype`` (a leaf already in it is not copied)."""
    return tree_map(
        lambda a: a.to(dtype) if a.is_floating_point() else a, params)


# ``dots``: keep the outputs of the matrix products, recompute the rest (the
# counterpart of ``jax.checkpoint_policies.checkpoint_dots``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXT = {
    "block": ckpt.noop_context_fn,
    "dots": functools.partial(ckpt.create_selective_checkpoint_contexts,
                              _dots_policy),
}


def _remat(fn, sys: SystemConfig):
    """The reference's ``_remat``: ``none`` runs ``fn`` as it is, ``block``
    saves only its inputs and recomputes the rest in the backward, ``dots``
    also saves the matrix products' outputs. The flash kernel (B1) is
    recomputed under both, as the Pallas call is under ``jax.checkpoint``.
    Without autograd there is nothing to save and ``fn`` runs as it is."""
    if sys.remat == "none":
        return fn
    if sys.remat not in _REMAT_CONTEXT:
        raise ValueError(f"unknown remat {sys.remat!r} (none | block | dots)")
    context_fn = _REMAT_CONTEXT[sys.remat]

    def remat_fn(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)
    return remat_fn


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------


def _init_attn_block(gen, cfg: ModelConfig, window=None):
    p = {"attn_norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
         "attn": layers.init_attention(gen, cfg.attn_cfg(window), cfg.dtype),
         "mlp_norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype, gen.device)}
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg.moe_cfg(), cfg.dtype)
    else:
        p["mlp"] = layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    return p


def _apply_ffn(p, h, cfg: ModelConfig):
    """The block's MLP or MoE: (y, aux loss fp32)."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], h, cfg.moe_cfg())
    return (layers.apply_swiglu(p["mlp"], h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _apply_attn_block(p, x, cfg: ModelConfig, sys: SystemConfig, window=None,
                      collect_cache=False, max_cache=None):
    acfg = cfg.attn_cfg(window)
    h = layers.rmsnorm(p["attn_norm"], x)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = layers.attention_qkv(p["attn"], h, acfg, positions)
    if sys.use_pallas:
        out = kernel_ops.flash_attention(q, k, v, True, acfg.window)
    elif S > 2048:
        out = layers.chunked_attention(q, k, v, causal=True,
                                       window=acfg.window,
                                       q_chunk=sys.q_chunk,
                                       kv_chunk=sys.kv_chunk)
    else:
        out = layers.attention(q, k, v, causal=True, window=acfg.window)
    x = x + layers.attn_out(out, p["attn"]["wo"])
    h = layers.rmsnorm(p["mlp_norm"], x)
    y, aux = _apply_ffn(p, h, cfg)
    x = x + y
    cache = None
    if collect_cache:
        # Ring invariant: position p lives at slot p % W (decode relies on
        # it). Full attention: pad to max_cache (slots 0..S-1 = positions).
        # SWA: keep the last W positions and roll so slot = p % W.
        cache = {"k": _ring_layout(k, S, acfg.window, max_cache),
                 "v": _ring_layout(v, S, acfg.window, max_cache)}
    return x, aux, cache


def _ring_layout(kv, S, window, max_cache):
    """(B, S, K, D) -> the ring cache (B, W, K, D), bf16 at any precision."""
    kv = kv.to(torch.bfloat16)
    if window is None:
        W = max(max_cache or S, S)
        return F.pad(kv, (0, 0, 0, 0, 0, W - S)) if W > S else kv
    W = window
    if S >= W:
        return torch.roll(kv[:, -W:], S % W, dims=1)
    return F.pad(kv, (0, 0, 0, 0, 0, W - S))


def _apply_attn_block_decode(p, x, cfg: ModelConfig, cache, pos, window=None):
    acfg = cfg.attn_cfg(window)
    h = layers.rmsnorm(p["attn_norm"], x)
    out, cache = layers.apply_attention_decode(p["attn"], h, acfg, cache, pos)
    x = x + out
    h = layers.rmsnorm(p["mlp_norm"], x)
    return x + _apply_ffn(p, h, cfg)[0], cache


def _init_rec_block(gen, cfg: ModelConfig):
    return {"rec_norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype,
                                            gen.device),
            "rec": rec_lib.init_recurrent(gen, cfg.rec_cfg(), cfg.dtype),
            "mlp_norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype,
                                            gen.device),
            "mlp": layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype)}


def _apply_rec_block(p, x, cfg: ModelConfig):
    h = layers.rmsnorm(p["rec_norm"], x)
    x = x + rec_lib.apply_recurrent(p["rec"], h, cfg.rec_cfg())
    h = layers.rmsnorm(p["mlp_norm"], x)
    return x + layers.apply_swiglu(p["mlp"], h)


def _apply_rec_block_decode(p, x, cfg: ModelConfig, state):
    """One token through a recurrent block; ``state``'s tensors ("h",
    "conv") are overwritten with the new state in place, as the attention
    cache is (see ``layers.apply_attention_decode``)."""
    h = layers.rmsnorm(p["rec_norm"], x)
    out, new = rec_lib.apply_recurrent_decode(p["rec"], h, cfg.rec_cfg(),
                                              state)
    _copy_into(state, new)
    x = x + out
    h = layers.rmsnorm(p["mlp_norm"], x)
    return x + layers.apply_swiglu(p["mlp"], h)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Parameters of ``cfg`` on ``device``, drawn from ``gen``.

    ``gen`` must live on ``device`` (a CUDA tensor needs a CUDA generator).
    Distributions follow the reference (truncated-normal fan-in dense
    weights, N(0, 0.02²) embeddings, unit norm scales); the numbers differ,
    since a ``torch.Generator`` is not ``jax.random``.
    """
    dev = device_lib.resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    require_ported(cfg)
    V = cfg.padded_vocab
    params = {"final_norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype, dev)}
    params["embed"] = layers.embed_init(gen, (V, cfg.d_model), cfg.dtype)
    if cfg.takes_embeddings:
        # the vlm's stub frontend: one linear adapter on precomputed patch
        # embeddings (the embedding table stays, for decode's tokens)
        params["adapter"] = layers.dense_init(gen, (cfg.d_model, cfg.d_model),
                                              dtype=cfg.dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, (cfg.d_model, V),
                                              dtype=cfg.dtype)
    if cfg.family == "hybrid":
        # groups of (rec_per_attn recurrent blocks, one attention block),
        # then the tail's recurrent blocks, as the reference stacks them
        def group():
            return {"recs": _stack_init(lambda: _init_rec_block(gen, cfg),
                                        cfg.rec_per_attn),
                    "attn": _init_attn_block(gen, cfg, window=cfg.window)}
        params["layers"] = _stack_init(group, cfg.hybrid_groups)
        if cfg.hybrid_tail:
            params["tail"] = _stack_init(lambda: _init_rec_block(gen, cfg),
                                         cfg.hybrid_tail)
    elif cfg.family == "ssm":
        # groups of (mlstm_per_slstm mLSTM blocks, one sLSTM block), each
        # block with its pre-norm
        mcfg = cfg.mlstm_cfg()

        def block(init_cell):
            return {"norm": layers.init_rmsnorm(cfg.d_model, cfg.dtype, dev),
                    "cell": init_cell(gen, mcfg, cfg.dtype)}

        def group():
            return {"mlstms": _stack_init(
                        lambda: block(xlstm_lib.init_mlstm),
                        cfg.mlstm_per_slstm),
                    "slstm": block(xlstm_lib.init_slstm)}
        params["layers"] = _stack_init(group, cfg.ssm_groups)
    else:
        params["layers"] = _stack_init(lambda: _init_attn_block(gen, cfg),
                                       cfg.n_layers)
    return params


def _stack_init(make, n):
    """``n`` trees from ``make()``, drawn in order, stacked on a new leading
    axis. Each is copied into the stacked leaves as soon as it is drawn, so
    the peak is the stack plus one layer, not twice the stack."""
    layer = make()
    stacked = tree_map(lambda a: a.new_empty((n,) + a.shape), layer)
    for i in range(n):
        if i:
            layer = make()
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
        del layer
    return stacked


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _layer(stacked, i):
    return tree_map(lambda a: a[i], stacked)


def _unstack(stacked, n):
    """Stacked leaves -> ``n`` per-layer trees, one ``unbind`` per leaf.

    Taking ``a[i]`` for each layer would give each layer's backward a zero
    gradient the size of the whole stacked leaf; ``unbind``'s backward
    stacks the per-layer gradients once.
    """
    if isinstance(stacked, dict):
        parts = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return stacked.unbind(0)


def _lm_head(params, cparams, x, cfg: ModelConfig):
    """Final norm (on the uncast scale) and the head, accumulated in fp32."""
    x = layers.rmsnorm(params["final_norm"], x)
    head = cparams["embed"].T if cfg.tie_embeddings else cparams["lm_head"]
    return x.float() @ head.float()


def forward(params, batch, cfg: ModelConfig, sys: SystemConfig = DEFAULT_SYS,
            collect_cache=False, max_cache=None, last_only=False):
    """batch: {"tokens": (B, S) int}, or {"embeddings": (B, S, d)} for
    the vlm.

    Returns (logits, aux_loss) or (logits, aux_loss, cache) with
    collect_cache; an ssm's cache is None, as in the reference. last_only
    projects the LM head on the final position only (prefill).
    """
    require_ported(cfg)
    dtype = sys.compute_dtype
    cparams = _cast(_outside_layers(params), dtype)
    if cfg.takes_embeddings:
        x = batch["embeddings"].to(dtype) @ cparams["adapter"]
    else:
        x = cparams["embed"][batch["tokens"]]

    if cfg.family == "hybrid":
        def body(lp, x):
            lp = _cast(lp, dtype)
            for rp in _unstack(lp["recs"], cfg.rec_per_attn):
                x = _apply_rec_block(rp, x, cfg)
            return _apply_attn_block(lp["attn"], x, cfg, sys,
                                     window=cfg.window,
                                     collect_cache=collect_cache,
                                     max_cache=max_cache)
        n_blocks = cfg.hybrid_groups
    elif cfg.family == "ssm":
        mcfg = cfg.mlstm_cfg()

        def body(lp, x):
            lp = _cast(lp, dtype)
            for mp in _unstack(lp["mlstms"], cfg.mlstm_per_slstm):
                h = layers.rmsnorm(mp["norm"], x)
                x = x + xlstm_lib.apply_mlstm(mp["cell"], h, mcfg)
            h = layers.rmsnorm(lp["slstm"]["norm"], x)
            out, _ = xlstm_lib.apply_slstm(lp["slstm"]["cell"], h, mcfg)
            return x + out, torch.zeros((), device=x.device), None
        n_blocks = cfg.ssm_groups
    else:
        def body(lp, x):
            return _apply_attn_block(_cast(lp, dtype), x, cfg, sys,
                                     collect_cache=collect_cache,
                                     max_cache=max_cache)
        n_blocks = cfg.n_layers
    body = _remat(body, sys)
    caches, auxs = [], []
    for lp in _unstack(_stacked(params["layers"], dtype), n_blocks):
        x, aux, cache = body(lp, x)
        auxs.append(aux)
        caches.append(cache)
    if "tail" in params:
        tail_body = _remat(
            lambda rp, x: _apply_rec_block(_cast(rp, dtype), x, cfg), sys)
        for rp in _unstack(_stacked(params["tail"], dtype), cfg.hybrid_tail):
            x = tail_body(rp, x)
    if last_only:
        x = x[:, -1:]
    logits = _lm_head(params, cparams, x, cfg)
    aux_total = torch.stack(auxs).sum()
    if collect_cache:
        cache = None if cfg.family == "ssm" else _tree_stack(caches)
        return logits, aux_total, cache
    return logits, aux_total


def _outside_layers(params):
    return {k: v for k, v in params.items() if k not in ("layers", "tail")}


def _stacked(stacked, dtype):
    """Stacked layer (or group) leaves, cast to ``dtype`` at once unless
    that widens a leaf: then they stay as they are and each layer is cast as
    it runs (``_cast`` of a leaf already at ``dtype`` copies nothing). At
    once takes one cast per stacked leaf, where per layer takes one per
    layer and leaf: fewer launches in a train step, whose backward keeps the
    casts anyway."""
    widens = any(a.is_floating_point() and a.element_size()
                 < torch.empty((), dtype=dtype).element_size()
                 for a in tree_leaves(stacked))
    return stacked if widens else _cast(stacked, dtype)


def loss_fn(params, batch, cfg: ModelConfig, sys: SystemConfig = DEFAULT_SYS):
    """Mean next-token cross entropy over labels >= 0: (loss, metrics).

    batch: {"tokens": (B, S) int, "labels": (B, S) int, < 0 = ignored}. As
    the reference: fp32 logsumexp, the gold logit by gather, and metrics
    ``loss``, ``aux_loss``, ``tokens`` and ``accuracy``.
    """
    logits, aux = forward(params, batch, cfg, sys)
    return lm_loss(logits, aux, batch["labels"])


def lm_loss(logits, aux, labels):
    """``loss_fn``'s loss and metrics from the logits (B, S, V) fp32, the
    aux loss and the labels (< 0 = ignored)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    n = mask.sum().clamp(min=1.0)
    loss = ((lse - gold) * mask).sum() / n
    with torch.no_grad():
        accuracy = ((logits.argmax(-1) == labels).float() * mask).sum() / n
    metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
               "tokens": mask.sum(),
               "accuracy": accuracy}
    return loss + aux, metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _copies_stacked(one, lead):
    """Each leaf of ``one`` repeated on new leading axes ``lead``."""
    return {k: a.expand(lead + a.shape).clone() for k, a in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, quant: bool = False, device=None):
    """The decode cache, stacked on the layer axis: (L, B, W, K, D) each;
    with ``quant``, int8 "k"/"v" and bf16 "k_scale"/"v_scale" (L, B, W, K).

    hybrid: {"recs": recurrent states (G, rec_per_attn, ...), "attn": the
    attention caches (G, ...), "tail": recurrent states (tail, ...)}; a
    recurrent state is "h" (B, d_rnn) fp32 and "conv" (B, 3, d_rnn) in
    ``dtype``.

    ssm: {"mlstms": mLSTM states (G, mlstm_per_slstm, ...), "slstm": sLSTM
    states (G, ...)}; an mLSTM state is "C", "n", "m" fp32 and "conv"
    (B, 3, d_inner) in ``dtype``, an sLSTM state "c", "n", "h", "m" fp32
    (``models.xlstm``). ``max_len`` and ``quant`` do not apply."""
    require_ported(cfg)
    dev = device_lib.resolve(device)
    if cfg.family == "ssm":
        mcfg, g = cfg.mlstm_cfg(), cfg.ssm_groups
        m = xlstm_lib.init_mlstm_state(mcfg, batch, dtype, dev)
        s = xlstm_lib.init_slstm_state(mcfg, batch, dev)
        return {"mlstms": _copies_stacked(m, (g, cfg.mlstm_per_slstm)),
                "slstm": _copies_stacked(s, (g,))}
    attn = layers.init_kv_cache(cfg.attn_cfg(), batch, max_len, dtype,
                                quant=quant, device=dev)
    if cfg.family != "hybrid":
        return _copies_stacked(attn, (cfg.n_layers,))
    state = rec_lib.init_recurrent_state(cfg.rec_cfg(), batch, dtype, dev)
    g = cfg.hybrid_groups
    cache = {"recs": _copies_stacked(state, (g, cfg.rec_per_attn)),
             "attn": _copies_stacked(attn, (g,))}
    if cfg.hybrid_tail:
        cache["tail"] = _copies_stacked(state, (cfg.hybrid_tail,))
    return cache


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig,
                sys: SystemConfig = DEFAULT_SYS):
    """One new token for every sequence in the batch.

    tokens: (B, 1) int (a vlm's too: ``embed[tokens] @ adapter``, as in the
    reference); pos: current context length. Returns
    (logits (B, 1, V) fp32, cache); the cache is updated in place
    (see ``layers.apply_attention_decode``).
    """
    require_ported(cfg)
    pos = int(pos)
    dtype = sys.compute_dtype
    cparams = _cast(_outside_layers(params), dtype)
    x = cparams["embed"][tokens]
    if cfg.takes_embeddings:
        x = x @ cparams["adapter"]
    stacked = _stacked(params["layers"], dtype)
    if cfg.family == "ssm":
        x = _decode_ssm(stacked, cache, x, cfg, dtype)
        return _lm_head(params, cparams, x, cfg), cache
    if cfg.family != "hybrid":
        for i in range(cfg.n_layers):
            x, _ = _apply_attn_block_decode(_cast(_layer(stacked, i), dtype),
                                            x, cfg, _layer(cache, i), pos)
        return _lm_head(params, cparams, x, cfg), cache
    for g in range(cfg.hybrid_groups):
        lp = _cast(_layer(stacked, g), dtype)
        states = _layer(cache["recs"], g)
        for r in range(cfg.rec_per_attn):
            x = _apply_rec_block_decode(_layer(lp["recs"], r), x, cfg,
                                        _layer(states, r))
        x, _ = _apply_attn_block_decode(lp["attn"], x, cfg,
                                        _layer(cache["attn"], g), pos,
                                        window=cfg.window)
    if "tail" in params:
        tail = _stacked(params["tail"], dtype)
        for i in range(cfg.hybrid_tail):
            x = _apply_rec_block_decode(_cast(_layer(tail, i), dtype), x,
                                        cfg, _layer(cache["tail"], i))
    return _lm_head(params, cparams, x, cfg), cache


def _copy_into(state, new):
    """Overwrite ``state``'s tensors (views into the stacked cache) with
    ``new``'s, in place."""
    for name, t in new.items():
        state[name].copy_(t)


def _decode_ssm(stacked, cache, x, cfg: ModelConfig, dtype):
    """One token through the ssm's groups; the mLSTM and sLSTM states in
    ``cache`` are overwritten in place."""
    mcfg = cfg.mlstm_cfg()
    for g in range(cfg.ssm_groups):
        lp = _cast(_layer(stacked, g), dtype)
        states = _layer(cache["mlstms"], g)
        for j in range(cfg.mlstm_per_slstm):
            mp, state = _layer(lp["mlstms"], j), _layer(states, j)
            h = layers.rmsnorm(mp["norm"], x)
            out, new = xlstm_lib.apply_mlstm_decode(mp["cell"], h, mcfg,
                                                    state)
            _copy_into(state, new)
            x = x + out
        state = _layer(cache["slstm"], g)
        h = layers.rmsnorm(lp["slstm"]["norm"], x)
        out, new = xlstm_lib.apply_slstm(lp["slstm"]["cell"], h, mcfg,
                                         state=state)
        _copy_into(state, new)
        x = x + out
    return x
