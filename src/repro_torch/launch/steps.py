"""Step functions: the counterpart of ``repro.launch.steps`` for every
model family: the LM families of ``models.transformer`` and the
encoder-decoder of ``models.encdec`` (``is_encdec``). As in the reference:
a hybrid's prefill returns only its attention caches (stacked over groups)
and an ssm's none, so their decode starts from ``transformer.init_cache``;
a vlm's prompt is ``batch["embeddings"]``; an encoder-decoder's prefill
encodes ``batch["frames"]``, runs the decoder over ``batch["tokens"]`` and
returns its self-attention cache prompt-long, whatever ``max_len`` says,
with the cross cache.

``make_train_state``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` keep the reference's signatures, with an explicit
``torch.Generator`` and device in place of a PRNG key. PyTorch runs
eagerly, so the returned functions need no ``jit``; prefill and decode run
under ``torch.inference_mode()`` (``torch.no_grad()`` on DTensors).

On a mesh (a ``DeviceMesh``) every family's steps run sharded, as the
reference's do: ``make_train_state(..., mesh=)`` places the state by
``sharding.state_specs``, ``distribute_batch`` places a batch as the
reference's ``NamedSharding`` of ``input_specs`` would, and
``make_train_step(..., mesh=)`` splits the batch into microbatches that
keep the reference's membership (microbatch i is global rows
[i·m, (i+1)·m), spread over the batch axes), resolves each gradient to its
parameter's placement and clips by the global norm over all shards. The
prefill and decode steps take DTensor parameters, batches and caches and
need no new argument: the shardings come from the inputs, as in the
reference. The models pin the batch and the kv heads
(``layers.shard_batch``, ``shard_heads``) and run B1-B3 on each rank's own
shards (``kernels.ops``); an MoE layer routes each rank's own rows
(``moe._apply_moe_sharded``); the recurrent blocks follow the rules'
channel splits (``models.recurrent``, ``models.xlstm``: the sLSTM's time
loop gathers its pre-activations over "model" each step, inside one
``spmd.local_apply``). Losses and metrics come back as plain tensors,
equal on every rank. A family with no sharded step would raise
``NotImplementedError`` on a mesh past 1x1 (``require_shardable``, naming
its ROADMAP item in ``MESH_ITEMS``); none is left.

The dry-run's helpers (``default_sys``, ``abstract_state``,
``input_specs``, ``cache_specs_abstract``, ``state_specs_abstract``,
``param_specs_abstract``) build meta tensors with the reference's shapes
and dtypes: nothing is allocated. Where a mesh (a ``DeviceMesh`` or a
``launch.mesh.AbstractMesh``) is given, each leaf's spec comes from
``distributed.sharding``, as the reference's ``NamedSharding``s do.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import spmd, weights
from repro_torch.configs import ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import SystemConfig
from repro_torch.obs import spans
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves


def is_encdec(cfg) -> bool:
    return isinstance(cfg, encdec.EncDecConfig)


def model_loss(params, batch, cfg, sys):
    if is_encdec(cfg):
        return encdec.loss_fn(params, batch, cfg, sys)
    return transformer.loss_fn(params, batch, cfg, sys)


def model_init(gen: torch.Generator, cfg, device=None):
    if is_encdec(cfg):
        return encdec.init(gen, cfg, device)
    return transformer.init(gen, cfg, device)


# families whose steps run sharded on a mesh past 1x1, and the ROADMAP
# item (queue A) of each other family (none is left)
SHARDED_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
MESH_ITEMS: dict = {}


def family(cfg) -> str:
    return "audio" if is_encdec(cfg) else cfg.family


def mesh_of(tree):
    """The ``DeviceMesh`` of the first DTensor in ``tree``, else None."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def require_shardable(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` for a family with no sharded step on a
    mesh past 1x1, naming its ROADMAP item."""
    if mesh is None or mesh.size() == 1:
        return
    fam = family(cfg)
    if fam not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"the {fam} family has no sharded step on a mesh past 1x1 "
            f"(mesh {tuple(mesh.shape)}): ROADMAP.md queue A item "
            f"{MESH_ITEMS.get(fam, '(none named)')}")


def make_train_state(gen: torch.Generator, cfg, opt: optimizers.Optimizer,
                     device=None, mesh=None,
                     sys: Optional[SystemConfig] = None):
    """{"params", "opt", "step"}: parameters from ``model_init``, the
    optimizer's state, and the step as a Python int. On a ``mesh`` every
    rank draws the same state and keeps its own shards of it, placed by
    ``sharding.state_specs`` under ``sys`` (default: ``SystemConfig()``,
    2-D sharding)."""
    require_shardable(cfg, mesh)
    params = model_init(gen, cfg, device)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    if mesh is None:
        return state
    specs = sharding.state_specs(state, cfg, mesh, sys or SystemConfig())
    flat = weights.flatten(state)
    del state, params
    return place_leaves(flat, specs, mesh)


def place(tree, specs, mesh):
    """Each tensor of ``tree`` (the same whole tensor on every rank, or a
    meta tensor) as a DTensor on ``mesh`` placed by its spec; each rank
    keeps its own shard, with no communication. Other leaves stay."""
    return place_leaves(weights.flatten(tree), specs, mesh)


def place_leaves(flat, specs, mesh):
    """``place`` on a flat {path: leaf} dict that it empties as it goes:
    a whole leaf the caller holds nowhere else is freed once its shard is
    made, so placing a tree costs one leaf beside it, not a second copy
    (a full-width state on one card)."""
    named = weights.flatten(sharding.named(specs, mesh))
    out = {}
    for p in list(flat):
        t = flat.pop(p)
        out[p] = named[p].distribute(t) if isinstance(t, torch.Tensor) else t
        del t
    return weights.unflatten(out)


def distribute_batch(batch, mesh):
    """A batch (the same whole tensors on every rank) placed as the
    reference's ``NamedSharding`` of ``input_specs`` places it: rows over
    the batch axes where they split evenly, else replicated; "pos" and
    other non-tensors stay."""
    rows = next(t.shape[0] for t in batch.values()
                if isinstance(t, torch.Tensor))
    axes = [a for a in sharding.BATCH_AXES if a in mesh.mesh_dim_names]
    split = axes and rows % spmd.mesh_size(mesh, axes) == 0
    baxes = (tuple(axes) if len(axes) > 1 else axes[0]) if split else None
    specs = {k: (baxes,) + (None,) * (t.ndim - 1)
             if isinstance(t, torch.Tensor) else () for k, t in batch.items()}
    return place(batch, specs, mesh)


def default_sys(cfg, shape: ShapeSpec, *, dp=16, tp=16, pods=1
                ) -> SystemConfig:
    """Baseline system config for a dry-run cell, as the reference's: one
    sequence a data shard a microbatch in training, remat inside blocks
    (the memory-minimal default), bf16 compute."""
    dp_total = dp * pods
    micro = max(1, shape.global_batch // dp_total) if shape.kind == "train" else 1
    remat = "block" if shape.kind == "train" else "none"
    baxes = ("pod", "data") if pods > 1 else ("data",)
    return SystemConfig(dp=dp, tp=tp, pods=pods, microbatches=micro,
                        remat=remat, precision="bf16", shard_attn=True,
                        batch_axes=baxes)


def make_train_step(cfg, sys: SystemConfig, opt: optimizers.Optimizer,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, {"loss", "accuracy"}).

    Gradients accumulate over ``sys.microbatches`` (the batch split along
    its first axis) as fp32 sums divided by their number, with loss and
    accuracy averaged over them. The update is applied to the parameters in
    place and ``state`` is returned updated: the counterpart of the
    reference's donated state. A leaf the loss does not use (the vlm's
    ``embed``: its forward starts from the adapter) gets a zero gradient,
    as under ``jax.grad``, and the optimizer still updates it.

    With a ``mesh`` the state and batch are DTensors on it
    (``make_train_state(..., mesh=)``, ``distribute_batch``): each
    microbatch keeps the reference's rows, spread over the batch axes, each
    gradient comes back in its parameter's placement (a partial sum
    reduced), and loss and accuracy come back as plain tensors.
    """
    if not is_encdec(cfg):
        transformer.require_ported(cfg)
    require_shardable(cfg, mesh)
    n_micro = sys.microbatches

    def grads_of(params, batch):
        flat = {path: leaf.detach().requires_grad_()
                for path, leaf in weights.flatten(params).items()}
        loss, metrics = model_loss(weights.unflatten(flat), batch, cfg, sys)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = [spmd.placed(g, p.placements) if isinstance(g, DTensor)
                 else g for g, p in zip(grads, flat.values())]
        return loss.detach(), metrics["accuracy"], grads, list(flat)

    def train_step(state, batch):
        with spans.span("step"), spmd.replication(batch):
            state, metrics = _train_step(state, batch)
        return state, {k: _plain(v) for k, v in metrics.items()}

    def _train_step(state, batch):
        params = state["params"]
        if n_micro > 1:
            B = next(iter(batch.values())).shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} does not split into {n_micro} "
                                 "microbatches")
            mbs = {k: _microbatches(x, n_micro) for k, x in batch.items()}
            g_sum, loss_sum, acc_sum = None, 0.0, 0.0
            for i in range(n_micro):
                mb = {k: x[i] for k, x in mbs.items()}
                loss, acc, grads, paths = grads_of(params, mb)
                if g_sum is None:
                    g_sum = grads
                else:
                    with spans.span("grad_accum"):
                        torch._foreach_add_(spmd.locals_of(g_sum),
                                            spmd.locals_of(grads))
                loss_sum, acc_sum = loss_sum + loss, acc_sum + acc
            with spans.span("grad_accum"):
                torch._foreach_mul_(spmd.locals_of(g_sum), 1.0 / n_micro)
            grads = g_sum
            loss, acc = loss_sum / n_micro, acc_sum / n_micro
        else:
            loss, acc, grads, paths = grads_of(params, batch)
        grads = weights.unflatten(dict(zip(paths, grads)))
        updates, state["opt"] = opt.update(grads, state["opt"], params,
                                           state["step"])
        with spans.span("apply"), torch.no_grad():
            torch._foreach_add_(spmd.locals_of(tree_leaves(params)),
                                spmd.locals_of(tree_leaves(updates)))
        state["step"] += 1
        return state, {"loss": loss, "accuracy": acc}

    return train_step


def _microbatches(x, n):
    """(B, ...) -> (n, B / n, ...): microbatch i is rows [i·m, (i+1)·m).
    A DTensor split over the batch axes is gathered, reshaped and split on
    dim 1, so each microbatch is spread over those axes (the reference's
    ``P(None, baxes)`` constraint). Gathered first: DTensor's reshape of a
    dim split over two mesh dims (pod, data) gets the local shape wrong."""
    if not isinstance(x, DTensor):
        return x.reshape((n, x.shape[0] // n) + x.shape[1:])
    whole = spmd.placed(x, [Replicate()] * len(x.placements))
    y = whole.reshape((n, x.shape[0] // n) + x.shape[1:])
    return spmd.placed(y, [Shard(1) if p.is_shard(0) else Replicate()
                           for p in x.placements])


def _plain(x):
    """A metric as a plain tensor (a DTensor gathered whole)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _serving(fn):
    """Runs ``fn`` under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` where its parameters are DTensors: a DTensor view
    (a layer's slice of a cache made outside inference mode) cannot be
    taken in inference mode."""
    @functools.wraps(fn)
    def serve(params, *args):
        mode = (torch.no_grad() if mesh_of(params) is not None
                else torch.inference_mode())
        with mode:
            return fn(params, *args)
    return serve


def make_prefill_step(cfg, sys: SystemConfig, max_len: Optional[int] = None
                      ) -> Callable:
    """prefill(params, batch) -> (last-token logits, decode cache).

    max_len sizes the (full-attention) decode cache; default = prompt length.
    An encoder-decoder ignores it, as the reference does.
    """
    if is_encdec(cfg):
        @_serving
        def prefill(params, batch):
            require_shardable(cfg, mesh_of(params))
            with spmd.replication(params, batch):
                dtype = sys.compute_dtype
                cparams = transformer._cast(params, dtype)
                enc = encdec.encode(cparams, batch["frames"].to(dtype), cfg,
                                    sys)
                logits, sk, sv = encdec.decode_train(
                    cparams, batch["tokens"], enc, cfg, sys,
                    collect_cache=True, last_only=True)
                ck, cv = encdec.build_cross_cache(cparams, enc, cfg,
                                                  shard=sys.shard_attn)
            return logits, {"self_k": sk, "self_v": sv, "cross_k": ck,
                            "cross_v": cv}
        return prefill
    transformer.require_ported(cfg)

    @_serving
    def prefill(params, batch):
        require_shardable(cfg, mesh_of(params))
        S = (batch["tokens"].shape[1] if "tokens" in batch
             else batch["embeddings"].shape[1])
        logits, _, cache = transformer.forward(
            params, batch, cfg, sys, collect_cache=True, last_only=True,
            max_cache=max_len or S)
        return logits, cache
    return prefill


def make_decode_step(cfg, sys: SystemConfig) -> Callable:
    """decode(params, cache, tokens, pos) -> (logits, cache)."""
    if is_encdec(cfg):
        @_serving
        def decode(params, cache, tokens, pos):
            require_shardable(cfg, mesh_of(params))
            return encdec.decode_step(params, cache, tokens, pos, cfg, sys)
        return decode
    transformer.require_ported(cfg)

    @_serving
    def decode(params, cache, tokens, pos):
        require_shardable(cfg, mesh_of(params))
        return transformer.decode_step(params, cache, tokens, pos, cfg, sys)
    return decode


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

class Abstract(NamedTuple):
    """A tree of meta tensors and, where a mesh was given, its spec tree
    (``distributed.sharding``'s tuples; None without a mesh)."""
    tree: Any
    specs: Any = None


def _meta_params(cfg):
    """Every parameter of ``cfg`` as a meta tensor in ``cfg.dtype``."""
    return weights.unflatten({
        p: torch.empty(s, device="meta", dtype=cfg.dtype)
        for p, s in weights.leaf_shapes(cfg).items()})


def abstract_state(cfg, opt: optimizers.Optimizer):
    """``make_train_state``'s tree on the meta device: parameters in
    ``cfg.dtype``, the optimizer's moments fp32, the step 0."""
    params = _meta_params(cfg)
    return {"params": params, "opt": opt.init(params), "step": 0}


def input_specs(cfg, shape: ShapeSpec, mesh=None) -> Abstract:
    """Abstract stand-ins for every model input of this (arch, shape)
    cell: int32 tokens and labels, bf16 frames or embeddings; a decode
    cell's "pos" is the last slot of its seq_len-long cache."""
    B, S = shape.global_batch, shape.seq_len
    baxes = None
    if mesh is not None:
        ax = tuple(a for a in sharding.BATCH_AXES
                   if a in mesh.mesh_dim_names)
        baxes = ax if len(ax) > 1 else (ax[0] if ax else None)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        nshards = 1
        for a in (baxes if isinstance(baxes, tuple) else
                  ((baxes,) if baxes else ())):
            nshards *= sizes[a]
        if B % max(1, nshards) != 0:
            baxes = None                     # tiny batches stay replicated

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        d = {"tokens": meta((B, 1), torch.int32), "pos": S - 1}
    elif is_encdec(cfg):
        d = {"frames": meta((B, cfg.n_enc_frames, cfg.d_model),
                            torch.bfloat16),
             "tokens": meta((B, S), torch.int32)}
    elif getattr(cfg, "takes_embeddings", False):
        d = {"embeddings": meta((B, S, cfg.d_model), torch.bfloat16)}
    else:
        d = {"tokens": meta((B, S), torch.int32)}
    if shape.kind == "train":
        d["labels"] = meta((B, S), torch.int32)
    if mesh is None:
        return Abstract(d)
    specs = {k: () if k == "pos" else
             (baxes,) + (None,) * (len(v.shape) - 1) for k, v in d.items()}
    return Abstract(d, specs)


def cache_specs_abstract(cfg, shape: ShapeSpec, mesh=None,
                         quant=False) -> Abstract:
    """The decode cache on the meta device (bf16, int8 under ``quant``),
    with its specs on a mesh."""
    B, S = shape.global_batch, shape.seq_len
    if is_encdec(cfg):
        tree = encdec.init_cache(cfg, B, min(S, 32768), device="meta")
    else:
        tree = transformer.init_cache(cfg, B, S, quant=quant, device="meta")
    if mesh is None:
        return Abstract(tree)
    return Abstract(tree, sharding.cache_specs(tree, cfg, mesh))


def state_specs_abstract(cfg, opt, mesh, sys) -> Abstract:
    tree = abstract_state(cfg, opt)
    return Abstract(tree, sharding.state_specs(tree, cfg, mesh, sys))


def param_specs_abstract(cfg, mesh, sys) -> Abstract:
    tree = _meta_params(cfg)
    return Abstract(tree, sharding.param_specs(tree, cfg, mesh, sys))
