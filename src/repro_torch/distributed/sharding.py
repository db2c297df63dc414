"""Named-axis sharding rules for every model family: the counterpart of
``repro.distributed.sharding``.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
Batch always shards over ("pod","data"); tensor-parallel dims over "model".
Rules are divisibility-checked against the mesh: the first dim in a tensor's
preference list that divides evenly gets the "model" axis; big 2D+ params
additionally take an "fsdp" dim over ("pod","data") when
``sys.param_sharding == "2d"`` (ZeRO-3-style).

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``:
``None``, an axis name, or a tuple of axis names. The port's leaf paths are
the reference's (``weights.leaf_shapes``), so the rules apply unchanged. A
mesh is anything with ``shape`` and ``mesh_dim_names``: a ``DeviceMesh`` or
a ``launch.mesh.AbstractMesh``. ``named`` turns specs into DTensor
placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import weights
from repro_torch.tree import tree_map

BATCH_AXES = ("pod", "data")          # logical batch axes (subset present in mesh)


def _mesh_axis_sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _batch_axes(mesh):
    return tuple(a for a in BATCH_AXES if a in mesh.mesh_dim_names)


def _fsdp_axes(mesh, sys) -> Optional[tuple]:
    if getattr(sys, "param_sharding", "2d") != "2d":
        return None
    return _batch_axes(mesh) or None


def _divides(n, mesh_sizes, axes):
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= mesh_sizes[a]
    return n % total == 0


class RuleEngine:
    """Maps param-tree paths to specs via ordered regex rules.

    Each rule is (path_regex, [axis_prefs per tensor dim]) where an axis pref
    is a list of candidate assignments tried in order: "model", "fsdp",
    or None; a trailing "~" lets a candidate take a dim it does not divide
    (padded) while the padding at most doubles the dim. The first candidate
    that fits wins.
    """

    def __init__(self, mesh, sys):
        self.sizes = _mesh_axis_sizes(mesh)
        self.fsdp = _fsdp_axes(mesh, sys)

    def _resolve(self, dim_size, prefs, taken):
        for cand in prefs:
            if cand is None:
                return None
            padded = isinstance(cand, str) and cand.endswith("~")
            base = cand.rstrip("~")
            axes = self.fsdp if base == "fsdp" else ("model",)
            if axes is None:
                continue
            if any(a in taken for a in axes) or not all(
                    a in self.sizes for a in axes):
                continue
            if _divides(dim_size, self.sizes, axes):
                taken.update(axes)
                return axes if len(axes) > 1 else axes[0]
            if padded:
                total = 1
                for a in axes:
                    total *= self.sizes[a]
                shard = -(-dim_size // total)
                if shard * total <= 2 * dim_size:
                    taken.update(axes)
                    return axes if len(axes) > 1 else axes[0]
        return None

    def spec(self, shape, dim_prefs) -> tuple:
        taken: set = set()
        return tuple(self._resolve(size, prefs, taken)
                     for size, prefs in zip(shape, dim_prefs))


# Ordered (regex, dim_prefs) rules, the reference's as they are. Dim prefs
# are per-dimension candidate lists; unlisted trailing dims default to
# replicated.
_RULES = [
    # --- attention: the chain K -> G -> D picks the first dividing axis ---
    (r"attn/wq$",      [["fsdp"], ["model"], ["model"], ["model"]]),   # (d,K,G,D)
    (r"attn/wk$",      [["fsdp"], ["model"], ["model"]]),              # (d,K,D)
    (r"attn/wv$",      [["fsdp"], ["model"], ["model"]]),
    (r"attn/wo$",      [["model"], ["model"], ["model"], ["fsdp"]]),   # (K,G,D,d)
    (r"attn/b[qkv]$",  [[None], [None], [None]]),
    # --- dense MLP ---
    (r"mlp/w_(gate|up)$", [["fsdp"], ["model"]]),                      # (d,f)
    (r"mlp/w_down$",      [["model"], ["fsdp"]]),                      # (f,d)
    (r"(mlp|shared)/b_(up|down)$", [[None]]),
    # --- MoE experts: E rarely divides the data axis (8, 60), so the d_model
    # dim takes the FSDP axis as fallback ---
    (r"moe/router$",   [[None], [None]]),
    (r"moe/w_(gate|up)$", [["fsdp"], ["fsdp"], ["model"]]),            # (E,d,f)
    (r"moe/w_down$",      [["fsdp"], ["model"], ["fsdp"]]),            # (E,f,d)
    (r"shared/w_(gate|up)$", [["fsdp"], ["model"]]),
    (r"shared/w_down$",      [["model"], ["fsdp"]]),
    # --- RG-LRU ---
    (r"rec/w_in_(x|gate)$", [["fsdp"], ["model"]]),                    # (d,r)
    (r"rec/conv_w$",        [[None], ["model"]]),
    (r"rec/(w_a|w_x)$",     [[None], ["model"]]),                      # (r,r)
    (r"rec/(b_a|b_x|Lambda|conv_b)$", [["model"]]),
    (r"rec/w_out$",         [["model"], ["fsdp"]]),                    # (r,d)
    # --- xLSTM ---
    (r"cell/w_(up|gate)$", [["fsdp"], ["model"]]),                     # (d,di)
    (r"cell/conv_w$",      [[None], ["model"]]),
    (r"cell/conv_b$",      [["model"]]),
    (r"cell/w[qkv]$",      [["model"], [None], [None]]),               # (di,H,D)
    (r"cell/w_if$",        [[None], [None], [None]]),
    (r"cell/b_if$",        [[None], [None]]),
    (r"cell/w_down$",      [["model"], ["fsdp"]]),                     # (di,d)
    (r"cell/w_in$",        [["fsdp"], ["model"]]),                     # sLSTM (d,4di)
    (r"cell/w_rec$",       [[None], ["model"]]),                       # (di,4di)
    (r"cell/b$",           [["model"]]),
    # --- whisper enc-dec MHA (H=12 does not divide 16 -> D=64 shards) ---
    (r"(self|cross)/w[qkv]$", [["fsdp"], ["model"], ["model"]]),       # (d,H,D)
    (r"(self|cross)/wo$",     [["model"], ["model"], ["fsdp"]]),       # (H,D,d)
    # --- embeddings / heads / norms: d_model stays unsharded (an fsdp
    # 'data' contraction dim collides with the batch's 'data' axis) ---
    (r"embed$",        [["model"], [None]]),                           # (V,d)
    (r"lm_head$",      [[None], ["model"]]),                           # (d,V)
    (r"adapter$",      [[None], ["model"]]),
    (r"(norm|scale|bias)", [[None]]),
]


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over the leaves of a tree of dicts and lists."""
    return weights.unflatten({p: fn(p, leaf)
                              for p, leaf in weights.flatten(tree).items()})


def param_specs(params_tree, cfg, mesh, sys) -> Any:
    """Spec tree for a params tree (of tensors, meta tensors or anything
    with a ``shape``).

    Stacked layer dims (leading axes) are detected by comparing leaf rank
    to the rule's dim count and treated as replicated.
    """
    engine = RuleEngine(mesh, sys)

    def per_leaf(path, leaf):
        for regex, prefs in _RULES:
            if re.search(regex, path):
                ndim = len(leaf.shape)
                extra = ndim - len(prefs)
                if extra >= 0:          # leading dims are layer-stack axes
                    dim_prefs = [[None]] * extra + prefs
                else:                   # defensive: rule longer than leaf
                    dim_prefs = prefs[-ndim:]
                return engine.spec(leaf.shape, dim_prefs)
        return (None,) * len(leaf.shape)

    return _map_with_path(per_leaf, params_tree)


def _baxes(mesh):
    axes = _batch_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_specs(batch_tree, mesh) -> Any:
    baxes = _baxes(mesh)
    return tree_map(lambda leaf: (baxes,) + (None,) * (len(leaf.shape) - 1),
                    batch_tree)


def cache_specs(cache_tree, cfg, mesh) -> Any:
    """Decode caches: batch over data axes; head/state dims over model."""
    axes, baxes = _batch_axes(mesh), _baxes(mesh)
    sizes = _mesh_axis_sizes(mesh)

    def per_leaf(path, leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        b_idx = _cache_batch_dim(path, shape)
        if b_idx is not None and baxes is not None:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if shape[b_idx] % prod == 0:
                spec[b_idx] = baxes
        # model-shard the first exactly-dividing candidate dim
        m = sizes.get("model", 1)
        for i in _cache_model_dims(path, len(shape)):
            if i != b_idx and spec[i] is None and shape[i] % m == 0 \
                    and shape[i] >= m:
                spec[i] = "model"
                break
        return tuple(spec)

    return _map_with_path(per_leaf, cache_tree)


def _cache_batch_dim(path_str, shape):
    """Cache layouts (see transformer.init_cache):
    attn k/v: (L, B, W, K, D); hybrid recs: (G, R, B, ...); tails: (T, B, ...);
    ssm mlstms: (G, M, B, ...); slstm: (G, B, di); encdec: (L, B, ...)."""
    if re.search(r"recs/|mlstms/", path_str):
        return 2
    if re.search(r"tail/|slstm/|self_k|self_v|cross_k|cross_v|attn/|^k$|/k$|/v$",
                 path_str):
        return 1
    return 1 if len(shape) > 1 else None


def _cache_model_dims(path_str, rank):
    """Ordered candidate dims for model-axis sharding of a cache leaf."""
    if re.search(r"(^|/)[kv]$|self_k|self_v|cross_k|cross_v", path_str):
        return [rank - 2, rank - 1]     # kv-heads, then head_dim
    if re.search(r"/C$|/n$|/h$|/conv$", path_str):
        return [rank - 1]               # state feature dim
    return []


def state_specs(state_tree, cfg, mesh, sys) -> Any:
    """TrainState {params, opt{m,v}, step} -> spec tree."""
    pspec = param_specs(state_tree["params"], cfg, mesh, sys)
    return {"params": pspec,
            "opt": {k: pspec for k in state_tree["opt"]},
            "step": ()}


class NamedPlacements(NamedTuple):
    """A spec on a ``DeviceMesh`` as DTensor placements: the counterpart of
    ``NamedSharding``."""
    mesh: Any
    placements: Tuple[Placement, ...]

    def distribute(self, full: torch.Tensor) -> DTensor:
        """``full`` (the same logical array on every rank) as a DTensor:
        each rank keeps its own shard, with no communication."""
        return distribute_tensor(full, self.mesh, self.placements,
                                 src_data_rank=None)


def placements(spec, mesh) -> Tuple[Placement, ...]:
    """``Shard(d)`` on each mesh dim that the spec names for tensor dim
    ``d``, ``Replicate()`` elsewhere.

    A tensor dim over two mesh dims (fsdp's ("pod", "data")) is sharded
    over the first, then each shard over the second, so the two must come
    in mesh order. Where the dim divides evenly (every choice of ``_RULES``)
    this is the reference's pod-major split; where it does not (a padded
    "~" candidate) each rank holds ``torch.chunk``'s pieces of its pod's
    piece: 5 rows over 2 × 2 lie 2, 1, 1, 1 (GSPMD pads to 2, 2, 1, 0).
    """
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def named(spec_tree, mesh) -> Any:
    """A spec tree as ``NamedPlacements`` on ``mesh``."""
    return tree_map(lambda s: NamedPlacements(mesh, placements(s, mesh)),
                    spec_tree)
