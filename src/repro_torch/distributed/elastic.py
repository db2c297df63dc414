"""Elastic re-sharding: move live state onto a different mesh; the
counterpart of ``repro.distributed.elastic``.

Used for PipeTune's epoch-boundary system-parameter switches (a different
dp x tp split of the same ranks), fault recovery onto fewer nodes and
elastic grow/shrink. Logical arrays are identical before and after, bit for
bit; only placement changes. A DTensor cannot be redistributed across
meshes, so each leaf is gathered whole (``full_tensor()``) and distributed
onto the new mesh, every rank keeping its own shard.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding
from repro_torch.tree import tree_map


def _place(leaf, target: sharding.NamedPlacements):
    if not isinstance(leaf, torch.Tensor):
        return leaf                      # the step, a Python int
    full = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
    return target.distribute(full)


def reshard_state(state, cfg, new_mesh, sys):
    """The full train state (params, optimizer moments, step) onto
    ``new_mesh`` with the rule-derived placements. Leaves may be DTensors
    on any mesh over the same ranks, or whole tensors that every rank holds
    alike."""
    specs = sharding.state_specs(state, cfg, new_mesh, sys)
    return tree_map(_place, state, sharding.named(specs, new_mesh))


def reshard_params(params, cfg, new_mesh, sys):
    specs = sharding.param_specs(params, cfg, new_mesh, sys)
    return tree_map(_place, params, sharding.named(specs, new_mesh))
