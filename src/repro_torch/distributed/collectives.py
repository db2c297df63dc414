"""Compressed data-parallel gradient reduction over ``torch.distributed``:
the counterpart of ``repro.distributed.collectives``.

int8 values cannot be ring-all-reduced (summing saturates), so each rank
quantizes its local gradient, the int8 payload and the per-tensor scales are
all-gathered over the group, and every rank dequantizes and takes the mean
itself. Wire bytes drop about 4x against an fp32 all-reduce
(``compression.compressed_bytes``). Error feedback is the caller's job
(``compression.compress_grads``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import compression
from repro_torch.tree import tree_map


def compressed_psum_mean(x, group=None, method: str = "int8"):
    """Mean of every rank's ``x`` over ``group`` (default: the world).

    method="none" is the plain fp32 all-reduce sum over the world size (for
    A/B tests). The gathers take flat outputs, which gloo requires.
    """
    world = dist.get_world_size(group)
    if method == "none":
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / world
    q, scale = compression.quantize_int8(x)
    qg = torch.empty(world * q.numel(), dtype=torch.int8, device=x.device)
    dist.all_gather_into_tensor(qg, q.reshape(-1), group=group)
    sg = torch.empty(world, dtype=scale.dtype, device=x.device)
    dist.all_gather_into_tensor(sg, scale.reshape(1), group=group)
    deq = qg.reshape((world,) + tuple(x.shape)).float() * sg.reshape(
        (-1,) + (1,) * x.dim())
    return deq.mean(0)


def compressed_grad_mean(grads, group=None, method: str = "int8"):
    """Reduce every rank's local gradients to their mean, the same on every
    rank.

    Unlike the reference, which takes the gradients of all ranks stacked on
    a leading axis and reduces them under ``shard_map``, each rank passes
    its own local gradient tree and calls this collectively.
    """
    return tree_map(lambda g: compressed_psum_mean(g, group, method), grads)
