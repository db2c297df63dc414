"""Gradient compression for data-parallel reduction: the counterpart of
``repro.distributed.compression``, over the port's trees.

int8 quantization (per-tensor scale) and top-k sparsification, both with
error feedback (the residual carried to the next step) so convergence is
preserved. The numerics are the reference's: ``torch.round`` rounds half to
even as ``jnp.round`` does, the scale carries the same ``1e-12``, and
top-k keeps every entry at least as large as the k-th largest, so ties keep
more than k.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def quantize_int8(x):
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def topk_sparsify(x, frac: float = 0.01):
    """Keep the top-frac |values|; returns (dense masked tensor, mask)."""
    flat = x.reshape(-1).abs()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    mask = x.abs() >= thresh
    return torch.where(mask, x, 0.0), mask


def compress_grads(grads, ef_state, method: str = "int8", topk_frac=0.01):
    """grads + error-feedback -> (compressed-then-decompressed grads, new ef).

    The returned grads are what the all-reduce carries; ef accumulates the
    quantization residual.
    """
    def one(g, ef):
        g = g.float() + ef
        if method == "int8":
            gq = dequantize_int8(*quantize_int8(g))
        elif method == "topk":
            gq, _ = topk_sparsify(g, topk_frac)
        else:
            gq = g
        return gq, g - gq

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs))


def init_ef(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_bytes(grads, method: str = "int8", topk_frac=0.01) -> int:
    """Wire bytes for the DP reduce under each scheme (int8 = 1/4 of fp32
    plus a 4-byte scale per tensor; topk = frac * (4B value + 4B index))."""
    leaves = tree_leaves(grads)
    n = sum(g.numel() for g in leaves)
    if method == "int8":
        return n + 4 * len(leaves)
    if method == "topk":
        return int(n * topk_frac) * 8
    return 4 * n
