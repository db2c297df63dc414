"""Type-III workloads (paper Table 3: the Rodinia suite) on one device: the
counterpart of ``repro.models.numeric``.

Short-epoch iterative jobs, the adversarial case for PipeTune's
epoch-granular profiling (paper §7.3, Fig 12):

  jacobi    — 2D Poisson sweep solver; epoch = N sweeps,
              accuracy = 1 - residual/initial.
  spkmeans  — Lloyd iterations on synthetic blobs; accuracy = purity
              against the generating labels.
  bfs       — level-synchronous frontier propagation on a random graph via
              adjacency products; accuracy = fraction of nodes visited.

The data are the reference's: the same ``np.random.RandomState(seed)`` draws
in the same order, moved to the device. ``jax.lax.scan`` becomes a Python
loop of eager ops, so on the card an epoch is a few hundred small launches.
bfs's ``adj @ frontier`` is an int32 product in the reference; CUDA has no
integer matmul in PyTorch, so here it is an fp32 product, which is exact
(each count is at most the node count, below 2**24), compared with 0 as the
reference's is. bfs ignores the precision, as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class NumericConfig:
    name: str
    kind: str                  # jacobi | spkmeans | bfs
    size: int = 128            # grid side / points / nodes
    sweeps_per_epoch: int = 20
    k: int = 8                 # clusters (spkmeans)
    avg_degree: int = 8        # bfs
    family: str = "numeric"


def init_state(cfg: NumericConfig, seed: int = 0,
               device: device_lib.DeviceLike = None) -> dict:
    dev = device_lib.resolve(device)
    rng = np.random.RandomState(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    if cfg.kind == "jacobi":
        b = f32(rng.randn(cfg.size, cfg.size))
        return {"x": torch.zeros_like(b), "b": b,
                "r0": float(torch.linalg.norm(b))}
    if cfg.kind == "spkmeans":
        centers = rng.randn(cfg.k, 16) * 6
        labels = rng.randint(0, cfg.k, cfg.size * 16)
        pts = centers[labels] + rng.randn(cfg.size * 16, 16)
        cents = pts[rng.choice(len(pts), cfg.k, replace=False)]
        return {"pts": f32(pts), "cents": f32(cents),
                "labels": torch.from_numpy(labels).to(dev)}
    if cfg.kind == "bfs":
        n = cfg.size * 8
        adj = (rng.rand(n, n) < cfg.avg_degree / n)
        adj = np.logical_or(adj, adj.T)
        frontier = np.zeros(n, bool)
        frontier[0] = True
        return {"adj": torch.from_numpy(adj).to(dev),
                "visited": torch.from_numpy(frontier).to(dev),
                "frontier": torch.from_numpy(frontier).to(dev)}
    raise ValueError(cfg.kind)


def _neighbours(x, b):
    """(up + dn + lf + rt + b) / 4 on the periodic grid, the reference's
    order of additions."""
    up = torch.roll(x, 1, 0)
    dn = torch.roll(x, -1, 0)
    lf = torch.roll(x, 1, 1)
    rt = torch.roll(x, -1, 1)
    return (up + dn + lf + rt + b) / 4.0


def _epoch_fn(cfg: NumericConfig, dtype: torch.dtype):
    """epoch(state) -> (state, aux): the reference's epoch functions, with
    each ``lax.scan`` a loop. aux is the residual norm (jacobi, fp32), the
    last Lloyd step's assignments (spkmeans) or the visited count (bfs)."""
    if cfg.kind == "jacobi":
        def epoch(state):
            x, b = state["x"].to(dtype), state["b"].to(dtype)
            for _ in range(cfg.sweeps_per_epoch):
                x = _neighbours(x, b)
            res = torch.linalg.norm((x - _neighbours(x, b)).float())
            return {**state, "x": x.float()}, res
        return epoch
    if cfg.kind == "spkmeans":
        def epoch(state):
            pts = state["pts"].to(dtype)
            c = state["cents"].to(dtype)
            assign = None
            for _ in range(max(1, cfg.sweeps_per_epoch // 4)):
                d2 = ((pts[:, None] - c[None]) ** 2).sum(-1)
                assign = torch.argmin(d2, 1)
                one = torch.nn.functional.one_hot(assign, cfg.k).to(dtype)
                c = (one.T @ pts) / torch.clamp(one.sum(0)[:, None],
                                                min=1.0)
            return {**state, "cents": c.float()}, assign
        return epoch
    if cfg.kind == "bfs":
        def epoch(state):
            adj = state["adj"].float()
            visited, frontier = state["visited"], state["frontier"]
            for _ in range(2):                 # two levels an epoch
                nxt = torch.logical_and(adj @ frontier.float() > 0,
                                        torch.logical_not(visited))
                visited, frontier = torch.logical_or(visited, nxt), nxt
            return ({**state, "visited": visited, "frontier": frontier},
                    visited.sum())
        return epoch
    raise ValueError(cfg.kind)


def accuracy(cfg: NumericConfig, state, aux) -> float:
    if cfg.kind == "jacobi":
        return float(max(0.0, 1.0 - float(aux) / max(state["r0"], 1e-9)))
    if cfg.kind == "spkmeans":
        assign = aux.cpu().numpy()
        labels = state["labels"].cpu().numpy()
        purity = 0
        for c in range(cfg.k):
            members = labels[assign == c]
            if len(members):
                purity += np.bincount(members).max()
        return float(purity / len(labels))
    if cfg.kind == "bfs":
        n = state["visited"].shape[0]
        return float(aux) / n
    raise ValueError(cfg.kind)


CONFIGS = {
    "jacobi-rodinia": NumericConfig("jacobi-rodinia", "jacobi"),
    "spkmeans-rodinia": NumericConfig("spkmeans-rodinia", "spkmeans"),
    "bfs-rodinia": NumericConfig("bfs-rodinia", "bfs"),
}
