"""Performance + learning-curve models for the cluster simulator: a copy
of ``repro.cluster.perfmodel``.

Every time here is a *modeled* second of the paper's cluster (§3.2, Fig 3:
epochs of the Table-3 workloads on nodes of 4-16 cores and 4-32 GB), not a
time measured on the card, and the accuracies are a seeded response
surface, not training. The same inputs give the reference's numbers
exactly (``stable_hash`` is the port's copy of the reference's crc32 seed).

Step-time model mirrors the paper's §3.2 observations: adding cores/chips
helps large batches and *hurts* small ones (synchronization overhead of
synchronous mini-batch SGD), Fig 3b/3c. Learning curves are a deterministic
seeded response surface so hyperparameters genuinely matter (batch size up ->
accuracy down / epoch faster; lr has an optimum; dropout regularizes).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from repro_torch.core.seeding import stable_hash as _stable_hash

# per-sample forward+backward cost (modeled-seconds) and epoch sizing
WORKLOADS: Dict[str, dict] = {
    # type-I: image CNNs (same model, different datasets)
    "lenet-mnist":   dict(cost=2.0e-4, samples=60000, base_acc=0.992,
                          kind="image", feat=(6.0, 2.0, 1.0)),
    "lenet-fashion": dict(cost=2.0e-4, samples=60000, base_acc=0.915,
                          kind="image", feat=(6.1, 2.1, 1.0)),
    # type-II: text models (same dataset, different models)
    "cnn-news20":    dict(cost=9.0e-4, samples=11307, base_acc=0.87,
                          kind="text", feat=(9.0, 5.0, 2.0)),
    "lstm-news20":   dict(cost=2.4e-3, samples=11307, base_acc=0.83,
                          kind="text", feat=(11.0, 5.2, 2.2)),
    # type-III: short-epoch numeric kernels (Rodinia)
    "jacobi-rodinia":    dict(cost=6.0e-5, samples=1650, base_acc=0.99,
                              kind="numeric", feat=(3.0, 8.0, 4.0)),
    "spkmeans-rodinia":  dict(cost=8.0e-5, samples=1650, base_acc=0.97,
                              kind="numeric", feat=(3.2, 8.3, 4.1)),
    "bfs-rodinia":       dict(cost=5.0e-5, samples=1650, base_acc=0.98,
                              kind="numeric", feat=(2.8, 8.6, 4.3)),
}

SYNC_COST_S = 0.012          # per-update synchronization latency at 1 chip
PROFILE_DIM = 58


def epoch_time_s(workload: str, batch_size: int, chips: int,
                 memory_gb: int = 32, precision: str = "fp32") -> float:
    """Paper Fig 3b semantics: per-epoch time under a system config."""
    w = WORKLOADS[workload]
    steps = max(1, w["samples"] // batch_size)
    compute = w["cost"] * batch_size / chips
    if precision == "bf16":
        compute *= 0.62
    # synchronous SGD: per-step sync grows with chip count; small batches
    # amortize it poorly (this is what makes more chips slower at batch 64)
    sync = SYNC_COST_S * math.log2(max(2, chips))
    # memory pressure: paging penalty when the working set exceeds allocation
    working_gb = 0.5 + batch_size / 512.0
    mem_penalty = 1.0 + max(0.0, working_gb / memory_gb - 1.0) * 2.0
    return steps * (compute + sync) * mem_penalty


def utilization(workload: str, batch_size: int, chips: int) -> float:
    w = WORKLOADS[workload]
    compute = w["cost"] * batch_size / chips
    sync = SYNC_COST_S * math.log2(max(2, chips))
    return compute / (compute + sync)


def accuracy_at(workload: str, hparams: dict, epoch: int, seed: int = 0
                ) -> float:
    """Deterministic learning-curve surface (paper Fig 3a trade-offs)."""
    w = WORKLOADS[workload]
    bs = float(hparams.get("batch_size", 64))
    lr = float(hparams.get("learning_rate", 0.01))
    dr = float(hparams.get("dropout", 0.1))
    # asymptote: batch-size penalty (stochasticity loss), lr optimum ~0.01,
    # mild dropout helps text, hurts numeric
    a_max = w["base_acc"]
    a_max -= 0.015 * max(0.0, math.log2(bs / 32.0))
    a_max -= 0.25 * (math.log10(lr / 0.01)) ** 2 * 0.1
    bonus = {"image": 0.0, "text": 0.02, "numeric": -0.02}[w["kind"]]
    a_max += bonus * (1.0 - abs(dr - 0.25) / 0.25)
    rate = 0.55 * (lr / 0.01) ** 0.35 * (32.0 / bs) ** 0.15
    rate = min(max(rate, 0.05), 1.5)
    acc = a_max * (1.0 - math.exp(-rate * (epoch + 1)))
    rng = np.random.RandomState(
        (_stable_hash(workload) + seed * 9973 + epoch) % 2**31)
    return float(np.clip(acc + rng.randn() * 0.004, 0.0, 1.0))


def profile_vector(workload: str, batch_size: int, chips: int,
                   seed: int = 0) -> np.ndarray:
    """Synthetic 58-event profile: workload-characteristic base + config
    terms + seeded jitter. Same-family workloads land close together (the
    clustering result of paper Fig 8)."""
    w = WORKLOADS[workload]
    rng = np.random.RandomState((_stable_hash(w["kind"]) % 1000) + 17)
    base = rng.rand(PROFILE_DIM) * 4.0            # family signature
    rng2 = np.random.RandomState(_stable_hash(workload) % 2**31)
    base = base + rng2.rand(PROFILE_DIM) * 0.4    # per-workload offset
    f = np.asarray(w["feat"])
    base[:3] += f
    base[3] += math.log1p(batch_size)
    base[4] += math.log1p(chips)
    jitter = np.random.RandomState(seed).randn(PROFILE_DIM) * 0.03
    return base + jitter
