"""Epoch-level workload profiles (paper §5.3): ``EpochProfile`` and the
58-event vector it is read as, copied from ``repro.core.profiler``.

Like the paper, a profile is a fixed-length event vector
(``PROFILE_EVENTS``) averaged over the epoch window; only execution-level
counters enter it, nothing model- or data-identifying. The ``Profiler``
that fills the compiled-program and memory events waits for the
tuning-loop slice (ROADMAP queue A, 2b); the kernel tuner fills the
runtime events itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

# 58 events, mirroring the paper's counter count. Grouped:
#   hlo.*   — compiled-program counters (per step)
#   coll.*  — collective payloads by kind
#   mem.*   — executable memory analysis
#   rt.*    — measured runtime statistics (per epoch)
#   shape.* — execution-shape descriptors
PROFILE_EVENTS: List[str] = [
    "hlo.flops", "hlo.bytes", "hlo.transcendentals", "hlo.arith_intensity",
    "hlo.dot_flops_frac", "hlo.elem_flops_frac", "hlo.reduce_flops_frac",
    "hlo.conv_flops_frac", "hlo.flops_per_token", "hlo.bytes_per_token",
    "coll.all_reduce", "coll.all_gather", "coll.reduce_scatter",
    "coll.all_to_all", "coll.collective_permute", "coll.total",
    "coll.count", "coll.bytes_per_flop", "coll.ar_frac", "coll.ag_frac",
    "mem.args_bytes", "mem.temp_bytes", "mem.out_bytes", "mem.code_bytes",
    "mem.peak_frac", "mem.params_bytes", "mem.opt_bytes", "mem.acts_bytes",
    "rt.step_time_mean", "rt.step_time_std", "rt.step_time_min",
    "rt.step_time_max", "rt.step_time_p50", "rt.step_time_p90",
    "rt.throughput", "rt.steps_per_epoch", "rt.epoch_time", "rt.power",
    "rt.energy", "rt.util_proxy", "rt.loss_start", "rt.loss_end",
    "rt.loss_delta", "rt.grad_norm_mean", "rt.compile_time", "rt.host_time",
    "shape.batch", "shape.seq_or_dim", "shape.params", "shape.layers",
    "shape.d_model", "shape.vocab", "shape.microbatches", "shape.dp",
    "shape.tp", "shape.remat", "shape.precision_bits", "shape.chips",
]

assert len(PROFILE_EVENTS) == 58


@dataclasses.dataclass
class EpochProfile:
    """``raw=True`` marks events that are already in compressed (log-ish)
    space — e.g. SimBackend's modeled vectors — so ``vector()`` returns
    them verbatim, in insertion order, instead of re-logging."""

    events: Dict[str, float]
    raw: bool = False

    @classmethod
    def from_vector(cls, vec) -> "EpochProfile":
        """Wrap an already-compressed profile vector (raw mode)."""
        return cls({f"ev{i}": float(v) for i, v in enumerate(vec)}, raw=True)

    def vector(self) -> np.ndarray:
        if self.raw:
            return np.asarray(list(self.events.values()), np.float64)
        v = np.zeros(len(PROFILE_EVENTS), np.float64)
        for i, name in enumerate(PROFILE_EVENTS):
            x = float(self.events.get(name, 0.0))
            # compress dynamic range like the paper's per-epoch averaging:
            # counters span 1e0..1e15, log1p keeps k-means distances sane.
            v[i] = math.log1p(abs(x)) * (1 if x >= 0 else -1)
        return v
