"""Energy accounting (paper §3.2: trapezoidal integration of PDU power):
the counterpart of ``repro.core.energy``, with the card's constants.

No PDU is read; power comes from an activity model
    P(card) = P_IDLE + P_DYN * utilization
as in the reference, and the paper's integration is kept: P is integrated
over per-step wall times, so measured-time jitter shows up in energy as the
paper's 1-second PDU samples did. The reference's per-chip constants are a
TPU's; here P_IDLE_W is the power.draw that ``nvidia-smi`` reads on an idle
NVIDIA H100 80GB HBM3 (the median of 10 samples, 71.83-71.91 W) and P_DYN_W
is its 700 W power limit less that. ``chip_smoke.py`` prints both beside the
card's own readings in every run.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

P_IDLE_W = 71.87         # per card: idle power.draw, H100 80GB HBM3
P_DYN_W = 700.0 - P_IDLE_W   # per card at full utilization: limit - idle
# The host share is the reference's model, an assumption and not a reading:
# a 150 W host shared by 8 accelerators.
HOST_W = 150.0           # per host (shared)
CHIPS_PER_HOST = 8


def power_w(utilization: float, chips: int = 1) -> float:
    u = min(max(utilization, 0.0), 1.0)
    hosts = max(1, chips // CHIPS_PER_HOST)
    return chips * (P_IDLE_W + P_DYN_W * u) + hosts * HOST_W / CHIPS_PER_HOST


def trapezoidal_energy(power_samples: Sequence[float],
                       dt_s: float = 1.0) -> float:
    """Joules from power samples at fixed dt (the paper's PDU integration)."""
    p = np.asarray(power_samples, np.float64)
    if p.size < 2:
        return float(p.sum() * dt_s)
    trap = getattr(np, 'trapezoid', getattr(np, 'trapz', None))
    return float(trap(p, dx=dt_s))


def epoch_energy(step_times: Sequence[float], utilization: float,
                 chips: int = 1) -> float:
    """Energy of one epoch: P(util) integrated over measured step times."""
    t = float(np.sum(step_times))
    return power_w(utilization, chips) * t
