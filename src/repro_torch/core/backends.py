"""The backend protocol types of ``repro.core.backends``.

A backend trains (or, for the kernel tuner, times) one trial an epoch at a
time: ``init_trial`` makes a ``TrialState``, ``run_epoch`` advances it under
a system config and returns an ``EpochResult``. ``RealBackend``, which
trains the paper's small workloads, waits for the tuning-loop slice
(ROADMAP queue A, 2b); ``repro_torch.kernels.tune.KernelTuneBackend`` is the
port's backend today.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.profiler import EpochProfile

# Memory-conservative production default (grad accumulation + remat —
# the "safe" config an operator picks without workload knowledge; the paper's
# trials likewise all start from one fixed default). PipeTune's probing
# discovers when the aggressive configs fit and are faster.
SYS_DEFAULT = {"remat": "block", "microbatches": 4, "precision": "fp32"}


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a training backend can do, declared instead of duck-typed.

    async_precompile — candidate system configs compile off the critical path
                       (the runner may call ``precompile_async``).
    simulated        — epochs are modeled, not executed (wall time is free).
    deterministic    — ``run_epoch`` is a pure function of (state, sys_cfg),
                       so results are bit-identical regardless of the order
                       trials execute in (safe for parallel executors that
                       need reproducibility).
    """
    async_precompile: bool = False
    simulated: bool = False
    deterministic: bool = False


def backend_capabilities(backend) -> BackendCapabilities:
    """Capabilities of ``backend``, with a duck-typing fallback for
    third-party backends that predate the protocol."""
    fn = getattr(backend, "capabilities", None)
    if fn is not None:
        return fn()
    return BackendCapabilities(
        async_precompile=callable(getattr(backend, "precompile_async", None)))


def sys_key(sys_cfg: dict) -> str:
    return "|".join(f"{k}={sys_cfg[k]}" for k in sorted(sys_cfg))


@dataclasses.dataclass
class EpochResult:
    duration_s: float
    energy_j: float
    loss: float
    accuracy: float
    profile: EpochProfile
    sys_config: dict
    step_times: list
    compile_s: float = 0.0


@dataclasses.dataclass
class TrialState:
    workload: str
    hparams: dict
    cfg: Any
    params: Any
    opt_state: Any
    step: int
    epoch: int
    data: Any              # Batches
    eval_batch: dict
    seed: int
    loss_last: float = float("nan")
