"""The training-backend protocol, as in ``repro.api.backend``.

A backend owns everything below the epoch boundary: model/optimizer state,
data, step functions. The runner (PipeTune / Tune V1/V2) owns the
per-epoch system-parameter policy and calls the backend one epoch at a time.

Structural typing: any object with these three methods is a backend —
``TorchRealBackend`` (actual training), ``SimBackend`` (modeled epochs),
``KernelTuneBackend`` (kernel timings), and user-defined ones.
Capabilities are *declared* via ``capabilities()`` instead of ``hasattr``
duck-typing; optional fast paths (``precompile_async``) are gated on the
corresponding capability flag.
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       TrialState, backend_capabilities)

__all__ = ["Backend", "BackendCapabilities", "backend_capabilities"]


@runtime_checkable
class Backend(Protocol):
    """init_trial / run_epoch / capabilities — the whole contract."""

    def init_trial(self, workload: str, hparams: dict, seed: int = 0
                   ) -> TrialState:
        """Fresh trial state at epoch 0 for `workload` under `hparams`."""
        ...

    def run_epoch(self, state: TrialState, sys_cfg: dict,
                  collect_profile: bool = True
                  ) -> Tuple[TrialState, EpochResult]:
        """Advance `state` one epoch under system config `sys_cfg`."""
        ...

    def capabilities(self) -> BackendCapabilities:
        """Declared capabilities (async precompile, simulation,
        determinism)."""
        ...
