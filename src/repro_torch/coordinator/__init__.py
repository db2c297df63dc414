"""``python -m repro_torch.coordinator`` — the worker-discovery coordinator.

Thin entry-point package (same shape as ``repro_torch.worker``); the
implementation lives in ``repro_torch.service.coordinator`` (registry
service, announcer, roster-synced elastic executor).
"""
from repro_torch.service.coordinator import (  # noqa: F401
    CoordinatorService, CoordinatorTCPServer, main, serve_coordinator)

__all__ = ["CoordinatorService", "CoordinatorTCPServer", "serve_coordinator",
           "main"]
