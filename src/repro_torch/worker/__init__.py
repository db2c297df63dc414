"""``python -m repro_torch.worker`` — a remote trial worker process.

Thin entry-point package; the implementation lives in
``repro_torch.service.worker`` (server) and ``repro_torch.service.dispatch``
(wire protocol + ``RemoteWorker`` client).
"""
from repro_torch.service.worker import (  # noqa: F401
    TrialWorkerService, TrialWorkerTCPServer, main, serve_worker)

__all__ = ["TrialWorkerService", "TrialWorkerTCPServer", "serve_worker",
           "main"]
