"""Public re-export of the Worker protocol behind every executor, as in
``repro.api.worker``, limited to what the port has.

The protocol and local workers live in ``repro_torch.core.worker``; the
simulated-node worker lives in ``repro_torch.cluster.worker``. The remote
worker and its wire protocol are ROADMAP queue A, item 12.
"""
from repro_torch.cluster.worker import (  # noqa: F401
    EngineWorker, TrialDispatch)
from repro_torch.core.worker import (  # noqa: F401
    InprocWorker, ThreadWorker, TrialCompletion, Worker, WorkerCapabilities,
    WorkerPool, WorkerPoolExecutor)

__all__ = ["Worker", "WorkerCapabilities", "WorkerPool",
           "WorkerPoolExecutor", "TrialCompletion", "TrialDispatch",
           "InprocWorker", "ThreadWorker", "EngineWorker"]
