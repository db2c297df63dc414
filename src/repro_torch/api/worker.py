"""Public re-export of the Worker protocol behind every executor, as in
``repro.api.worker``.

The protocol and local workers live in ``repro_torch.core.worker``; the
simulated-node worker lives in ``repro_torch.cluster.worker``; the remote
worker and its wire protocol live in ``repro_torch.service.dispatch``
(server: ``python -m repro_torch.worker``). Every executor — serial,
parallel, cluster, sharded, and the composable ``"workers"`` pool — is a
placement policy over a ``WorkerPool`` of these.
"""
from repro_torch.cluster.worker import (  # noqa: F401
    EngineWorker, TrialDispatch)
from repro_torch.core.worker import (  # noqa: F401
    InprocWorker, ThreadWorker, TrialCompletion, Worker, WorkerCapabilities,
    WorkerPool, WorkerPoolExecutor)
from repro_torch.service.dispatch import (  # noqa: F401
    RemoteWorker, WorkerError, WorkerLostError)

__all__ = ["Worker", "WorkerCapabilities", "WorkerPool",
           "WorkerPoolExecutor", "TrialCompletion", "TrialDispatch",
           "InprocWorker", "ThreadWorker", "EngineWorker", "RemoteWorker",
           "WorkerError", "WorkerLostError"]
