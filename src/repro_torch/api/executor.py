"""Public re-export of the trial executors, as in ``repro.api.executor``,
limited to what the port has: serial and parallel
(``repro_torch.core.executor``), the event-driven cluster executor
(``repro_torch.cluster.executor``) and the worker-pool executor over local
workers (``repro_torch.core.worker``). The sharded and elastic executors
are ROADMAP queue A, item 12. ``make_executor`` is the registry resolver
("serial" / "parallel" / "cluster" / "workers" / plugin names, or an int
parallelism count).
"""
from repro_torch.api.registry import make_executor  # noqa: F401
from repro_torch.cluster.executor import ClusterTrialExecutor  # noqa: F401
from repro_torch.core.executor import (  # noqa: F401
    ParallelTrialExecutor, SerialTrialExecutor)
from repro_torch.core.worker import WorkerPoolExecutor  # noqa: F401

__all__ = ["SerialTrialExecutor", "ParallelTrialExecutor",
           "ClusterTrialExecutor", "WorkerPoolExecutor", "make_executor"]
