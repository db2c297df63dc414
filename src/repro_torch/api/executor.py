"""Public re-export of the trial executors, as in ``repro.api.executor``:
serial and parallel (``repro_torch.core.executor``), the event-driven
cluster executor (``repro_torch.cluster.executor``), the multi-backend
sharded executor (``repro_torch.service.sharded``), the worker-pool
executor over local and remote workers (``repro_torch.core.worker``) and
its elastic form over a coordinator's roster
(``repro_torch.service.coordinator``). ``make_executor`` is the registry
resolver ("serial" / "parallel" / "cluster" / "sharded" / "workers" /
plugin names, or an int parallelism count).
"""
from repro_torch.api.registry import make_executor  # noqa: F401
from repro_torch.cluster.executor import ClusterTrialExecutor  # noqa: F401
from repro_torch.core.executor import (  # noqa: F401
    ParallelTrialExecutor, SerialTrialExecutor)
from repro_torch.core.worker import WorkerPoolExecutor  # noqa: F401
from repro_torch.service.coordinator import (  # noqa: F401
    ElasticWorkerPoolExecutor)
from repro_torch.service.sharded import ShardedTrialExecutor  # noqa: F401

__all__ = ["SerialTrialExecutor", "ParallelTrialExecutor",
           "ClusterTrialExecutor", "ShardedTrialExecutor",
           "WorkerPoolExecutor", "ElasticWorkerPoolExecutor",
           "make_executor"]
