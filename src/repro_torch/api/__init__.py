"""Experiment API of the port: the ``Experiment`` facade, the name
registries, the executors and the Backend and Worker protocols of
``repro.api``, holding what the port has.

    from repro_torch.api import Experiment
    res = (Experiment(job).with_tuner("pipetune").with_backend("sim")
           .run(parallelism=4))
"""
from repro_torch.api.backend import (  # noqa: F401
    Backend, BackendCapabilities, backend_capabilities)
from repro_torch.api.executor import (  # noqa: F401
    ClusterTrialExecutor, ParallelTrialExecutor, SerialTrialExecutor,
    WorkerPoolExecutor)
from repro_torch.api.experiment import Experiment  # noqa: F401
from repro_torch.api.worker import (  # noqa: F401
    EngineWorker, InprocWorker, ThreadWorker, TrialCompletion, Worker,
    WorkerCapabilities, WorkerPool)
from repro_torch.api.registry import (  # noqa: F401
    available_backends, available_executors, available_schedulers,
    available_tuners, default_sys_space, make_backend, make_executor,
    make_scheduler, make_tuner, register_backend, register_executor,
    register_scheduler, register_tuner)
from repro_torch.core.schedulers import (  # noqa: F401
    AskTellScheduler, TrialProposal)
