"""Experiment API of the port: the ``Experiment`` facade and the name
registries of ``repro.api``, holding what the port has.

    from repro_torch.api import Experiment
    res = (Experiment(job).with_tuner("v1").with_backend("kernel-tune")
           .with_scheduler("grid").run())
"""
from repro_torch.api.experiment import Experiment  # noqa: F401
from repro_torch.api.registry import (  # noqa: F401
    available_backends, available_executors, available_schedulers,
    available_tuners, default_sys_space, make_backend, make_executor,
    make_scheduler, make_tuner, register_backend, register_executor,
    register_scheduler, register_tuner)
from repro_torch.core.schedulers import (  # noqa: F401
    AskTellScheduler, TrialProposal)
