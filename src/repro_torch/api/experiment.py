"""The `Experiment` facade of ``repro.api.experiment``: one fluent entry
point for an HPT job.

    from repro_torch.api import Experiment
    from repro_torch.core.job import HPTJob, Param, SearchSpace

    job = HPTJob(workload="lenet-mnist",
                 space=SearchSpace([Param("learning_rate", "log", 1e-3,
                                          0.1)]),
                 max_epochs=6)
    result = (Experiment(job)
              .with_tuner("pipetune", max_probes=4)
              .with_backend("real", device="cuda")
              .with_scheduler("hyperband")
              .run())

Names resolve through ``repro_torch.api.registry``; instances (a custom
backend, a pre-built scheduler) are accepted anywhere a name is. ``run``
returns the runner's ``JobResult``; trials run on the serial executor, the
port's only one, unless ``run`` is handed another. The reference's
``with_executor``, ``run(parallelism)`` and ``remote_runner_spec`` wait for
the parallel and remote executors (ROADMAP queue A, 2b (iii) and item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.api import registry
from repro_torch.core.job import HPTJob, SystemSpace
from repro_torch.core.pipetune import JobResult, TrialRunner
from repro_torch.core.schedulers import AskTellScheduler

__all__ = ["Experiment"]


class Experiment:
    """Fluent configuration of one tuning run over an ``HPTJob``.

    Defaults, as in the reference: TuneV1 tuner, sim backend (not ported
    yet: pass ``with_backend``), hyperband scheduler.
    """

    def __init__(self, job: HPTJob):
        self.job = job
        self._tuner: Tuple[Union[str, TrialRunner], Dict[str, Any]] = \
            ("v1", {})
        self._backend: Tuple[Union[str, Any], Dict[str, Any]] = ("sim", {})
        self._scheduler: Tuple[Union[str, AskTellScheduler],
                               Dict[str, Any]] = ("hyperband", {})
        self._sys_space: Optional[SystemSpace] = None
        self._groundtruth = None
        self._runner_config_set: list = []   # with_* calls a tuner instance
        #                                      would silently ignore

    # -- fluent configuration ----------------------------------------------
    def with_tuner(self, tuner: Union[str, TrialRunner],
                   **kw) -> "Experiment":
        """Registry name ('v1'/'v2'/'pipetune'/...) or a TrialRunner
        instance; `kw` forwards to the tuner factory (e.g. max_probes)."""
        self._tuner = (tuner, kw)
        return self

    def with_backend(self, backend: Union[str, Any], **kw) -> "Experiment":
        """Registry name ('real'/'kernel-tune'/...) or a backend instance;
        `kw` forwards to the backend factory (e.g. n_train, device)."""
        self._backend = (backend, kw)
        self._runner_config_set.append("with_backend")
        return self

    def with_scheduler(self, scheduler: Union[str, AskTellScheduler],
                       **kw) -> "Experiment":
        """Registry name ('hyperband'/'random'/'grid'/'asha'/'pbt'/...) or an
        AskTellScheduler instance; `kw` forwards to the scheduler factory
        (e.g. n_trials)."""
        self._scheduler = (scheduler, kw)
        return self

    def with_sys_space(self, sys_space: SystemSpace) -> "Experiment":
        """Override the backend's default system-parameter space."""
        self._sys_space = sys_space
        self._runner_config_set.append("with_sys_space")
        return self

    def with_groundtruth(self, groundtruth) -> "Experiment":
        """Share a GroundTruth store across experiments (PipeTune's
        cross-job learning)."""
        self._groundtruth = groundtruth
        self._runner_config_set.append("with_groundtruth")
        return self

    # -- construction ------------------------------------------------------
    def build_backend(self):
        backend, kw = self._backend
        if isinstance(backend, str):
            return registry.make_backend(backend, **kw)
        return backend

    def resolved_sys_space(self) -> Optional[SystemSpace]:
        if self._sys_space is not None:
            return self._sys_space
        backend, kw = self._backend
        if isinstance(backend, str):
            return registry.default_sys_space(backend, **kw)
        return None

    def build_runner(self) -> TrialRunner:
        """Resolve backend + sys space + tuner into a ready TrialRunner."""
        tuner, kw = self._tuner
        if isinstance(tuner, TrialRunner):
            if self._runner_config_set:
                raise ValueError(
                    "a TrialRunner instance already owns its backend / "
                    "sys_space / groundtruth; "
                    f"{sorted(set(self._runner_config_set))} would be "
                    "ignored — configure the runner directly or pass the "
                    "tuner by registry name")
            return tuner
        return registry.make_tuner(tuner, self.build_backend(),
                                   sys_space=self.resolved_sys_space(),
                                   groundtruth=self._groundtruth, **kw)

    # -- execution ---------------------------------------------------------
    def run(self, executor=None) -> JobResult:
        """Execute the experiment on `executor` (the serial executor by
        default). Scores merge in wave order, so on a deterministic backend
        the result is reproducible."""
        runner = self.build_runner()
        scheduler, kw = self._scheduler
        if not isinstance(scheduler, str):
            if kw:
                raise ValueError("scheduler kwargs require a registry name, "
                                 "not an instance")
            if getattr(scheduler, "done", False):
                raise ValueError(
                    "scheduler instance is already exhausted (a previous "
                    "run() consumed it) — pass a fresh instance or use a "
                    "registry name, which rebuilds per run")
        return runner.run_job(self.job, scheduler=scheduler,
                              executor=executor, **kw)
