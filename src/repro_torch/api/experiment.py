"""The `Experiment` facade of ``repro.api.experiment``: one fluent entry
point for an HPT job.

    from repro_torch.api import Experiment
    from repro_torch.core.job import HPTJob, Param, SearchSpace

    job = HPTJob(workload="mlstm@B=8,S=2048,H=4,D=512",
                 space=SearchSpace([Param("chunk", "choice",
                                          choices=(64, 128))]),
                 max_epochs=1)
    result = (Experiment(job).with_tuner("v1").with_backend("kernel-tune")
              .with_scheduler("grid").run())

Names resolve through ``repro_torch.api.registry``; instances (a custom
backend, a pre-built scheduler) are accepted anywhere a name is. ``run``
returns the runner's ``JobResult``; trials run on the serial executor, the
port's only one. The reference's ``with_executor`` and ``run(parallelism)``,
its remote-runner and trace plumbing (``remote_runner_spec``,
``with_groundtruth``) and ``with_sys_space`` wait for the executors, stores
and system-probing tuners that need them (ROADMAP queue A, 2b).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

from repro_torch.api import registry
from repro_torch.core.job import HPTJob
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
        self._backend_set = False    # a tuner instance would ignore it

    # -- fluent configuration ----------------------------------------------
    def with_tuner(self, tuner: Union[str, TrialRunner],
                   **kw) -> "Experiment":
        """Registry name ('v1') or a TrialRunner instance; `kw` forwards to
        the tuner factory."""
        self._tuner = (tuner, kw)
        return self

    def with_backend(self, backend: Union[str, Any], **kw) -> "Experiment":
        """Registry name ('kernel-tune') or a backend instance; `kw`
        forwards to the backend factory (e.g. reps, device)."""
        self._backend = (backend, kw)
        self._backend_set = True
        return self

    def with_scheduler(self, scheduler: Union[str, AskTellScheduler],
                       **kw) -> "Experiment":
        """Registry name ('hyperband'/'random'/'grid'/'asha'/'pbt'/...) or an
        AskTellScheduler instance; `kw` forwards to the scheduler factory
        (e.g. n_trials)."""
        self._scheduler = (scheduler, kw)
        return self

    # -- construction ------------------------------------------------------
    def build_backend(self):
        backend, kw = self._backend
        if isinstance(backend, str):
            return registry.make_backend(backend, **kw)
        return backend

    def build_runner(self) -> TrialRunner:
        """Resolve backend + tuner into a ready TrialRunner."""
        tuner, kw = self._tuner
        if isinstance(tuner, TrialRunner):
            if self._backend_set:
                raise ValueError(
                    "a TrialRunner instance already owns its backend; "
                    "with_backend would be ignored — configure the runner "
                    "directly or pass the tuner by registry name")
            return tuner
        return registry.make_tuner(tuner, self.build_backend(), **kw)

    # -- execution ---------------------------------------------------------
    def run(self) -> JobResult:
        """Execute the experiment. Scores merge in wave order, so on a
        deterministic backend the result is reproducible."""
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
        return runner.run_job(self.job, scheduler=scheduler, **kw)
