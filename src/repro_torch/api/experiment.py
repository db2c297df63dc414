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
              .run(parallelism=4))

Names resolve through ``repro_torch.api.registry``; instances (a custom
backend, a pre-built scheduler, an executor) are accepted anywhere a name
is. ``run`` returns the runner's ``JobResult``. Trials run on the serial
executor, on N thread lanes (``run(parallelism=N)``; on the card each lane
has its own CUDA stream), on the simulated cluster
(``with_executor("cluster")``) or on any executor given by name or
instance; an executor with remote workers gets ``remote_runner_spec``, the
recipe its workers mirror the runner from.
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

    Defaults, as in the reference: TuneV1 tuner, sim backend, hyperband
    scheduler, serial execution — the cheapest configuration that runs
    anywhere (the sim backend touches no device).
    """

    def __init__(self, job: HPTJob):
        self.job = job
        self._tuner: Tuple[Union[str, TrialRunner], Dict[str, Any]] = \
            ("v1", {})
        self._backend: Tuple[Union[str, Any], Dict[str, Any]] = ("sim", {})
        self._scheduler: Tuple[Union[str, AskTellScheduler],
                               Dict[str, Any]] = ("hyperband", {})
        self._executor: Optional[Tuple[Union[str, Any], Dict[str, Any]]] = \
            None
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
        """Registry name ('real'/'sim'/'kernel-tune'/...) or a backend
        instance; `kw` forwards to the backend factory (e.g. n_train,
        device)."""
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

    def with_executor(self, executor: Union[str, Any], **kw) -> "Experiment":
        """Registry name ('serial'/'parallel'/'cluster'/'workers'/...) or an
        executor instance; `kw` forwards to the executor factory (e.g.
        parallelism, n_nodes, straggler_prob)."""
        self._executor = (executor, kw)
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

    def remote_runner_spec(self) -> Optional[Dict[str, Any]]:
        """The recipe remote workers use to mirror this experiment's runner
        (tuner/backend registry names + kwargs). None when the tuner or
        backend is an instance, or a custom system space is set — none of
        those can travel over the wire, and a worker quietly substituting
        its own defaults would merge wrong scores (the executor raises
        instead). When the ground-truth client reaches a TCP store, its
        address rides along so every worker shares the same
        ``GroundTruthService``. Elastic pools (``--coordinator``) keep the
        spec and hand it to every worker that joins mid-run."""
        tuner, tuner_kw = self._tuner
        backend, backend_kw = self._backend
        if not isinstance(tuner, str) or not isinstance(backend, str) or \
                self._sys_space is not None:
            return None
        addr = getattr(getattr(self._groundtruth, "transport", None),
                       "addr", None)
        if self._groundtruth is not None and addr is None:
            # an in-proc store (or bare GroundTruth) cannot be reached from
            # another process: shipping the spec without it would quietly
            # split the tuning state between local and remote stores
            return None
        spec: Dict[str, Any] = {"tuner": tuner, "tuner_kw": dict(tuner_kw),
                                "backend": backend,
                                "backend_kw": dict(backend_kw)}
        if addr is not None:
            spec["store"] = f"tcp://{addr[0]}:{addr[1]}"
        return spec

    def build_executor(self, parallelism: int = 1):
        """Resolve the configured executor: ``with_executor`` name/instance,
        falling back to serial (or thread lanes for `parallelism` > 1)."""
        if self._executor is None:
            return registry.make_executor(parallelism)
        executor, kw = self._executor
        if isinstance(executor, str):
            return registry.make_executor(executor, **kw)
        if kw:
            raise ValueError("executor kwargs require a registry name, "
                             "not an instance")
        return executor

    # -- execution ---------------------------------------------------------
    def run(self, parallelism: int = 1, executor=None) -> JobResult:
        """Execute the experiment; `parallelism` > 1 runs each scheduler
        wave through a ParallelTrialExecutor, and ``with_executor`` (or the
        `executor` argument — a registry name or instance) picks any other
        execution substrate, e.g. "cluster" for the discrete-event
        simulated cluster. Scores merge in wave order, so on a
        deterministic backend results equal serial ones for runners
        without cross-trial shared state (TuneV1/TuneV2); PipeTune's shared
        ground-truth store makes its hit counts and locked system configs
        timing-dependent (see ``repro_torch.core.executor``)."""
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
        owned = False       # close executors nobody else holds a handle to
        if executor is None:
            owned = self._executor is None or \
                isinstance(self._executor[0], str)
            executor = self.build_executor(parallelism)
        elif isinstance(executor, str):
            executor = registry.make_executor(executor)
            owned = True
        # executors carrying remote workers mirror the runner out of process:
        # hand them the recipe unless they were built with an explicit one
        configure = getattr(executor, "configure_runner_spec", None)
        if configure is not None:
            configure(self.remote_runner_spec())
        # a trace-enabled executor (--trace with --workers/--coordinator)
        # pulls the driver's own store traffic into the same trace: store
        # RPCs emit RpcCompleted and the store service forwards its events
        trace_ctx = getattr(executor, "trace_context", None)
        enable_store_trace = getattr(self._groundtruth, "enable_trace", None)
        if trace_ctx and enable_store_trace is not None:
            try:
                enable_store_trace(trace_ctx["trace_id"],
                                   collector=trace_ctx.get("collector"),
                                   bus=getattr(executor, "trace_bus", None))
            except Exception:                   # noqa: BLE001 — best effort
                pass
        try:
            return runner.run_job(self.job, scheduler=scheduler,
                                  executor=executor, **kw)
        finally:
            close = getattr(executor, "close", None)
            if owned and close is not None:
                close()
