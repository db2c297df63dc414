"""PipeTune Algorithm 1 + the Tune V1/V2 baselines (paper §4, §5): the
counterpart of ``repro.core.pipetune``.

Trial execution modes:
  TuneV1   — hyperparameters only, fixed default system config, objective =
             accuracy (paper baseline I).
  TuneV2   — system parameters folded into the hyperparameter space, fixed
             per trial, objective = accuracy / training-time (baseline II).
  PipeTune — hyperparameters via the scheduler; system parameters tuned
             *inside* each trial at epoch granularity: profile epoch 0,
             ground-truth similarity lookup, probe one config per epoch on a
             miss, then lock the best config for the remaining epochs and
             feed the result back to the ground-truth store.

All three share TrialRunner (so HyperBand rung-resume works identically) and
a backend; PipeTune additionally takes a GroundTruth store and SystemSpace.
Trials run on any executor of ``repro_torch.core.executor`` or
``repro_torch.cluster``: the hook lock serializes the runner's bookkeeping
when lanes run trials concurrently, ``trial_epochs`` lets the cluster
executor charge each epoch to a simulated node as it happens, and the
per-trial backend binding keeps a trial on a pinned backend (a local
shard), and ``install_record`` adopts a record that a remote worker
(``repro_torch.service.dispatch``) ran on its own runner.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import probing
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       SYS_DEFAULT, TrialState,
                                       backend_capabilities)
from repro_torch.core.executor import make_executor
from repro_torch.core.groundtruth import GroundTruth
from repro_torch.core.job import HPTJob, SystemSpace
from repro_torch.core.schedulers import AskTellScheduler
from repro_torch.obs import spans

__all__ = ["JobResult", "PipeTune", "TrialRecord", "TrialRunner", "TuneV1",
           "TuneV2", "copy_tree"]


@dataclasses.dataclass
class TrialRecord:
    trial_id: str
    hparams: dict
    epochs: List[EpochResult] = dataclasses.field(default_factory=list)
    sys_history: List[dict] = dataclasses.field(default_factory=list)
    gt_hit: bool = False
    probe_epochs: int = 0
    remote: bool = False        # epochs ran on a remote worker's runner

    @property
    def accuracy(self) -> float:
        return self.epochs[-1].accuracy if self.epochs else 0.0

    @property
    def train_time(self) -> float:
        return sum(e.duration_s for e in self.epochs)

    @property
    def energy(self) -> float:
        return sum(e.energy_j for e in self.epochs)

    def score(self, objective: str) -> float:
        if objective == "accuracy_per_time":
            return self.accuracy / max(self.train_time, 1e-9)
        return self.accuracy


@dataclasses.dataclass
class JobResult:
    best_hparams: dict
    best_score: float
    best_record: Optional[TrialRecord]
    tuning_time_s: float            # sum of all trial epoch durations
    wall_time_s: float              # host wall time of the whole job
    energy_j: float
    records: Dict[str, TrialRecord]
    gt_hits: int = 0
    gt_misses: int = 0
    sim_time_s: float = 0.0         # simulated makespan when the job ran on
    #                                 an event-driven executor (0 otherwise)

    @property
    def best_accuracy(self):
        return self.best_record.accuracy if self.best_record else 0.0

    @property
    def best_train_time(self):
        return self.best_record.train_time if self.best_record else 0.0


def copy_tree(tree):
    """A copy of a nest of dicts, lists and tuples that shares no buffer
    with ``tree``: tensors are cloned and numpy arrays copied (a
    ``torch.Tensor`` has no ``.copy()``, so the reference's copy-if-it-has-
    ``copy`` rule would alias them); other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_tree(v) for v in tree)
    return tree


class TrialRunner:
    """Executes trials for a scheduler; caches trial state for rung resume."""

    overlap_reconfig = False          # PipeTune compiles async (paper §5.2)

    def __init__(self, backend, objective: str = "accuracy", seed: int = 0):
        self.backend = backend
        self.capabilities: BackendCapabilities = backend_capabilities(backend)
        self.objective = objective
        self.seed = seed
        self.states: Dict[str, TrialState] = {}
        self.records: Dict[str, TrialRecord] = {}
        # per-trial backend binding: a trial pinned to a backend (a local
        # shard) keeps returning to the backend that owns its state across
        # rung resumes
        self._trial_backends: Dict[str, Any] = {}
        # serializes runner bookkeeping (record/state dicts, policy hooks,
        # ground-truth store) when an executor runs trials concurrently;
        # backend.run_epoch — the expensive part — stays outside the lock
        self._hook_lock = threading.RLock()

    # -- per-trial system-config policy -------------------------------------
    def sys_for_epoch(self, record: TrialRecord, state: TrialState,
                      epoch: int, result_prev: Optional[EpochResult]) -> dict:
        return dict(SYS_DEFAULT)

    def after_epoch(self, record: TrialRecord, state: TrialState,
                    result: EpochResult):
        pass

    def finish_trial(self, record: TrialRecord, state: TrialState):
        pass

    def backend_for(self, trial_id: str):
        """The backend bound to `trial_id` (the runner's own by default)."""
        return self._trial_backends.get(trial_id, self.backend)

    def trial_epochs(self, workload: str, trial_id: str, hparams: dict,
                     total_epochs: int, backend=None):
        """Generator form of ``run_trial``: runs one backend epoch per
        iteration and yields its ``EpochResult``, so a discrete-event
        executor can charge each epoch to a simulated node clock as it
        happens. ``finish_trial`` fires when the generator is exhausted;
        the completed record is ``self.records[trial_id]``.

        `backend` pins the trial to a specific backend (a local shard); the
        binding sticks, so rung-resumed epochs hit the same backend that
        holds the trial's state."""
        with spans.span("tune.trial") as trial:
            with self._hook_lock:
                if backend is not None:
                    self._trial_backends[trial_id] = backend
                be = self.backend_for(trial_id)
                state = self.states.get(trial_id)
                if state is None:
                    with spans.span("tune.init_trial"):
                        state = be.init_trial(workload, hparams,
                                              seed=self.seed)
                    self.states[trial_id] = state
                    self.records[trial_id] = TrialRecord(trial_id,
                                                         dict(hparams))
                elif state.hparams != dict(hparams):
                    # PBT explore: continue the same state under perturbed
                    # hparams
                    state.hparams = dict(hparams)
                    self.records[trial_id].hparams = dict(hparams)
                record = self.records[trial_id]
            prev = record.epochs[-1] if record.epochs else None
            while state.epoch < total_epochs:
                with spans.span("tune.policy"), self._hook_lock:
                    sys_cfg = self.sys_for_epoch(record, state, state.epoch,
                                                 prev)
                    record.sys_history.append(dict(sys_cfg))
                with spans.span("tune.epoch"):
                    state, res = be.run_epoch(state, sys_cfg)
                with spans.span("tune.policy"), self._hook_lock:
                    record.epochs.append(res)
                    self.after_epoch(record, state, res)
                prev = res
                with trial.outside():       # the caller's work between
                    yield res               # epochs is not the trial's
            with spans.span("tune.policy"), self._hook_lock:
                self.finish_trial(record, state)

    def run_trial(self, workload: str, trial_id: str, hparams: dict,
                  total_epochs: int) -> TrialRecord:
        """Run the trial on to ``total_epochs``, one backend epoch at a
        time, resuming its cached state; the policy hooks fire around each
        epoch and ``finish_trial`` at the end."""
        for _ in self.trial_epochs(workload, trial_id, hparams, total_epochs):
            pass
        return self.records[trial_id]

    def install_record(self, record: TrialRecord) -> None:
        """Adopt a trial record produced elsewhere (a remote worker ran the
        epochs on its own runner); job-level bookkeeping — best trial,
        tuning time, energy, ground-truth counters — then sees it like any
        locally-run trial."""
        record.remote = True
        with self._hook_lock:
            self.records[record.trial_id] = record

    # -- job level -----------------------------------------------------------
    def run_job(self, job: HPTJob,
                scheduler: Union[str, AskTellScheduler] = "hyperband",
                executor=None, parallelism: int = 1, **sched_kw) -> JobResult:
        """Drive one HPT job: suggest a wave, execute it, report the scores.

        ``scheduler`` is a registry name (with ``sched_kw`` forwarded to its
        factory) or an AskTellScheduler instance. ``executor`` runs each
        wave; by default a serial executor, or a thread-lane one when
        ``parallelism > 1`` (proposals within a wave are independent by the
        scheduler contract, so this is the paper's trial-level
        parallelism).
        """
        t0 = time.monotonic()
        if isinstance(scheduler, str):
            # name resolution is the one service core takes from the api
            # layer, pulled lazily at call time so module imports stay
            # strictly downward (api -> core)
            from repro_torch.api.registry import make_scheduler
            sched = make_scheduler(scheduler, job, **sched_kw)
        else:
            sched = scheduler
        executor_owned = executor is None
        executor = executor if executor is not None \
            else make_executor(parallelism)
        try:
            drive = getattr(executor, "drive", None)
            if drive is not None:
                # event-driven executors own the ask/tell loop: they
                # dispatch proposals the moment the scheduler releases them
                # and report each trial at its *simulated* completion time,
                # which is what lets AsyncASHA promote past straggling
                # wave-mates
                drive(self, job.workload, sched)
            else:
                while True:
                    with spans.span("tune.schedule"):
                        wave = sched.suggest()
                    if not wave:
                        break
                    for proposal, score in executor.run_wave(
                            self, job.workload, wave):
                        with spans.span("tune.schedule"):
                            sched.report(proposal.trial_id, score)
            best_hp, best_score = sched.best()
            best_rec = max(self.records.values(),
                           key=lambda r: r.score(self.objective),
                           default=None)
            gt = getattr(self, "groundtruth", None)
            gt_hits = gt.hits if gt is not None else 0
            gt_misses = gt.misses if gt is not None else 0
            if gt is not None:
                # trials that ran on remote workers did their store lookups
                # out of process (one per trial, after its profiling epoch),
                # so the local client never saw them; their records carry
                # the outcome home (a mixed local + remote pool adds both)
                remote = [r for r in self.records.values()
                          if r.remote and r.epochs]
                hits = sum(1 for r in remote if r.gt_hit)
                gt_hits += hits
                gt_misses += len(remote) - hits
            return JobResult(
                best_hparams=best_hp or {}, best_score=best_score,
                best_record=best_rec,
                tuning_time_s=sum(r.train_time
                                  for r in self.records.values()),
                wall_time_s=time.monotonic() - t0,
                energy_j=sum(r.energy for r in self.records.values()),
                records=dict(self.records),
                gt_hits=gt_hits, gt_misses=gt_misses,
                sim_time_s=float(getattr(executor, "sim_now", 0.0)))
        finally:
            if executor_owned:
                close = getattr(executor, "close", None)
                if close is not None:
                    close()

    def clone_trial(self, dst_id: str, src_id: str):
        """PBT exploit: copy trial state (params/opt/epoch) src -> dst.

        Buffers are materially copied, not aliased (``copy_tree``): the
        clone trains in place without touching the source's tensors.
        """
        with self._hook_lock:
            src_state = self.states.get(src_id)
            if src_state is None:
                return
            st = copy.copy(src_state)
            st.hparams = dict(src_state.hparams)
            st.params = copy_tree(src_state.params)
            st.opt_state = copy_tree(src_state.opt_state)
            self.states[dst_id] = st
            if src_id in self._trial_backends:      # stay on the same shard
                self._trial_backends[dst_id] = self._trial_backends[src_id]
            rec = self.records.get(src_id)
            if rec is not None:
                self.records[dst_id] = TrialRecord(
                    dst_id, dict(rec.hparams), epochs=list(rec.epochs),
                    sys_history=list(rec.sys_history))


class TuneV1(TrialRunner):
    """Baseline I: hyperparameters only, accuracy objective."""



class TuneV2(TrialRunner):
    """Baseline II: system parameters appended to the search space; each
    trial runs its sampled system config for every epoch; objective is
    accuracy / training time (paper §4)."""

    def __init__(self, backend, sys_space: SystemSpace, seed: int = 0):
        super().__init__(backend, objective="accuracy_per_time", seed=seed)
        self.sys_space = sys_space
        self._rng = np.random.RandomState(seed)
        self._trial_sys: Dict[str, dict] = {}

    def sys_for_epoch(self, record, state, epoch, prev):
        cfg = self._trial_sys.get(record.trial_id)
        if cfg is None:
            cfgs = self.sys_space.configs()
            cfg = cfgs[self._rng.randint(len(cfgs))]
            self._trial_sys[record.trial_id] = cfg
        return dict(cfg)


class PipeTune(TrialRunner):
    """Algorithm 1. Per-trial pipeline:

      epoch 0           profile under the default config (trains normally)
      after epoch 0     ground-truth lookup; hit -> lock known config
      miss              probe one system config per epoch (still training)
      after probing     lock argmin(objective); store profile->config

    ``groundtruth`` is a store client: anything implementing the
    ``lookup``/``add``/``hits``/``misses`` surface. A bare ``GroundTruth``
    is the in-process store; ``repro_torch.service.StoreClient`` reaches a
    shared ``GroundTruthService`` (in process or over TCP), which is what
    lets concurrent jobs, sharded backends and separate processes tune
    against one store (paper §5.4-5.5).
    """

    overlap_reconfig = True

    def __init__(self, backend, sys_space: SystemSpace,
                 groundtruth: Optional[GroundTruth] = None,
                 objective: str = "accuracy", probe_objective: str = "duration",
                 max_probes: int = 6, probe_order: str = "diverse",
                 seed: int = 0):
        super().__init__(backend, objective=objective, seed=seed)
        self.sys_space = sys_space
        self.groundtruth = groundtruth or GroundTruth()
        self.probe_objective = probe_objective
        self.max_probes = max_probes
        self.probe_order = probe_order
        self._plans: Dict[str, probing.ProbePlan] = {}
        self._locked: Dict[str, dict] = {}
        self._profiles: Dict[str, np.ndarray] = {}

    def sys_for_epoch(self, record, state, epoch, prev):
        """The epoch's config; counts the epoch by phase (``obs.spans``
        counters ``tune.epochs.profile``, ``.probe``, ``.locked``). An
        epoch with a plan and no lock is a probe, as ``after_epoch``
        records it."""
        tid = record.trial_id
        plan = self._plans.get(tid)
        if tid in self._locked or (epoch > 0 and plan is None):
            spans.counter("tune.epochs.locked")
            return dict(self._locked.get(tid, SYS_DEFAULT))
        if epoch == 0:
            spans.counter("tune.epochs.profile")
            return dict(SYS_DEFAULT)
        spans.counter("tune.epochs.probe")
        if not plan.done:
            cfg = plan.next_config()
            # async-compile the next candidate off the critical path
            if not plan.done and self.capabilities.async_precompile:
                self.backend_for(tid).precompile_async(
                    state, plan.configs[plan.next_idx])
            return dict(cfg)
        return dict(SYS_DEFAULT)

    def after_epoch(self, record, state, result: EpochResult):
        tid = record.trial_id
        if state.epoch == 1:                       # profiling epoch finished
            profile = result.profile.vector()
            self._profiles[tid] = profile
            with spans.span("tune.lookup"):
                score, known = self.groundtruth.lookup(profile)
            if known is not None:
                self._locked[tid] = known
                record.gt_hit = True
            else:
                maker = (probing.plan_diverse if self.probe_order == "diverse"
                         else probing.plan_grid)
                plan = maker(self.sys_space.configs(),
                             max_probes=self.max_probes, seed=self.seed)
                # epoch 0 already measured the default config — free probe
                plan.record(probing.ProbeResult(
                    sys_config=result.sys_config,
                    duration_s=result.duration_s, energy_j=result.energy_j,
                    accuracy=result.accuracy, loss=result.loss))
                self._plans[tid] = plan
                if self.capabilities.async_precompile and plan.configs:
                    self.backend_for(tid).precompile_async(
                        state, plan.configs[0])
            return
        plan = self._plans.get(tid)
        if plan is not None and tid not in self._locked:
            plan.record(probing.ProbeResult(
                sys_config=result.sys_config, duration_s=result.duration_s,
                energy_j=result.energy_j, accuracy=result.accuracy,
                loss=result.loss))
            record.probe_epochs += 1
            if plan.done:
                best = plan.best(self.probe_objective)
                self._locked[tid] = best

    def finish_trial(self, record, state):
        tid = record.trial_id
        if record.gt_hit or tid not in self._profiles:
            return
        locked = self._locked.get(tid)
        plan = self._plans.get(tid)
        if locked is None:
            # trial ended mid-probe (short HyperBand rung): usable only if
            # probing saw enough configs — storing a default-only "optimum"
            # would poison the ground truth for every later trial.
            if plan is not None and len(plan.results) >= 3:
                locked = plan.best(self.probe_objective)
        if locked and plan is not None and len(plan.results) >= 2:
            with spans.span("tune.store"):
                self.groundtruth.add(self._profiles[tid], state.workload,
                                     locked,
                                     objective=record.score(self.objective))
