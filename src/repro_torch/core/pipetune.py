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
Trials run on the serial executor; the reference's per-trial backend
binding, remote records and hook lock belong to the parallel, sharded and
remote executors (ROADMAP queue A, 2b (iii) and item 12).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import probing
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       SYS_DEFAULT, TrialState,
                                       backend_capabilities)
from repro_torch.core.executor import SerialTrialExecutor
from repro_torch.core.groundtruth import GroundTruth
from repro_torch.core.job import HPTJob, SystemSpace
from repro_torch.core.schedulers import AskTellScheduler

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
    sim_time_s: float = 0.0         # simulated makespan on an event-driven
    #                                 executor (2b (iii)); 0 on the serial one

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

    def __init__(self, backend, objective: str = "accuracy", seed: int = 0):
        self.backend = backend
        self.capabilities: BackendCapabilities = backend_capabilities(backend)
        self.objective = objective
        self.seed = seed
        self.states: Dict[str, TrialState] = {}
        self.records: Dict[str, TrialRecord] = {}

    # -- per-trial system-config policy -------------------------------------
    def sys_for_epoch(self, record: TrialRecord, state: TrialState,
                      epoch: int, result_prev: Optional[EpochResult]) -> dict:
        return dict(SYS_DEFAULT)

    def after_epoch(self, record: TrialRecord, state: TrialState,
                    result: EpochResult):
        pass

    def finish_trial(self, record: TrialRecord, state: TrialState):
        pass

    def run_trial(self, workload: str, trial_id: str, hparams: dict,
                  total_epochs: int) -> TrialRecord:
        """Run the trial on to ``total_epochs``, one backend epoch at a
        time, resuming its cached state; the policy hooks fire around each
        epoch and ``finish_trial`` at the end."""
        state = self.states.get(trial_id)
        if state is None:
            state = self.backend.init_trial(workload, hparams, seed=self.seed)
            self.states[trial_id] = state
            self.records[trial_id] = TrialRecord(trial_id, dict(hparams))
        elif state.hparams != dict(hparams):
            # PBT explore: continue the same state under perturbed hparams
            state.hparams = dict(hparams)
            self.records[trial_id].hparams = dict(hparams)
        record = self.records[trial_id]
        prev = record.epochs[-1] if record.epochs else None
        while state.epoch < total_epochs:
            sys_cfg = self.sys_for_epoch(record, state, state.epoch, prev)
            record.sys_history.append(dict(sys_cfg))
            state, prev = self.backend.run_epoch(state, sys_cfg)
            record.epochs.append(prev)
            self.after_epoch(record, state, prev)
        self.finish_trial(record, state)
        return record

    # -- job level -----------------------------------------------------------
    def run_job(self, job: HPTJob,
                scheduler: Union[str, AskTellScheduler] = "hyperband",
                executor=None, **sched_kw) -> JobResult:
        """Drive one HPT job: suggest a wave, run it on ``executor`` (the
        serial one by default), report the scores.

        ``scheduler`` is a registry name (with ``sched_kw`` forwarded to its
        factory) or an AskTellScheduler instance.
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
        executor = executor if executor is not None else SerialTrialExecutor()
        while True:
            wave = sched.suggest()
            if not wave:
                break
            for proposal, score in executor.run_wave(self, job.workload,
                                                     wave):
                sched.report(proposal.trial_id, score)
        best_hp, best_score = sched.best()
        best_rec = max(self.records.values(),
                       key=lambda r: r.score(self.objective), default=None)
        gt = getattr(self, "groundtruth", None)
        return JobResult(
            best_hparams=best_hp or {}, best_score=best_score,
            best_record=best_rec,
            tuning_time_s=sum(r.train_time for r in self.records.values()),
            wall_time_s=time.monotonic() - t0,
            energy_j=sum(r.energy for r in self.records.values()),
            records=dict(self.records),
            gt_hits=gt.hits if gt is not None else 0,
            gt_misses=gt.misses if gt is not None else 0)

    def clone_trial(self, dst_id: str, src_id: str):
        """PBT exploit: copy trial state (params/opt/epoch) src -> dst.

        Buffers are materially copied, not aliased (``copy_tree``): the
        clone trains in place without touching the source's tensors.
        """
        src_state = self.states.get(src_id)
        if src_state is None:
            return
        st = copy.copy(src_state)
        st.hparams = dict(src_state.hparams)
        st.params = copy_tree(src_state.params)
        st.opt_state = copy_tree(src_state.opt_state)
        self.states[dst_id] = st
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
    ``lookup``/``add``/``hits``/``misses`` surface; a bare ``GroundTruth``
    is the in-process store (the shared store service is ROADMAP queue A,
    item 12).
    """

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
        tid = record.trial_id
        if tid in self._locked:
            return dict(self._locked[tid])
        if epoch == 0:
            return dict(SYS_DEFAULT)
        plan = self._plans.get(tid)
        if plan is not None and not plan.done:
            cfg = plan.next_config()
            # async-compile the next candidate off the critical path
            if not plan.done and self.capabilities.async_precompile:
                self.backend.precompile_async(
                    state, plan.configs[plan.next_idx])
            return dict(cfg)
        return dict(SYS_DEFAULT)

    def after_epoch(self, record, state, result: EpochResult):
        tid = record.trial_id
        if state.epoch == 1:                       # profiling epoch finished
            profile = result.profile.vector()
            self._profiles[tid] = profile
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
                    self.backend.precompile_async(state, plan.configs[0])
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
            self.groundtruth.add(self._profiles[tid], state.workload, locked,
                                 objective=record.score(self.objective))
