"""The trial runner of ``repro.core.pipetune`` and the Tune V1 baseline
(paper §4, §5).

  TuneV1 — hyperparameters only, fixed default system config, objective =
           accuracy (paper baseline I).

``TrialRunner`` executes a scheduler's trials epoch by epoch and keeps each
trial's state, so a HyperBand rung promotion resumes a trial and costs only
the extra epochs. ``TuneV2`` and ``PipeTune`` (system parameters tuned
inside each trial against the ground-truth store) wait for the tuning-loop
slice (ROADMAP queue A, 2b), with the ground-truth and probing fields of
``TrialRecord``/``JobResult`` (``gt_hit``, ``probe_epochs``, ``gt_hits``,
...) that only they set.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       SYS_DEFAULT, TrialState,
                                       backend_capabilities)
from repro_torch.core.executor import SerialTrialExecutor
from repro_torch.core.job import HPTJob
from repro_torch.core.schedulers import AskTellScheduler

__all__ = ["JobResult", "TrialRecord", "TrialRunner", "TuneV1", "copy_tree"]


@dataclasses.dataclass
class TrialRecord:
    trial_id: str
    hparams: dict
    epochs: List[EpochResult] = dataclasses.field(default_factory=list)
    sys_history: List[dict] = dataclasses.field(default_factory=list)

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

    def run_trial(self, workload: str, trial_id: str, hparams: dict,
                  total_epochs: int) -> TrialRecord:
        """Run the trial on to ``total_epochs``, one backend epoch at a
        time, resuming its cached state."""
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
        return record

    # -- job level -----------------------------------------------------------
    def run_job(self, job: HPTJob,
                scheduler: Union[str, AskTellScheduler] = "hyperband",
                **sched_kw) -> JobResult:
        """Drive one HPT job: suggest a wave, run it on the serial executor,
        report the scores.

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
        executor = SerialTrialExecutor()
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
        return JobResult(
            best_hparams=best_hp or {}, best_score=best_score,
            best_record=best_rec,
            tuning_time_s=sum(r.train_time for r in self.records.values()),
            wall_time_s=time.monotonic() - t0,
            energy_j=sum(r.energy for r in self.records.values()),
            records=dict(self.records))

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

