"""Simulated-node worker: the discrete-event engine behind the Worker
protocol (a copy of ``repro.cluster.worker``).

One ``EngineWorker`` is a whole group of simulated cluster nodes sharing an
``EventEngine`` clock: ``submit`` queues a proposal's epochs onto the first
compatible free node (paying straggler/failure/reconfiguration costs *as
epochs execute*), and a blocking ``poll`` advances the clock to the next
task completion — which is how the pool's event-driven ``drive`` loop hears
scores at their *simulated* completion times.

``placement`` is the executor's policy hook: ``(runner, proposal) ->
(node_tag, backend)``. The base cluster executor places anywhere on the
runner's own backend; the reference's sharded executor (ROADMAP item 12 in
the port) binds trials to backend-tagged node groups.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.cluster.engine import (ClusterConfig, EventEngine,
                                        NodeSpec, charged_epoch_durations,
                                        reconfig_charge_s)
from repro_torch.core.schedulers import TrialProposal
from repro_torch.core.worker import (TrialCompletion, Worker,
                                     WorkerCapabilities)

__all__ = ["EngineWorker", "TrialDispatch"]


@dataclasses.dataclass
class TrialDispatch:
    """One proposal's trip through the cluster (timing + outcome)."""
    trial_id: str
    epochs: int                     # the proposal's total-epoch target
    score: float = float("nan")
    node: int = -1
    backend: Optional[str] = None   # shard tag (a sharded executor only)
    submit_s: float = 0.0
    start_s: float = 0.0
    finish_s: float = 0.0
    n_stragglers: int = 0
    n_failures: int = 0

    @property
    def queue_s(self) -> float:
        return self.start_s - self.submit_s


class EngineWorker(Worker):
    """A node group on the event engine (see module docstring).

    ``default_sys`` (e.g. ``SIM_SYS_DEFAULT``) is what a trial's first-epoch
    system config is compared against to charge trial-level resource
    reallocation; None charges only epoch-boundary switches.
    """

    kind = "sim"

    def __init__(self, cfg: ClusterConfig,
                 default_sys: Optional[dict] = None,
                 placement: Optional[Callable] = None):
        super().__init__()
        self.cfg = cfg
        self.engine = EventEngine(cfg)
        self.default_sys = dict(default_sys) if default_sys else None
        self.placement = placement or (lambda runner, p: (None, None))
        self.history: List[TrialDispatch] = []  # every dispatch, finish order
        self._prev_sys: Dict[str, dict] = {}    # last sys config per trial
        self._done: List[TrialCompletion] = []
        self._outstanding = 0

    def capabilities(self) -> WorkerCapabilities:
        specs = [self.engine.node_spec(i) for i in self.engine.node_ids()]
        slots = sum(s.capacity for s in specs)
        speed = (sum(s.speed * s.capacity for s in specs) / max(slots, 1)
                 if specs else 1.0)
        return WorkerCapabilities(kind=self.kind, capacity=max(slots, 1),
                                  simulated=True, speed_factor=speed)

    @property
    def outstanding(self) -> int:
        return self._outstanding

    @property
    def sim_now(self) -> float:
        """Current simulated time (the job's makespan once it finishes).
        The clock persists across waves: a multi-wave job accumulates
        simulated time exactly like a tuning job occupying the cluster."""
        return self.engine.now

    # ------------------------------------------------- elastic membership
    def add_node(self, spec: Optional[NodeSpec] = None,
                 at: Optional[float] = None, **spec_kw) -> int:
        """Join a simulated node mid-job (see ``EventEngine.add_node``)."""
        return self.engine.add_node(spec, at=at, **spec_kw)

    def retire_node(self, node: int, at: Optional[float] = None) -> None:
        """Drain a simulated node: its trials re-shard at their next epoch
        boundary and re-queue (see ``EventEngine.retire_node``)."""
        self.engine.retire_node(node, at=at)

    def preempt(self, trial_id: str, at: Optional[float] = None) -> None:
        """Evict one trial at its next epoch boundary (restore + reconfig
        charge, no epoch lost or repeated)."""
        self.engine.preempt(trial_id, at=at)

    def submit(self, trial: TrialProposal,
               epochs: Optional[int] = None) -> None:
        epochs = trial.epochs if epochs is None else epochs
        runner = self.runner
        tag, backend = self.placement(runner, trial)
        dispatch = TrialDispatch(trial_id=trial.trial_id, epochs=epochs,
                                 submit_s=self.engine.now, backend=tag)
        charge = reconfig_charge_s(self.cfg, runner)
        process = charged_epoch_durations(
            runner.trial_epochs(self.workload, trial.trial_id, trial.hparams,
                                epochs, backend=backend),
            trial.trial_id, self._prev_sys, charge, self.default_sys)
        self.engine.submit(trial.trial_id, process,
                           on_done=self._finisher(runner, trial, dispatch),
                           tag=tag)
        self._outstanding += 1

    def poll(self, timeout: float = 0.0) -> List[TrialCompletion]:
        if not self._done and timeout > 0 and self._outstanding:
            stats = self.engine.run_next_completion()
            assert stats is not None, "engine drained with trials outstanding"
        out, self._done = self._done, []
        self._outstanding -= len(out)
        return out

    def _finisher(self, runner, p: TrialProposal, dispatch: TrialDispatch):
        def on_done(stats):
            dispatch.score = runner.records[p.trial_id].score(runner.objective)
            dispatch.node = stats.node
            dispatch.start_s = stats.start_s
            dispatch.finish_s = stats.finish_s
            dispatch.n_stragglers = stats.n_stragglers
            dispatch.n_failures = stats.n_failures
            self.history.append(dispatch)
            self._done.append(TrialCompletion(p.trial_id, dispatch.score,
                                              dispatch=dispatch))
        return on_done
