"""Trial executor over the discrete-event cluster engine: the counterpart
of ``repro.cluster.executor``.

``ClusterTrialExecutor`` implements the same ``run_wave`` interface as the
serial/thread-pool executors, but instead of running trials on host threads
it dispatches each ``TrialProposal``'s epochs onto simulated cluster nodes:
a wave's trials queue for ``n_nodes`` workers, every epoch pays the
straggler/failure/reconfiguration costs *as it executes*, and completion
order is decided by the engine clock — so queueing delay and faults feed
back into when the scheduler hears about each score.

Like every executor it is a thin placement policy over a worker pool — here
a pool of exactly one ``repro_torch.cluster.worker.EngineWorker`` whose
capacity is the node count, with ``_placement`` as the policy hook the
sharded executor (``repro_torch.service.sharded``) overrides. The pool
supplies both drive modes:

* ``run_wave`` — barrier semantics, results merged in wave order. With
  faults disabled this is bit-identical to ``SerialTrialExecutor`` on a
  deterministic backend (scores never depend on the clock), which is the
  regression anchor.
* ``drive`` — the executor owns the whole ask/tell loop: proposals are
  dispatched the moment the scheduler releases them and every trial is
  reported at its simulated completion time. Barrier schedulers
  (``suggest() -> []`` while a wave is outstanding) degrade gracefully to
  wave-at-a-time; asynchronous schedulers (``AsyncASHA``) promote past
  straggling wave-mates — the asynchrony the thread-pool executor could
  never show, because it only returned control at wave boundaries.

The trials it runs are whatever the runner's backend does: ``SimBackend``
models them, so the makespan (``sim_now``) is simulated seconds of the
paper's cluster, not card time.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.cluster.engine import ClusterConfig, NodeSpec
from repro_torch.cluster.worker import (  # noqa: F401
    EngineWorker, TrialDispatch)
from repro_torch.core.schedulers import TrialProposal
from repro_torch.core.worker import WorkerPool

__all__ = ["ClusterTrialExecutor", "TrialDispatch"]


class ClusterTrialExecutor:
    """Executor dispatching scheduler waves onto simulated cluster nodes.

    ``default_sys`` (e.g. ``SIM_SYS_DEFAULT``) is what a trial's first-epoch
    system config is compared against to charge trial-level resource
    reallocation; None charges only epoch-boundary switches.
    """

    def __init__(self, cluster: Optional[ClusterConfig] = None,
                 default_sys: Optional[dict] = None, **cfg_kw):
        if cluster is not None and cfg_kw:
            raise ValueError("pass either a ClusterConfig or field kwargs, "
                             "not both")
        self.cfg = cluster if cluster is not None else ClusterConfig(**cfg_kw)
        # self._placement resolves to the subclass override (sharding) at
        # call time — the worker only holds the bound method
        self.worker = EngineWorker(self.cfg, default_sys=default_sys,
                                   placement=self._placement)
        self.pool = WorkerPool([self.worker])
        self.parallelism = sum(s.capacity for s in self.cfg.nodes)

    @property
    def engine(self):
        return self.worker.engine

    @property
    def history(self) -> List[TrialDispatch]:
        return self.worker.history

    @property
    def default_sys(self) -> Optional[dict]:
        return self.worker.default_sys

    @property
    def sim_now(self) -> float:
        """Current simulated time (the job's makespan once it finishes)."""
        return self.engine.now

    # ------------------------------------------------- elastic membership
    def add_node(self, spec: Optional[NodeSpec] = None,
                 at: Optional[float] = None, **spec_kw) -> int:
        """Join a simulated node mid-job — trials queued for capacity start
        on it the moment it joins."""
        return self.worker.add_node(spec, at=at, **spec_kw)

    def retire_node(self, node: int, at: Optional[float] = None) -> None:
        """Drain a node: its trials stop at their next epoch boundary, pay
        the restore + reconfiguration charge, and re-queue elsewhere."""
        self.worker.retire_node(node, at=at)

    def preempt(self, trial_id: str, at: Optional[float] = None) -> None:
        """Evict one trial the same way without touching its node."""
        self.worker.preempt(trial_id, at=at)

    def attach_bus(self, bus) -> None:
        """Route this executor's telemetry (pool dispatch/completion plus
        the engine's sim-time node events) to `bus`."""
        self.pool.bus = bus
        self.worker.bus = bus
        self.engine.bus = bus

    # ---------------------------------------------------------- drive loops
    def run_wave(self, runner, workload: str,
                 proposals: Sequence[TrialProposal]
                 ) -> List[Tuple[TrialProposal, float]]:
        return self.pool.run_wave(runner, workload, proposals)

    def drive(self, runner, workload: str, scheduler) -> None:
        """Event-driven ask/tell loop (see module docstring). Ends when the
        scheduler has nothing outstanding and releases no further work."""
        self.pool.drive(runner, workload, scheduler)

    def close(self) -> None:
        self.pool.close()

    # ------------------------------------------------------------ placement
    def _placement(self, runner, p: TrialProposal):
        """(node tag, backend) for one proposal. The base executor places
        anywhere and runs on the runner's own backend; the sharded executor
        (``repro_torch.service.sharded``) overrides this to bind each trial
        to a backend-tagged node group."""
        return None, None
