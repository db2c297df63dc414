"""Reusable discrete-event cluster engine with elastic membership: a copy of
``repro.cluster.engine``.

An event heap, a pool of nodes with FIFO dispatch, and fault injection, so
that *both* the multi-tenant job simulation (``repro_torch.cluster.sim``)
and the trial-level executor
(``repro_torch.cluster.executor.ClusterTrialExecutor``) run on the same
clock. Times are simulated seconds: nothing here runs on a device.

A *task* is a generator yielding base epoch durations (seconds). The engine
owns time: it assigns each task to the first compatible node with a free
slot (FIFO queue while all are busy), pulls one epoch at a time from the
generator, injects stragglers and failures into the yielded duration *at
execution time*, and advances the clock by the effective duration. Because
faults are drawn as epochs execute — not rewritten into a finished trace
afterwards — anything observing completion times (an asynchronous
scheduler, a queueing benchmark) sees cluster conditions the way a real
tuner would.

Nodes are described by ``NodeSpec`` (speed factor, placement tag, slot
capacity) and membership is *mutable*: ``add_node`` joins a node mid-run,
``retire_node`` drains one (tasks on it stop at their next epoch boundary,
pay the restore + reconfiguration charge — the reshard onto a different
slice of ``repro_torch.distributed.elastic`` — and re-queue), and ``preempt`` evicts
a single task the same way without touching the node. A ``policy``
callback, invoked whenever the queue changes (arrival or completion), can
call those events to implement elastic allocation (``ClusterSim``'s
``ElasticPolicy`` splits full nodes into slower fractional ones under
queue pressure and merges them back when the queue drains).

Determinism: fault draws come from a per-task RNG stream keyed by
``(cfg.seed, submission index)``, so they do not depend on how events from
different tasks interleave on the heap; heap ties break by submission
sequence, and preemption never re-draws — an evicted task resumes its
generator (and its RNG stream) exactly where it stopped, so no epoch is
lost or repeated. Two runs with the same ``ClusterConfig.seed``, the same
task set, and the same join/retire/preempt schedule are identical.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
from typing import (Callable, Dict, Generator, Iterable, Iterator, List,
                    Optional, Sequence)

import numpy as np

from repro_torch.obs.events import (EpochCompleted, Resharded,
                                    TrialDispatched, WorkerJoined,
                                    WorkerRetired, get_bus)


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One node's capabilities: relative speed (1.0 = the baseline node —
    epoch durations divide by it), placement tag (a task submitted with
    ``tag=T`` runs only on nodes tagged ``T``), and slot capacity (how many
    tasks the node holds concurrently)."""
    speed: float = 1.0
    tag: Optional[str] = None
    capacity: int = 1

    def __post_init__(self):
        if not self.speed > 0.0:
            raise ValueError(f"node speed must be > 0, got {self.speed}")
        if self.capacity < 1:
            raise ValueError(f"node capacity must be >= 1, "
                             f"got {self.capacity}")


@dataclasses.dataclass
class ClusterConfig:
    n_nodes: int = 4
    mtbf_s: Optional[float] = None          # mean time between failures/node
    straggler_prob: float = 0.0             # per-epoch probability
    straggler_slowdown: float = 4.0
    mitigate_stragglers: bool = True
    backup_overhead: float = 0.15           # fraction of epoch for backup
    restore_s: float = 5.0                  # checkpoint restore time
    requeue_s: float = 2.0                  # scheduler redispatch latency
    reconfig_s: float = 8.0                 # resource-reallocation / compile
    async_overlap: float = 0.85             # fraction hidden when the runner
    #                                         compiles off the critical path
    seed: int = 0
    # per-node placement tags (len == n_nodes): a task submitted with
    # tag=T runs only on nodes tagged T; untagged tasks run anywhere.
    # The sharded executor tags each node with the backend it hosts.
    node_tags: Optional[Sequence[str]] = None
    # full per-node specs (heterogeneous clusters). Authoritative when set:
    # n_nodes/node_tags are derived from it. The n_nodes+node_tags
    # constructor is the back-compat path building all-speed-1.0 specs.
    nodes: Optional[Sequence[NodeSpec]] = None

    def __post_init__(self):
        if self.nodes is not None:
            if self.node_tags is not None:
                raise ValueError("pass tags inside NodeSpec when using "
                                 "nodes=; node_tags is the legacy spelling")
            self.nodes = tuple(self.nodes)
            self.n_nodes = len(self.nodes)
            return
        if self.node_tags is not None and len(self.node_tags) != self.n_nodes:
            raise ValueError(
                f"node_tags has {len(self.node_tags)} entries for "
                f"{self.n_nodes} nodes")
        tags = (list(self.node_tags) if self.node_tags is not None
                else [None] * self.n_nodes)
        self.nodes = tuple(NodeSpec(tag=t) for t in tags)


@dataclasses.dataclass
class TaskStats:
    """Execution record of one engine task (a trial dispatch or a whole
    tuning job, depending on the caller's granularity)."""
    task_id: str
    node: int = -1
    submit_s: float = 0.0
    start_s: float = 0.0
    finish_s: float = 0.0
    service_s: float = 0.0          # sum of effective (post-fault) durations
    n_epochs: int = 0
    n_failures: int = 0
    n_stragglers: int = 0
    n_preemptions: int = 0          # epoch-boundary evictions (retire/preempt)

    @property
    def queue_s(self) -> float:
        return self.start_s - self.submit_s


class _Task:
    __slots__ = ("stats", "gen", "rng", "on_done", "base_durations", "tag",
                 "started", "vacate", "pending_charge", "next_base")

    def __init__(self, stats: TaskStats, gen: Iterator[float],
                 rng: np.random.RandomState, on_done,
                 tag: Optional[str] = None):
        self.stats = stats
        self.gen = gen
        self.rng = rng
        self.on_done = on_done
        self.base_durations: List[float] = []   # pre-fault, for mitigation
        self.tag = tag                          # placement constraint
        self.started = False                    # ever dispatched to a node
        self.vacate = False                     # stop at next epoch boundary
        self.pending_charge = 0.0               # reshard cost paid at resume
        self.next_base: Optional[float] = None  # epoch peeked before a vacate


class EventEngine:
    """Event heap + per-node slot dispatch + execution-time fault injection.

    ``submit`` registers a task (generator of base epoch durations); ``run``
    drains the heap; ``run_next_completion`` advances until exactly one task
    finishes — the hook an asynchronous driver uses to report results at
    their simulated completion times. ``add_node`` / ``retire_node`` /
    ``preempt`` mutate membership (module docstring); ``policy``, when set,
    is called after every arrival and completion and may invoke them.
    """

    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        self.now = 0.0
        self.completed: List[TaskStats] = []
        self._heap: List[tuple] = []            # (time, seq, thunk)
        self._seq = itertools.count()
        self._nodes: List[NodeSpec] = list(cfg.nodes)
        self._in_use: List[int] = [0] * len(self._nodes)
        self._retired: set = set()              # out of service, empty
        self._draining: set = set()             # retiring, tasks still on it
        self._waiting: collections.deque = collections.deque()
        self._live: Dict[str, _Task] = {}       # submitted, not yet finished
        self._n_submitted = 0
        self._n_active = 0
        self.policy: Optional[Callable[["EventEngine"], None]] = None
        self._in_policy = False
        self.bus = get_bus()                    # sim-time events (at_s=now)

    # ------------------------------------------------------------- submit
    def submit(self, task_id: str, process: Iterator[float],
               at: Optional[float] = None,
               on_done: Optional[Callable[[TaskStats], None]] = None,
               tag: Optional[str] = None) -> TaskStats:
        """Schedule `process` (a generator of base epoch durations) to
        arrive at time `at` (default: now). Returns the live stats object,
        filled in as the task executes. ``tag`` restricts placement to
        nodes whose ``NodeSpec.tag`` matches."""
        at = self.now if at is None else at
        if at < self.now:
            raise ValueError(f"cannot submit in the past ({at} < {self.now})")
        if tag is not None and all(s.tag != tag for s in self._nodes):
            raise ValueError(
                f"no node tagged {tag!r} (tags: "
                f"{sorted({s.tag for s in self._nodes} - {None})})")
        stats = TaskStats(task_id=task_id, submit_s=at)
        rng = np.random.RandomState(
            (self.cfg.seed * 1_000_003 + 7919 * self._n_submitted)
            % (2 ** 31 - 1))
        task = _Task(stats, iter(process), rng, on_done, tag=tag)
        self._live[task_id] = task
        self._n_submitted += 1
        self._n_active += 1
        self._push(at, lambda: self._arrive(task))
        return stats

    @property
    def pending(self) -> int:
        """Tasks submitted but not yet finished (queued or running)."""
        return self._n_active

    # ----------------------------------------------------- node membership
    @property
    def n_waiting(self) -> int:
        """Tasks queued for a free compatible slot (the policy's pressure
        signal)."""
        return len(self._waiting)

    def node_spec(self, node: int) -> NodeSpec:
        return self._nodes[node]

    @property
    def _tags(self) -> List[Optional[str]]:
        # pre-NodeSpec spelling of per-node tags, kept for callers that
        # indexed it directly
        return [s.tag for s in self._nodes]

    def node_ids(self, active_only: bool = True) -> List[int]:
        return [i for i in range(len(self._nodes))
                if not active_only or self.node_active(i)]

    def node_active(self, node: int) -> bool:
        """Accepting work: joined, not retired, not draining."""
        return node not in self._retired and node not in self._draining

    def node_busy(self, node: int) -> int:
        """Slots currently occupied on `node`."""
        return self._in_use[node]

    def add_node(self, spec: Optional[NodeSpec] = None,
                 at: Optional[float] = None, **spec_kw) -> int:
        """Join a node (``NodeSpec`` or its fields) at time `at` (default:
        immediately). Returns the new node id; the node starts pulling
        compatible waiters the moment it joins."""
        if spec is not None and spec_kw:
            raise ValueError("pass a NodeSpec or field kwargs, not both")
        spec = spec if spec is not None else NodeSpec(**spec_kw)
        node = len(self._nodes)
        self._nodes.append(spec)
        self._in_use.append(0)
        self._retired.add(node)                 # inactive until the join fires
        if at is None or at <= self.now:
            self._join(node)
        else:
            self._push(at, lambda: self._join(node))
        return node

    def retire_node(self, node: int, at: Optional[float] = None) -> None:
        """Take `node` out of service at time `at` (default: immediately).
        Idle nodes leave at once; a busy node drains — each task on it stops
        at its next epoch boundary, pays the restore + reconfiguration
        charge, and re-queues onto the surviving nodes."""
        if not 0 <= node < len(self._nodes):
            raise ValueError(f"unknown node {node}")
        if at is None or at <= self.now:
            self._do_retire(node)
        else:
            self._push(at, lambda: self._do_retire(node))

    def preempt(self, task_id: str, at: Optional[float] = None) -> None:
        """Evict `task_id` from its node at its next epoch boundary after
        `at` (default: now): it pays the restore + reconfiguration charge
        and re-queues (FIFO, behind current waiters). A waiting or already
        finished task is left alone. No completed epoch is lost or redone —
        the task's generator resumes exactly where it stopped."""
        if at is None or at <= self.now:
            self._do_preempt(task_id)
        else:
            self._push(at, lambda: self._do_preempt(task_id))

    # ---------------------------------------------------------------- run
    def run(self) -> None:
        """Drain the heap (all submitted tasks run to completion)."""
        while self._heap:
            self._step()
        if self._waiting:
            stuck = [t.stats.task_id for t in self._waiting]
            raise RuntimeError(
                f"engine drained with {len(stuck)} task(s) unplaceable "
                f"(no active compatible node remains): {stuck[:5]}")

    def run_next_completion(self) -> Optional[TaskStats]:
        """Advance the clock until one task finishes; returns its stats
        (None when nothing is left to run)."""
        n = len(self.completed)
        while self._heap and len(self.completed) == n:
            self._step()
        return self.completed[n] if len(self.completed) > n else None

    # ------------------------------------------------------------ internals
    def _push(self, t: float, thunk: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), thunk))

    def _step(self) -> None:
        t, _, thunk = heapq.heappop(self._heap)
        self.now = t
        thunk()

    def _compatible(self, task: _Task, node: int) -> bool:
        return task.tag is None or task.tag == self._nodes[node].tag

    def _free_slots(self, node: int) -> int:
        if not self.node_active(node):
            return 0
        return self._nodes[node].capacity - self._in_use[node]

    def _arrive(self, task: _Task) -> None:
        for node in range(len(self._nodes)):    # lowest-id compatible slot
            if self._free_slots(node) and self._compatible(task, node):
                self._claim(task, node)
                break
        else:
            self._waiting.append(task)
        self._run_policy()

    def _claim(self, task: _Task, node: int) -> None:
        self._in_use[node] += 1
        task.stats.node = node
        if not task.started:
            task.started = True
            task.stats.start_s = self.now
        if self.bus.enabled:
            self.bus.emit(TrialDispatched(trial_id=task.stats.task_id,
                                          worker=f"node:{node}",
                                          at_s=self.now))
        self._advance(task)

    def _advance(self, task: _Task) -> None:
        # pull the next epoch *before* honoring a vacate: a task whose
        # generator is exhausted at the boundary has nothing left to
        # migrate — it finishes in place (even on a draining node)
        if task.next_base is None:
            try:
                task.next_base = float(next(task.gen))
            except StopIteration:
                self._finish(task)
                return
        if task.vacate or task.stats.node in self._draining:
            self._vacate(task)          # keeps next_base for the new node
            return
        base, task.next_base = task.next_base, None
        base /= self._nodes[task.stats.node].speed
        eff = self._inject_faults(task, base)
        if task.pending_charge:
            eff += task.pending_charge          # reshard paid on first epoch
            task.pending_charge = 0.0           # after the migration
        task.stats.service_s += eff
        task.stats.n_epochs += 1
        if self.bus.enabled:
            self.bus.emit(EpochCompleted(
                trial_id=task.stats.task_id,
                worker=f"node:{task.stats.node}",
                epoch=task.stats.n_epochs - 1, duration_s=eff,
                at_s=self.now + eff))
        self._push(self.now + eff, lambda: self._advance(task))

    def _vacate(self, task: _Task) -> None:
        """Epoch-boundary eviction (node retiring, or explicit preempt):
        release the slot, charge the reshard (restore + reconfig, the
        elastic restore-on-a-different-slice path) against the task's next
        epoch, and re-arrive it behind the current waiters."""
        node = task.stats.node
        task.stats.node = -1
        task.vacate = False
        task.stats.n_preemptions += 1
        task.pending_charge += self.cfg.restore_s + self.cfg.reconfig_s
        if self.bus.enabled:
            self.bus.emit(Resharded(trial_id=task.stats.task_id,
                                    src=f"node:{node}", at_s=self.now))
        self._release_slot(node)
        self._push(self.now, lambda: self._arrive(task))

    def _finish(self, task: _Task) -> None:
        task.stats.finish_s = self.now
        self.completed.append(task.stats)
        self._n_active -= 1
        self._live.pop(task.stats.task_id, None)
        self._release_slot(task.stats.node)
        if task.on_done is not None:
            task.on_done(task.stats)
        self._run_policy()

    def _claim_waiter(self, node: int) -> bool:
        """Hand one free slot on `node` to the first compatible waiter
        (FIFO); False when none is compatible."""
        for i, waiter in enumerate(self._waiting):
            if self._compatible(waiter, node):
                del self._waiting[i]
                self._claim(waiter, node)
                return True
        return False

    def _release_slot(self, node: int) -> None:
        self._in_use[node] -= 1
        if node in self._draining:
            if self._in_use[node] == 0:         # last task left: gone
                self._draining.discard(node)
                self._retired.add(node)
            return
        self._claim_waiter(node)

    def _join(self, node: int) -> None:
        self._retired.discard(node)
        if self.bus.enabled:
            spec = self._nodes[node]
            self.bus.emit(WorkerJoined(worker=f"node:{node}",
                                       worker_kind="sim",
                                       capacity=spec.capacity,
                                       speed_factor=spec.speed,
                                       at_s=self.now))
        while self._free_slots(node) and self._claim_waiter(node):
            pass

    def _do_retire(self, node: int) -> None:
        if node in self._retired or node in self._draining:
            return
        if self.bus.enabled:
            self.bus.emit(WorkerRetired(worker=f"node:{node}",
                                        reason="retired",
                                        inflight=self._in_use[node],
                                        at_s=self.now))
        if self._in_use[node] == 0:
            self._retired.add(node)
        else:
            self._draining.add(node)            # tasks vacate at their next
        #                                         epoch boundary

    def _do_preempt(self, task_id: str) -> None:
        task = self._live.get(task_id)
        if task is not None and task.stats.node >= 0:
            task.vacate = True

    def _run_policy(self) -> None:
        if self.policy is None or self._in_policy:
            return
        self._in_policy = True
        try:
            self.policy(self)
        finally:
            self._in_policy = False

    def _inject_faults(self, task: _Task, d: float) -> float:
        """Straggler + failure model applied to one epoch as it executes
        (same formulas the post-hoc ``ClusterSim._apply_faults`` used, with
        the mitigation median computed online over the task's own epochs)."""
        cfg = self.cfg
        task.base_durations.append(d)
        eff = d
        if cfg.straggler_prob and task.rng.rand() < cfg.straggler_prob:
            task.stats.n_stragglers += 1
            slow = d * cfg.straggler_slowdown
            if cfg.mitigate_stragglers:
                seen = np.asarray(task.base_durations)
                med = float(np.median(seen))
                mad = float(np.median(np.abs(seen - med)))
                # speculative backup capped at median+3*MAD+overhead
                eff = min(slow, max(d, med + 3 * mad)
                          + cfg.backup_overhead * d)
            else:
                eff = slow
        if cfg.mtbf_s:
            # failure arrives within this epoch with p = 1-exp(-eff/mtbf)
            if task.rng.rand() < 1.0 - math.exp(-eff / cfg.mtbf_s):
                task.stats.n_failures += 1
                # lose a uniform fraction of the epoch, restore, redo
                eff += task.rng.rand() * eff + cfg.restore_s + cfg.requeue_s
        return eff


def reconfig_charge_s(cfg: ClusterConfig, runner) -> float:
    """Per-switch reconfiguration cost for `runner` on this cluster:
    PipeTune compiles candidate configs asynchronously (paper §5.2), hiding
    ``cfg.async_overlap`` of the charge; V1/V2 pay it in full."""
    overlap = cfg.async_overlap if getattr(runner, "overlap_reconfig",
                                           False) else 0.0
    return cfg.reconfig_s * (1.0 - overlap)


def charged_epoch_durations(results: Iterable, trial_id: str,
                            prev_sys: Dict[str, dict], charge: float,
                            default_sys: Optional[dict] = None
                            ) -> Generator[float, None, None]:
    """Map an iterator of ``EpochResult``s to base durations carrying the
    reconfiguration charge: a trial's very first epoch is charged when its
    system config deviates from ``default_sys`` (trial-level resource
    reallocation), later epochs whenever the config switches at an epoch
    boundary. ``prev_sys`` persists the last-seen config per trial across
    calls, so rung-resumed trials are only charged on real switches."""
    for res in results:
        d = res.duration_s
        scfg = res.sys_config
        prev = prev_sys.get(trial_id)
        if prev is None:
            nondefault = default_sys is not None and any(
                scfg.get(k) not in (None, v) for k, v in default_sys.items())
            if nondefault:
                d += charge
        elif scfg != prev:
            d += charge
        prev_sys[trial_id] = dict(scfg)
        yield d
