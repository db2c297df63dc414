"""The ``Worker`` protocol and the one drive loop behind every executor:
the counterpart of ``repro.core.worker``, for local members.

A *worker* is the unit of trial execution —

    submit(trial, epochs)   accept one TrialProposal (non-blocking)
    poll(timeout)           completions since the last poll; a positive
                            timeout may block (thread/remote workers) or
                            advance simulated time (engine workers)
    capabilities()          kind / capacity / simulated / remote
    close()                 release threads, sockets

— and every executor is a thin *placement policy* over a ``WorkerPool``:
which worker gets the next proposal. The pool owns the two drive loops all
executors share: ``run_wave`` (barrier semantics, results merged in wave
order — the determinism anchor) and ``drive`` (event-driven ask/tell:
dispatch proposals the moment the scheduler releases them, report each at
completion — what lets AsyncASHA promote past stragglers on the engine).

Worker families in the port:

* ``InprocWorker`` — runs the trial synchronously on the caller's thread
  at ``poll``. A pool of exactly one is the serial executor. An optional
  pinned ``backend`` makes it a local shard.
* ``ThreadWorker`` — ``capacity`` host-thread lanes; the parallel executor
  is a pool of one of these. On the card each lane trains on its own CUDA
  stream (``TorchRealBackend`` picks the stream per thread).
* ``EngineWorker`` (``repro_torch.cluster.worker``) — dispatches epochs
  onto simulated cluster nodes on the discrete-event clock.
* ``RemoteWorker`` (``repro_torch.service.dispatch``) — speaks the
  trial-dispatch wire protocol to a ``python -m repro_torch.worker``
  process.

Distributed tracing is ROADMAP queue A, item 13.

Clone requests (``proposal.clone_from``, the PBT exploit) are applied at
the wave boundary, before any trial of the wave starts, routed to the
worker that holds the source trial's state (sticky pools bind the clone to
that same worker).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedulers import TrialProposal
from repro_torch.obs.events import (Resharded, TrialCompleted,
                                    TrialDispatched, WorkerJoined,
                                    WorkerRetired, get_bus, worker_label)

__all__ = ["WorkerCapabilities", "TrialCompletion", "Worker",
           "InprocWorker", "ThreadWorker", "WorkerPool",
           "WorkerPoolExecutor"]


@dataclasses.dataclass(frozen=True)
class WorkerCapabilities:
    """What one worker is: declared, like ``BackendCapabilities``."""
    kind: str                    # "inproc" | "thread" | "sim" | "remote"
    capacity: int = 1            # trials the worker can hold concurrently
    simulated: bool = False      # completions carry simulated, not wall time
    remote: bool = False         # trials execute in another process
    speed_factor: float = 1.0    # relative throughput (1.0 = baseline node);
    #                              placement weights load by it, so a 2x
    #                              worker draws twice the trials


@dataclasses.dataclass
class TrialCompletion:
    """One finished trial, as reported by ``Worker.poll``."""
    trial_id: str
    score: float
    dispatch: Any = None         # engine workers attach their TrialDispatch
    error: Optional[BaseException] = None


class Worker:
    """Base implementation of the worker protocol (see module docstring).

    ``bind`` attaches the runner + workload before any submits; the pool
    re-binds when either changes (remote workers reset their mirror runner
    on re-bind). ``clone`` applies a PBT exploit on whatever holds the
    source trial's state — the shared runner for local workers.
    """

    kind = "worker"

    def __init__(self):
        self.runner = None
        self.workload: Optional[str] = None
        # telemetry: inert by default; pools propagate theirs so workers
        # that emit their own events (remote epoch completions) share it
        self.bus = get_bus()

    def bind(self, runner, workload: str) -> None:
        self.runner, self.workload = runner, workload

    def capabilities(self) -> WorkerCapabilities:
        return WorkerCapabilities(kind=self.kind)

    def clone(self, dst_id: str, src_id: str) -> None:
        self.runner.clone_trial(dst_id, src_id)

    @property
    def outstanding(self) -> int:
        return 0

    def submit(self, trial: TrialProposal,
               epochs: Optional[int] = None) -> None:
        raise NotImplementedError

    def submit_many(self, batch: Sequence[
            Tuple[TrialProposal, Optional[int]]]) -> None:
        """Accept a wave's worth of proposals at once. The default just
        loops ``submit``; a worker with a wire between it and the trials
        (``RemoteWorker``) overrides this to pay one round-trip for the
        whole batch."""
        for trial, epochs in batch:
            self.submit(trial, epochs)

    def poll(self, timeout: float = 0.0) -> List[TrialCompletion]:
        return []

    def poll_many(self, timeout: float = 0.0) -> List[TrialCompletion]:
        """Drain every ready completion. ``poll`` already returns all
        completions since the last call, so the default is an alias; it
        exists on the protocol so batched callers don't assume that."""
        return self.poll(timeout)

    def close(self) -> None:
        pass

    def _poll_queue(self, completions: "queue.Queue[TrialCompletion]",
                    timeout: float) -> List[TrialCompletion]:
        """Shared poll body for workers that complete asynchronously into a
        queue: block up to `timeout` for the first completion when work is
        outstanding, then drain whatever else is ready."""
        out: List[TrialCompletion] = []
        try:
            if timeout > 0 and self.outstanding and completions.empty():
                out.append(completions.get(timeout=timeout))
            while True:
                out.append(completions.get_nowait())
        except queue.Empty:
            pass
        return out


def _run_on(runner, workload: str, trial: TrialProposal, epochs: int,
            backend=None) -> float:
    """Execute one proposal on `runner` and return its score. A pinned
    `backend` sticks to the trial, so its rung resumes hit the backend
    that holds its state."""
    for _ in runner.trial_epochs(workload, trial.trial_id, trial.hparams,
                                 epochs, backend=backend):
        pass
    return runner.records[trial.trial_id].score(runner.objective)


class InprocWorker(Worker):
    """In-process worker on the caller's thread: ``submit`` queues, the
    next ``poll`` runs the queued trials to completion in submission order
    (submit stays non-blocking, so a mixed pool hands the whole wave to its
    remote/thread workers before local trials start burning the caller's
    thread). ``backend`` pins the worker's trials to a specific backend (a
    local shard in a mixed pool); ``tag`` is a display name for such
    shards."""

    kind = "inproc"

    def __init__(self, backend=None, tag: Optional[str] = None):
        super().__init__()
        self.backend = backend
        self.tag = tag
        self._pending: List[Tuple[TrialProposal, int]] = []

    @property
    def outstanding(self) -> int:
        return len(self._pending)

    def submit(self, trial: TrialProposal,
               epochs: Optional[int] = None) -> None:
        self._pending.append((trial,
                              trial.epochs if epochs is None else epochs))

    def poll(self, timeout: float = 0.0) -> List[TrialCompletion]:
        out: List[TrialCompletion] = []
        while self._pending:
            trial, epochs = self._pending.pop(0)
            score = _run_on(self.runner, self.workload, trial, epochs,
                            backend=self.backend)
            out.append(TrialCompletion(trial.trial_id, score))
        return out


class ThreadWorker(Worker):
    """``capacity`` host-thread lanes over the shared runner. Threads (not
    processes) because runner and backend state (step cache, ground-truth
    store) is shared; runner bookkeeping is serialized by the runner's own
    hook lock. PyTorch releases the GIL inside each op's kernel and while a
    thread waits on its stream, but holds it for each op's dispatch, so an
    eager trial epoch overlaps with its wave-mates only where the card (or
    a CPU kernel) does the work; ``chip_smoke.py`` measures how far."""

    kind = "thread"

    def __init__(self, capacity: int = 4):
        super().__init__()
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._pool = cf.ThreadPoolExecutor(max_workers=capacity)
        self._completions: "queue.Queue[TrialCompletion]" = queue.Queue()
        self._outstanding = 0

    def capabilities(self) -> WorkerCapabilities:
        return WorkerCapabilities(kind=self.kind, capacity=self.capacity)

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def submit(self, trial: TrialProposal,
               epochs: Optional[int] = None) -> None:
        epochs = trial.epochs if epochs is None else epochs
        self._outstanding += 1
        self._pool.submit(self._run, self.runner, self.workload, trial,
                          epochs)

    def _run(self, runner, workload, trial, epochs):
        try:
            score = _run_on(runner, workload, trial, epochs)
            self._completions.put(TrialCompletion(trial.trial_id, score))
        except BaseException as e:                      # noqa: BLE001
            self._completions.put(
                TrialCompletion(trial.trial_id, float("nan"), error=e))

    def poll(self, timeout: float = 0.0) -> List[TrialCompletion]:
        out = self._poll_queue(self._completions, timeout)
        self._outstanding -= len(out)
        return out

    def close(self) -> None:
        # wait: on an error path the wave's surviving trials are still
        # mutating the shared runner from these threads — callers must not
        # observe the runner while they race (the pre-pool per-wave
        # `with ThreadPoolExecutor` block gave the same guarantee)
        self._pool.shutdown(wait=True)


class WorkerPool:
    """A set of workers + placement + the two drive loops (module doc).

    ``sticky=True`` binds each trial to one worker for its whole life —
    required whenever workers hold private trial state (remote workers,
    pinned-backend shards): rung-resumed epochs and PBT clones must return
    to the worker that owns their state.

    Placement is capacity- and speed-aware: the next trial goes to the
    worker with the least load relative to its declared
    ``capabilities().capacity * speed_factor`` (ties by pool order). Load is
    trials in flight for free pools, live trial bindings for sticky ones —
    a 4-lane or 2x-speed worker draws proportionally more of the wave.

    Membership is *mutable*: ``add_worker`` joins a worker mid-``drive``
    (it is bound to the current runner/workload and immediately eligible;
    any backlogged trials dispatch to it), ``remove_worker`` retires one —
    in-flight trials on it are drained (``drain=True``) or re-placed onto
    the survivors, and its sticky bindings migrate (a re-placed trial
    re-runs its epochs on the new worker: state private to the dead worker
    is gone, which on a deterministic backend reproduces the same record).

    A completion carrying an error whose exception is flagged
    ``worker_lost`` (transport death — see ``repro_torch.service.dispatch``)
    retires the worker the same way when ``retire_on_error`` is set,
    instead of killing the run; any other error raises.

    ``maintenance``, when set, is called between waves and whenever the
    pool blocks for completions — the hook a coordinator-backed executor
    uses to sync the live roster (joins/leaves) into the pool. An empty
    pool (``allow_empty``) with a ``maintenance`` hook waits up to
    ``join_timeout_s`` for a worker to join.
    """

    def __init__(self, workers: Sequence[Worker], sticky: bool = False,
                 allow_empty: bool = False, join_timeout_s: float = 60.0):
        if not workers and not allow_empty:
            raise ValueError("need at least one worker")
        self.workers: List[Worker] = list(workers)
        self.sticky = sticky
        self.bus = get_bus()            # telemetry; off until observed
        self.drain_timeout_s = 30.0
        self.retire_on_error = False
        self.maintenance: Optional[Any] = None      # no-arg callable
        self.join_timeout_s = join_timeout_s
        self.dispatched: Dict[int, int] = {}        # id(worker) -> n trials
        self._bindings: Dict[str, Worker] = {}
        self._bound_key: Optional[Tuple[int, str]] = None
        self._bound: Optional[Tuple[Any, str]] = None   # (runner, workload)
        self._inflight: Dict[str, Tuple[TrialProposal, int]] = {}
        self._inflight_worker: Dict[str, Worker] = {}
        self._backlog: List[Tuple[TrialProposal, int]] = []
        self._drained: List[TrialCompletion] = []
        self._poll_rr = 0
        self._stall_t0: Optional[float] = None

    # ------------------------------------------------------------- binding
    def bind(self, runner, workload: str) -> None:
        key = (id(runner), workload)
        if self._bound_key != key:
            for w in self.workers:
                w.bind(runner, workload)
            self._bindings.clear()
            self._bound_key = key
            self._bound = (runner, workload)

    def _weight(self, w: Worker) -> float:
        caps = w.capabilities()
        return max(1, caps.capacity) * max(caps.speed_factor, 1e-9)

    def place(self, p: TrialProposal) -> Worker:
        """The worker that executes `p` (the executor's placement policy)."""
        if not self.workers:
            raise RuntimeError("worker pool has no workers to place on")
        if not self.sticky:
            # least in-flight load per unit of declared throughput; ties
            # break to the first worker (min returns the earliest)
            return min(self.workers,
                       key=lambda w: w.outstanding / self._weight(w))
        w = None
        if p.clone_from is not None:
            # a PBT exploit discards the destination's own state for a copy
            # of the source's, which lives on the source's worker — so the
            # destination re-binds there even if it ran elsewhere before
            w = self._bindings.get(p.clone_from)
        if w is None:
            w = self._bindings.get(p.trial_id)
        if w is None:
            # first sight: least live trials per unit of throughput, so
            # fast/wide workers own proportionally more of the population
            held: Dict[int, int] = {}
            for bw in self._bindings.values():
                held[id(bw)] = held.get(id(bw), 0) + 1
            w = min(self.workers,
                    key=lambda w_: held.get(id(w_), 0) / self._weight(w_))
        self._bindings[p.trial_id] = w
        return w

    def worker_of(self, trial_id: str) -> Optional[Worker]:
        return self._bindings.get(trial_id)

    # ----------------------------------------------------- pool membership
    def add_worker(self, worker: Worker) -> None:
        """Join `worker` mid-run: bound to the current runner/workload (may
        raise — e.g. a remote worker with no runner spec — in which case the
        pool is unchanged), then immediately eligible for placement; any
        backlogged trials (stranded by earlier removals) dispatch to it."""
        worker.bus = self.bus
        if self._bound is not None:
            worker.bind(*self._bound)
        self.workers.append(worker)
        if self.bus.enabled:
            caps = worker.capabilities()
            self.bus.emit(WorkerJoined(
                worker=worker_label(worker), worker_kind=caps.kind,
                capacity=caps.capacity, speed_factor=caps.speed_factor))
        self._stall_t0 = None
        backlog, self._backlog = self._backlog, []
        for p, epochs in backlog:
            self._dispatch(p, epochs)

    def remove_worker(self, worker: Worker, drain: bool = False,
                      reason: str = "retired") -> None:
        """Retire `worker`. ``drain=True`` first waits (bounded) for its
        in-flight trials to finish, collecting their completions; anything
        still unfinished — and everything, when not draining — is re-placed
        onto the surviving workers (or backlogged until one joins). Sticky
        bindings to the worker are dropped, so resumed trials re-place
        freely. ``reason`` labels the retirement in the event stream
        (leave / heartbeat / worker_lost / roster / drain / retired)."""
        if worker not in self.workers:
            return
        if drain:
            deadline = time.monotonic() + self.drain_timeout_s
            try:
                while worker.outstanding and time.monotonic() < deadline:
                    self._absorb(worker, worker.poll(timeout=0.05),
                                 self._drained)
            except Exception:       # noqa: BLE001 — a dying worker mid-drain
                pass                # falls through to re-placement
            if worker not in self.workers:
                return              # died mid-drain: _absorb already
        self.workers.remove(worker)  # retired it and re-placed its trials
        for tid, w in list(self._bindings.items()):
            if w is worker:
                del self._bindings[tid]
        orphans = [tid for tid, w in self._inflight_worker.items()
                   if w is worker]
        src = worker_label(worker) if self.bus.enabled else ""
        if self.bus.enabled:
            self.bus.emit(WorkerRetired(worker=src, reason=reason,
                                        inflight=len(orphans)))
        try:
            worker.close()
        except Exception:           # noqa: BLE001 — already-dead transport
            pass
        for tid in orphans:
            p, epochs = self._inflight.pop(tid)
            del self._inflight_worker[tid]
            self._dispatch(p, epochs)
            if self.bus.enabled:
                dst = self._inflight_worker.get(tid)    # None: backlogged
                self.bus.emit(Resharded(
                    trial_id=tid, src=src,
                    dst=worker_label(dst) if dst is not None else ""))

    # ---------------------------------------------------------- drive loops
    def run_wave(self, runner, workload: str,
                 proposals: Sequence[TrialProposal]
                 ) -> List[Tuple[TrialProposal, float]]:
        """Barrier semantics: execute a wave, merge results in wave order
        regardless of completion order (scheduler decisions never depend on
        scheduling noise)."""
        self.bind(runner, workload)
        self._maintain()                # pick up joins/leaves between waves
        self._apply_wave_clones(proposals)
        self._dispatch_wave([(p, p.epochs) for p in proposals])
        want = {p.trial_id for p in proposals}
        done: Dict[str, TrialCompletion] = {}
        while want - done.keys():
            for c in self._poll_once(block=True):
                done[c.trial_id] = c
        return [(p, done[p.trial_id].score) for p in proposals]

    def drive(self, runner, workload: str, scheduler) -> None:
        """Event-driven ask/tell loop: proposals dispatch the moment the
        scheduler releases them; every completion is reported as it lands
        (at its simulated completion time on engine workers). Ends when the
        scheduler has nothing outstanding and releases no further work."""
        self.bind(runner, workload)
        outstanding: set = set()
        while True:
            wave = scheduler.suggest()
            if wave:
                self._maintain()
                self._apply_wave_clones(wave)
                self._dispatch_wave([(p, p.epochs) for p in wave])
                outstanding.update(p.trial_id for p in wave)
                continue
            if not outstanding:
                break
            completions = self._poll_once(block=True)
            while not completions:
                completions = self._poll_once(block=True)
            for c in completions:
                outstanding.discard(c.trial_id)
                scheduler.report(c.trial_id, c.score)

    def close(self) -> None:
        for w in self.workers:
            w.close()

    def _maintain(self) -> None:
        if self.maintenance is not None:
            self.maintenance()

    # ------------------------------------------------------------ internals
    def _dispatch(self, p: TrialProposal, epochs: Optional[int]) -> None:
        epochs = p.epochs if epochs is None else epochs
        if not self.workers:
            self._backlog.append((p, epochs))   # held until a worker joins
            return
        w = self.place(p)
        w.submit(p, epochs)
        self._record_dispatch(w, p, epochs)

    def _record_dispatch(self, w: Worker, p: TrialProposal,
                         epochs: int) -> None:
        self._inflight[p.trial_id] = (p, epochs)
        self._inflight_worker[p.trial_id] = w
        self.dispatched[id(w)] = self.dispatched.get(id(w), 0) + 1
        self._stall_t0 = None
        if self.bus.enabled:
            self.bus.emit(TrialDispatched(trial_id=p.trial_id,
                                          worker=worker_label(w),
                                          epochs=epochs))

    def _dispatch_wave(self, proposals: Sequence[
            Tuple[TrialProposal, Optional[int]]]) -> None:
        """Dispatch a wave with one ``submit_many`` per worker.

        Placement happens sequentially *before* any submit, with an
        ``extra`` pending count standing in for the per-submit
        ``outstanding`` increments the one-at-a-time path would have
        observed — so which worker gets which trial is exactly what
        ``_dispatch`` in a loop would have chosen (sticky placement
        already accounts for earlier picks through ``_bindings``)."""
        extra: Dict[int, int] = {}
        batches: Dict[int, Tuple[Worker,
                                 List[Tuple[TrialProposal, int]]]] = {}
        for p, epochs in proposals:
            epochs = p.epochs if epochs is None else epochs
            if not self.workers:
                self._backlog.append((p, epochs))
                continue
            if self.sticky:
                w = self.place(p)       # bindings track in-wave picks
            else:
                w = min(self.workers,
                        key=lambda w_: (w_.outstanding +
                                        extra.get(id(w_), 0)) /
                        self._weight(w_))
            extra[id(w)] = extra.get(id(w), 0) + 1
            batches.setdefault(id(w), (w, []))[1].append((p, epochs))
        for w, items in batches.values():   # insertion = first-pick order
            submit_many = getattr(w, "submit_many", None)
            if submit_many is not None:
                submit_many(items)
            else:                   # duck-typed Worker without the batch op
                for p, epochs in items:
                    w.submit(p, epochs=epochs)
            for p, epochs in items:
                self._record_dispatch(w, p, epochs)

    def _apply_wave_clones(self, proposals: Sequence[TrialProposal]) -> None:
        # clone sources must be wave-boundary snapshots, so apply for the
        # whole wave before any of it starts executing
        for p in proposals:
            if p.clone_from is not None:
                self.place(p).clone(p.trial_id, p.clone_from)

    def _absorb(self, worker: Worker, completions: List[TrialCompletion],
                out: List[TrialCompletion]) -> None:
        """File one worker's poll batch: successes clear their in-flight
        entry; a transport-death error retires the worker (when enabled) and
        re-places its remaining trials instead of surfacing; any other error
        is filed too, and ``_poll_once`` raises it. Successes are filed
        first so a batch that completed trials *before* dying doesn't re-run
        them."""
        errors = [c for c in completions if c.error is not None]
        for c in completions:
            if c.error is None:
                self._inflight.pop(c.trial_id, None)
                self._inflight_worker.pop(c.trial_id, None)
                out.append(c)
                if self.bus.enabled:
                    self.bus.emit(TrialCompleted(trial_id=c.trial_id,
                                                 worker=worker_label(worker),
                                                 score=c.score))
        for c in errors:
            if self.retire_on_error and \
                    getattr(c.error, "worker_lost", False):
                self.remove_worker(worker,      # no-op once removed;
                                   reason="worker_lost")
            else:                               # re-places its trials
                out.append(c)
                if self.bus.enabled:
                    self.bus.emit(TrialCompleted(
                        trial_id=c.trial_id, worker=worker_label(worker),
                        score=c.score, error=str(c.error)))

    def _poll_once(self, block: bool) -> List[TrialCompletion]:
        out, self._drained = self._drained, []
        for w in list(self.workers):
            self._absorb(w, w.poll(), out)
        if not out and block:
            # sync the roster even while workers are busy: a hung-but-
            # connected worker never errors its transport, so the only way
            # its trials get re-placed is the coordinator pruning it
            self._maintain()
            busy = [w for w in self.workers if w.outstanding]
            if not busy:
                self._stalled()
                return out
            # rotate which busy worker eats the blocking poll, so a
            # straggling first worker can't starve completions already
            # sitting in its peers' queues
            start = self._poll_rr % len(busy)
            self._poll_rr += 1
            for i in range(len(busy)):
                w = busy[(start + i) % len(busy)]
                self._absorb(w, w.poll(timeout=0.05), out)
                if out:
                    break
        for c in out:
            if c.error is not None:
                raise c.error
        return out

    def _stalled(self) -> None:
        """No worker has work in flight but trials are owed. For an elastic
        pool (maintenance hook set) with trials backlogged this means
        'waiting for a worker to join': sync the roster and give it
        ``join_timeout_s``. Anything else is a real stall."""
        if self.maintenance is not None and (self._backlog or self._inflight):
            if self._stall_t0 is None:
                self._stall_t0 = time.monotonic()
            if time.monotonic() - self._stall_t0 > self.join_timeout_s:
                raise RuntimeError(
                    f"no worker joined the pool within "
                    f"{self.join_timeout_s:.0f}s with "
                    f"{len(self._backlog) + len(self._inflight)} trial(s) "
                    "owed — is the coordinator reachable and are workers "
                    "announcing to it?")
            time.sleep(0.05)
            self._maintain()
            return
        raise RuntimeError(
            "worker pool stalled: trials outstanding but no worker "
            "reports work in flight")


class WorkerPoolExecutor:
    """Executor over an explicit worker list — the composition point for
    remote workers and local shards (``--workers tcp://H1:P1,sim``):
    ``RemoteWorker``s, ``InprocWorker`` shards pinned to backends,
    ``ThreadWorker`` lanes, or any ``Worker``.

    Placement is sticky (see ``WorkerPool``): trials land on the
    least-loaded worker (weighted by declared capacity x speed factor) at
    first sight and stay there across rung resumes; clones follow their
    source. Results merge in wave order, so with deterministic workers a
    single-worker pool gives the serial executor's results.

    The pool is elastic: ``add_worker``/``remove_worker`` reshape it
    mid-job (``repro_torch.service.coordinator.ElasticWorkerPoolExecutor``
    drives them from a live worker roster).
    """

    def __init__(self, workers: Sequence[Worker], sticky: bool = True,
                 allow_empty: bool = False):
        self.pool = WorkerPool(workers, sticky=sticky,
                               allow_empty=allow_empty)
        self.workers = self.pool.workers
        self._runner_spec: Optional[dict] = None

    @property
    def parallelism(self) -> int:
        return sum(max(1, w.capabilities().capacity) for w in self.workers)

    def add_worker(self, worker: Worker) -> None:
        self.pool.add_worker(worker)

    def remove_worker(self, worker: Worker, drain: bool = False) -> None:
        self.pool.remove_worker(worker, drain=drain)

    def attach_bus(self, bus) -> None:
        """Route this executor's telemetry through `bus` (an
        ``repro_torch.obs.events.EventBus``) instead of the process
        default. Propagates to current workers; late joiners pick it up
        from the pool."""
        self.pool.bus = bus
        for w in self.workers:
            w.bus = bus

    def enable_trace(self, trace_id: Optional[str] = None,
                     collector: Optional[str] = None) -> str:
        raise NotImplementedError(
            "distributed tracing is not ported yet: ROADMAP queue A, item "
            "13 (Observability and chaos)")

    def configure_runner_spec(self, spec: Optional[dict]) -> None:
        """Hand workers that mirror the runner remotely the recipe for
        building it (``Experiment`` calls this with its tuner/backend
        names); workers constructed with an explicit spec keep theirs.
        Remote workers left without any spec are a hard error — they would
        silently run their process's own default tuner/backend and merge
        wrong scores."""
        self._runner_spec = dict(spec) if spec else spec  # for late joiners
        needy = [w for w in self.workers
                 if getattr(w, "accepts_runner_spec", False) and
                 w.runner_spec is None]
        if spec:
            store = spec.get("store") or ""
            store_host = store[len("tcp://"):].rsplit(":", 1)[0] \
                if store.startswith("tcp://") else ""
            loopback = ("127.0.0.1", "localhost", "::1")
            for w in needy:
                if store_host in loopback and \
                        getattr(w, "address", ("",))[0] not in loopback:
                    raise ValueError(
                        f"the ground-truth store is dialed at {store!r} "
                        f"(loopback), which remote worker "
                        f"{w.address[0]}:{w.address[1]} cannot reach — "
                        "point --store at an address routable from the "
                        "workers")
                w.runner_spec = dict(spec)
        elif needy:
            raise ValueError(
                "remote workers need a runner spec (tuner/backend registry "
                "names) to mirror the experiment's runner, and none could "
                "be derived: the experiment's tuner, backend, or sys_space "
                "is an instance, or its ground-truth store is not reachable "
                "over TCP — none of which can travel over the wire. "
                "Configure tuner/backend by registry name, share state via "
                "a TCP store (--store tcp://HOST:PORT of a running "
                "`python -m repro_torch.service`), or build RemoteWorker(..., "
                "runner_spec=...) explicitly (runner_spec={} opts into the "
                "worker process's own CLI defaults).")

    def run_wave(self, runner, workload: str,
                 proposals: Sequence[TrialProposal]
                 ) -> List[Tuple[TrialProposal, float]]:
        return self.pool.run_wave(runner, workload, proposals)

    def close(self) -> None:
        self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
