"""Typed telemetry events + the process-local ``EventBus``: a copy of
``repro.obs.events``.

The live elastic path (worker pools, coordinator, store service) and the
simulated cluster engine emit the *same* small vocabulary of structured,
timestamped records:

    TrialDispatched   a proposal handed to a worker / sim node
    TrialCompleted    a completion absorbed by the pool (score or error)
    EpochCompleted    one epoch finished (remote workers report them from
                      the returned record; the engine at simulated time)
    WorkerJoined      pool/roster/engine membership grew
    WorkerRetired     membership shrank (reason: leave / heartbeat /
                      worker_lost / roster / retired / drain)
    HeartbeatMissed   the coordinator pruned a silent worker (carries the
                      heartbeat age that killed it)
    Resharded         an in-flight or bound trial moved to another worker
    StoreRefit        the ground-truth store re-clustered (version bump)
    TrialStarted      execution began on a worker (traced runs, worker-side)
    RpcCompleted      one wire round-trip, measured client-side
    ClockSync         per-peer wall-clock offset estimate (trace handshake)
    ForwardDropped    a remote forwarding queue shed records (overflow)

Emission is **off by default and near-free when off**: hot paths guard on
``bus.enabled`` (one attribute read) and only then construct the event, so
the no-fault fast path — the ``store_service`` / ``elastic`` benches — pays
nothing measurable. Enabling happens implicitly when a sink subscribes
(``add_sink``) or an observer attaches (``enable()``; the metrics endpoint
does this), which also starts the in-memory ring the ``tail`` op reads.

This module is stdlib-only on purpose: ``repro_torch.core.worker`` and
``repro_torch.cluster.engine`` import it, so it must sit below everything
else. The sinks, metrics, trace, forwarding and chaos modules of
``repro_torch.obs`` read these events.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, ClassVar, Dict, List, Optional, Tuple

__all__ = ["Event", "TrialDispatched", "TrialStarted", "TrialCompleted",
           "EpochCompleted", "WorkerJoined", "WorkerRetired",
           "HeartbeatMissed", "Resharded", "StoreRefit", "RpcCompleted",
           "ClockSync", "ForwardDropped", "EventBus", "EVENT_TYPES",
           "event_from_dict", "new_trace_id", "DEFAULT_BUS", "get_bus",
           "set_bus", "worker_label"]


@dataclasses.dataclass(frozen=True)
class Event:
    """Base of every telemetry record. ``kind`` is the wire name; ``ts``
    (wall-clock seconds) and ``seq`` (per-bus monotonic) are stamped by the
    bus at emit, not carried here — see ``EventBus.emit``."""

    kind: ClassVar[str] = "event"

    def to_fields(self) -> Dict[str, Any]:
        # every event is a flat record of scalars, so a __dict__ copy is
        # exact — and ~8x cheaper than dataclasses.asdict's deep recursion,
        # which matters on traced hot paths (one emit per RPC receipt)
        return dict(self.__dict__)


@dataclasses.dataclass(frozen=True)
class TrialDispatched(Event):
    kind: ClassVar[str] = "trial_dispatched"
    trial_id: str
    worker: str
    epochs: int = 0
    at_s: Optional[float] = None        # simulated time (engine emitters)


@dataclasses.dataclass(frozen=True)
class TrialStarted(Event):
    """Execution actually began on a worker (emitted worker-side in traced
    distributed runs; the gap back to ``trial_dispatched`` is queue wait +
    one-way RPC)."""

    kind: ClassVar[str] = "trial_started"
    trial_id: str
    worker: str
    epochs: int = 0                     # budget this run was asked for


@dataclasses.dataclass(frozen=True)
class TrialCompleted(Event):
    kind: ClassVar[str] = "trial_completed"
    trial_id: str
    worker: str
    score: float = float("nan")
    error: Optional[str] = None
    at_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EpochCompleted(Event):
    kind: ClassVar[str] = "epoch_completed"
    trial_id: str
    worker: str
    epoch: int = 0                      # index within the trial's record
    duration_s: float = 0.0
    at_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class WorkerJoined(Event):
    kind: ClassVar[str] = "worker_joined"
    worker: str
    worker_kind: str = "worker"
    capacity: int = 1
    speed_factor: float = 1.0
    at_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class WorkerRetired(Event):
    kind: ClassVar[str] = "worker_retired"
    worker: str
    reason: str = "retired"             # leave|heartbeat|worker_lost|roster|
    inflight: int = 0                   # trials re-placed off the worker
    at_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class HeartbeatMissed(Event):
    kind: ClassVar[str] = "heartbeat_missed"
    worker: str
    age_s: float = 0.0                  # heartbeat silence that killed it
    ttl_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class Resharded(Event):
    kind: ClassVar[str] = "resharded"
    trial_id: str
    src: str
    dst: str = ""                       # "" = backlogged until a join
    at_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class StoreRefit(Event):
    kind: ClassVar[str] = "store_refit"
    version: int
    n_entries: int = 0


@dataclasses.dataclass(frozen=True)
class RpcCompleted(Event):
    """One request/response round-trip on the wire, measured client-side.
    ``overhead_s`` is the slice of ``duration_s`` not accounted for by
    remote compute the caller can see (for ``run``/``run_many`` that is
    duration minus the returned epochs' summed durations; for store and
    coordinator ops it equals ``duration_s``)."""

    kind: ClassVar[str] = "rpc_completed"
    op: str
    peer: str
    duration_s: float = 0.0
    overhead_s: float = 0.0
    n: int = 1                          # sub-requests (batched ops)


@dataclasses.dataclass(frozen=True)
class ClockSync(Event):
    """NTP-style offset estimate for a traced peer: ``offset_s`` is how far
    the peer's wall clock runs *ahead* of ours, estimated at the trace
    handshake midpoint; merge subtracts it from that peer's ``ts``."""

    kind: ClassVar[str] = "clock_sync"
    proc: str
    offset_s: float = 0.0
    rtt_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class ForwardDropped(Event):
    """A remote forwarding queue overflowed and shed its oldest records
    (the hot path never blocks on telemetry; this is the receipt)."""

    kind: ClassVar[str] = "forward_dropped"
    proc: str
    dropped: int = 0


EVENT_TYPES: Dict[str, type] = {
    cls.kind: cls for cls in (TrialDispatched, TrialStarted, TrialCompleted,
                              EpochCompleted, WorkerJoined, WorkerRetired,
                              HeartbeatMissed, Resharded, StoreRefit,
                              RpcCompleted, ClockSync, ForwardDropped)}


def event_from_dict(rec: Dict[str, Any]) -> Tuple[float, int, Event]:
    """Inverse of the bus's wire encoding: ``(ts, seq, typed event)``.
    Unknown kinds raise ``ValueError`` (a trace from a newer build should
    fail loudly, not decode into the wrong type). Trace metadata the bus
    stamps alongside (``mono``/``trace``/``proc``) is carried in the record
    dict, not the typed event."""
    cls = EVENT_TYPES.get(str(rec.get("kind")))
    if cls is None:
        raise ValueError(f"unknown event kind {rec.get('kind')!r}")
    fields = {f.name: rec[f.name] for f in dataclasses.fields(cls)
              if f.name in rec}
    return float(rec.get("ts", 0.0)), int(rec.get("seq", 0)), cls(**fields)


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (process-unique, collision-safe for
    the handful of concurrent tuning runs a driver hosts)."""
    import uuid
    return uuid.uuid4().hex[:16]


class EventBus:
    """Process-local fan-out of telemetry events.

    * ``add_sink(fn)`` — ``fn(record_dict)`` called at emit (JSONL writer,
      MetricsStore bridge, a test list). Subscribing enables the bus.
    * ``enable()`` — turn emission on without a sink (the metrics endpoint
      reads the ring + counters instead of subscribing).
    * ``emit(event)`` — stamp ``ts``/``seq``, update counters, append to
      the ring, fan out to sinks. A disabled bus returns immediately;
      emitters on hot paths guard with ``if bus.enabled`` so they do not
      even construct the event.
    * ``events_since(cursor)`` — ring tail for live ``tail`` scraping.

    Sinks run under the bus lock (events stay totally ordered); a sink that
    raises is dropped after the first failure rather than poisoning every
    later emit.
    """

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []
        self._recent: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._seq = 0
        self._enabled = False
        self.counters: Dict[str, int] = {}
        # distributed-tracing context: when set, every record is stamped
        # with the trace id and this process's label so cross-process
        # streams merge into one causal timeline (see
        # repro_torch.obs.trace)
        self.trace_id: Optional[str] = None
        self.proc: Optional[str] = None
        # forwarding capability (owned by repro_torch.obs.forward):
        # addresses of collectors that ingest into THIS bus — forwarding
        # to one of them would loop records back forever — and the active
        # outbound sink
        self.local_collectors: set = set()
        self.forward_sink: Optional[Any] = None

    # ------------------------------------------------------------- control
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> "EventBus":
        self._enabled = True
        return self

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            self._sinks.append(sink)
        self._enabled = True

    def remove_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # ---------------------------------------------------------------- emit
    def emit(self, event: Event, ts: Optional[float] = None) -> None:
        if not self._enabled:
            return
        # one dict copy, keys added in place: this runs once per RPC
        # receipt on traced hot paths, so no intermediate dicts
        rec = dict(event.__dict__)
        rec["kind"] = event.kind
        rec["ts"] = time.time() if ts is None else ts
        rec["mono"] = time.monotonic()
        if self.trace_id is not None:
            rec["trace"] = self.trace_id
        if self.proc is not None and not rec.get("proc"):
            # events that NAME a process (ClockSync's synced peer,
            # ForwardDropped's shedding worker) keep their own label; the
            # bus label only fills the gap for everything else
            rec["proc"] = self.proc
        self._admit(rec)

    def ingest(self, rec: Dict[str, Any]) -> None:
        """Adopt a record stamped by a *remote* bus (trace forwarding): the
        sender's ``seq`` is preserved as ``rseq`` (per-proc ordering), a
        fresh local ``seq`` is stamped, and the record flows through the
        same counters/ring/sinks as a local emit — so forwarded events show
        up in live ``tail``/``metrics`` and land in the same trace file."""
        if not self._enabled:
            return
        rec = dict(rec)
        if "seq" in rec:
            rec["rseq"] = rec.pop("seq")
        self._admit(rec)

    def _admit(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            kind = rec.get("kind", "event")
            self.counters[kind] = self.counters.get(kind, 0) + 1
            self._recent.append(rec)
            dead = []
            for sink in self._sinks:
                try:
                    sink(rec)
                except Exception:               # noqa: BLE001 — one bad sink
                    dead.append(sink)           # must not poison the stream
            for sink in dead:
                self._sinks.remove(sink)

    # ---------------------------------------------------------------- read
    @property
    def seq(self) -> int:
        return self._seq

    def events_since(self, cursor: int = 0,
                     limit: int = 1024) -> List[Dict[str, Any]]:
        """Records with ``seq > cursor`` still in the ring, oldest first.
        A cursor older than the ring silently skips to what remains (the
        tailing client sees a gap in ``seq`` and can say so)."""
        with self._lock:
            return [r for r in self._recent if r["seq"] > cursor][:limit]

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """All ring records (optionally one kind), oldest first."""
        with self._lock:
            recs = list(self._recent)
        if kind is not None:
            recs = [r for r in recs if r["kind"] == kind]
        return recs


# The process-local default: inert (``enabled`` False) until an observer
# attaches, so instrumented hot loops cost one attribute read when nobody
# is watching.
DEFAULT_BUS = EventBus()


def get_bus() -> EventBus:
    return DEFAULT_BUS


def set_bus(bus: EventBus) -> EventBus:
    """Replace the process default (tests); returns the previous bus."""
    global DEFAULT_BUS
    prev, DEFAULT_BUS = DEFAULT_BUS, bus
    return prev


def worker_label(worker: Any) -> str:
    """One stable display name per worker, shared by every emitter so the
    event stream correlates: remote workers label as ``tcp://host:port``,
    tagged/named locals by their tag or name, engine nodes as ``node:N``."""
    addr = getattr(worker, "address", None)
    if isinstance(addr, tuple) and len(addr) == 2:
        return f"tcp://{addr[0]}:{addr[1]}"
    for attr in ("tag", "name"):
        val = getattr(worker, attr, None)
        if val:
            return str(val)
    return f"{getattr(worker, 'kind', 'worker')}:{id(worker) & 0xffff:04x}"
