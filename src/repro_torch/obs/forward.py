"""Cross-process trace propagation + event forwarding: the counterpart of
``repro.obs.forward``. Its ops and records are the reference's, so a
``ForwardingSink`` of either package ships to a ``TraceCollector`` of the
other.

A distributed tuning run spans the driver, ``repro_torch.worker`` subprocesses,
the coordinator, and the store service — each with its own process-local
``EventBus``. This module merges them into ONE causal stream:

* ``propagate_trace(transport, trace_id, ...)`` — client side of the
  ``obs_trace`` hello. Sent once per traced peer, it carries the trace id,
  the label the client already uses for that peer (the join key between
  both streams), and optionally the driver's collector address. Like the
  ``_wire`` codec hello, the peer must *echo* the trace id back — a legacy
  peer that errors the unknown op, or a generic ``{"ok": true}`` responder,
  leaves the connection untraced and everything still works. The
  request/response timestamps double as one NTP-style sample: the peer's
  wall-clock offset is estimated at the round-trip midpoint and emitted as
  a ``ClockSync`` event so the merge can undo cross-host clock skew.

* ``adopt_trace(req, bus)`` — server side. Stamps the peer-assigned trace
  id + proc label onto the local bus and, when the hello names a
  collector, attaches a ``ForwardingSink`` so local events ship home.

* ``ForwardingSink`` — a bus sink that enqueues records onto a bounded
  deque and ships them in batches from a daemon thread over the normal
  RPC framing (``obs_events`` op). The hot path pays one append; when the
  queue overflows the *oldest* records are shed and counted, and a send
  failure sheds the batch — telemetry never blocks or breaks the run.

* ``TraceCollector`` — the driver-side receiving endpoint: a
  ``JsonRPCServer`` whose ``obs_events`` handler folds forwarded records
  into the driver's bus via ``EventBus.ingest`` (remote ``seq`` preserved
  as ``rseq``), so one ``--trace`` JSONL file and one live ``tail`` show
  the whole cluster.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.events import ClockSync, EventBus, ForwardDropped

__all__ = ["ForwardingSink", "TraceCollector", "start_collector",
           "adopt_trace", "propagate_trace"]


class ForwardingSink:
    """Ship bus records to a ``TraceCollector`` without ever blocking the
    emitting hot path.

    ``__call__`` (the sink interface) appends to a bounded deque and wakes
    the flusher; when the deque is full the oldest record is dropped and
    counted (the collector turns the running count into ``ForwardDropped``
    events). One daemon thread drains the queue in batches over a lazily
    dialed ``SocketTransport``; any send failure sheds that batch, backs
    off, and redials — a dead collector degrades tracing, never the run.
    """

    def __init__(self, collector: str, proc: str = "",
                 maxlen: int = 4096, batch: int = 512,
                 flush_interval_s: float = 0.2, timeout: float = 5.0):
        self.collector = collector
        self.proc = proc
        self.batch = batch
        self.flush_interval_s = flush_interval_s
        self.timeout = timeout
        self.dropped_total = 0
        self._unreported_drops = 0
        self._queue: "deque[Dict[str, Any]]" = deque()
        self._maxlen = maxlen
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._transport = None
        self._backoff_until = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-forward")
        self._thread.start()

    # ---------------------------------------------------------- sink side
    def __call__(self, rec: Dict[str, Any]) -> None:
        if self._closed.is_set():
            return
        with self._lock:
            if len(self._queue) >= self._maxlen:
                self._queue.popleft()
                self.dropped_total += 1
                self._unreported_drops += 1
            self._queue.append(rec)
            n = len(self._queue)
            if self._idle.is_set():     # is_set is lock-free; clear isn't
                self._idle.clear()
        # wake the flusher only on a full batch: waking per record turns
        # every emit into a one-record TCP round trip that contends with
        # the emitting hot path; a partial batch ships on the next
        # ``flush_interval_s`` tick instead
        if n >= self.batch:
            self._wake.set()

    # -------------------------------------------------------- flusher side
    def _drain(self) -> Tuple[list, int]:
        with self._lock:
            n = min(len(self._queue), self.batch)
            batch = [self._queue.popleft() for _ in range(n)]
            drops, self._unreported_drops = self._unreported_drops, 0
            if not self._queue:
                self._wake.clear()
        return batch, drops

    def _send(self, batch: list, drops: int) -> bool:
        from repro_torch.service.codec import CodecError
        from repro_torch.service.dispatch import parse_tcp_address
        from repro_torch.service.transport import (SocketTransport,
                                                   TransportError)
        if time.monotonic() < self._backoff_until:
            return False
        try:
            if self._transport is None:
                host, port = parse_tcp_address(self.collector)
                self._transport = SocketTransport(
                    host, port, timeout=self.timeout, connect_retries=1)
            resp = self._transport.request(
                {"op": "obs_events", "proc": self.proc,
                 "events": batch, "dropped": drops})
            return bool(resp.get("ok"))
        except (OSError, TransportError, CodecError):
            # dial/wire/encode failure: shed and back off — anything else
            # (a programming error) must surface, not vanish with the batch
            try:
                if self._transport is not None:
                    self._transport.close()
            except OSError:
                pass
            self._transport = None
            self._backoff_until = time.monotonic() + 1.0
            return False

    def _flush_once(self) -> None:
        batch, drops = self._drain()
        if (batch or drops) and not self._send(batch, drops):
            # shed the batch (requeueing would reorder and grow without
            # bound against a dead collector) but keep the receipt
            with self._lock:
                self.dropped_total += len(batch)
                self._unreported_drops += len(batch) + drops
        with self._lock:
            if not self._queue and not self._unreported_drops:
                self._idle.set()

    def _run(self) -> None:
        while not self._closed.is_set():
            self._wake.wait(timeout=self.flush_interval_s)
            self._flush_once()
        self._flush_once()                      # final drain on close

    def kick(self) -> None:
        """Non-blocking nudge: ship whatever is queued on the flusher's
        next scheduling slice instead of waiting out the interval tick.
        Services call this at request boundaries (end of a ``run`` /
        ``run_many`` wave) so a short-lived worker's events reach the
        collector before the driver moves on — without reintroducing the
        per-emit wakeups the batching exists to avoid."""
        if not self._idle.is_set():
            self._wake.set()

    # ------------------------------------------------------------ lifecycle
    def flush(self, timeout: float = 2.0) -> bool:
        """Block until the queue has fully shipped (or been shed); True if
        it drained within ``timeout``."""
        self._wake.set()
        return self._idle.wait(timeout=timeout)

    def close(self, timeout: float = 2.0) -> None:
        if self._closed.is_set():
            return
        self.flush(timeout=timeout)
        self._closed.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._transport is not None:
            try:
                self._transport.close()
            except Exception:                   # noqa: BLE001
                pass
            self._transport = None


class TraceCollector:
    """The driver-side endpoint remote ``ForwardingSink``s ship to.

    Hosts one op over the shared RPC framing:

        obs_events {proc, events: [rec...], dropped: N}
            -> {ok, n}   (records folded into the bus via ``ingest``)

    Forwarded records keep their remote stamps (``ts``/``mono``/``trace``/
    ``proc``; remote ``seq`` becomes ``rseq``) and gain a fresh local
    ``seq``, so the driver's trace file, ring, and counters see the whole
    cluster in one totally-ordered stream.
    """

    def __init__(self, bus: EventBus, host: str = "127.0.0.1",
                 port: int = 0):
        from repro_torch.service.transport import JsonRPCServer
        self.bus = bus.enable()
        self._server = JsonRPCServer((host, port), self.handle)
        self.host, self.port = self._server.server_address[:2]
        # mark the bus as this collector's home so a service in the SAME
        # process (sharing the bus) never forwards back to it — that loop
        # re-ingests every record it ships, amplifying without bound
        bus.local_collectors.add(f"tcp://{self.host}:{self.port}")
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="obs-collector")
        self._thread.start()

    @property
    def address(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = str(req.get("op", ""))
        if op != "obs_events":
            return {"ok": False, "error": f"unknown op {op!r}"}
        events = req.get("events") or []
        for rec in events:
            if isinstance(rec, dict):
                self.bus.ingest(rec)
        dropped = int(req.get("dropped", 0) or 0)
        if dropped:
            self.bus.emit(ForwardDropped(proc=str(req.get("proc", "")),
                                         dropped=dropped))
        return {"ok": True, "n": len(events)}

    def close(self, drain_s: float = 0.75) -> None:
        """Shut the endpoint down after a short quiesce: remote flushers
        ship within milliseconds of emit, so waiting for the bus to go
        still (bounded by ``drain_s``) catches the tail of a finished run
        without ever stalling teardown."""
        deadline = time.monotonic() + max(0.0, drain_s)
        last = self.bus.seq
        while time.monotonic() < deadline:
            time.sleep(0.05)
            if self.bus.seq == last:
                break
            last = self.bus.seq
        self._server.shutdown()


def start_collector(bus: EventBus, host: str = "127.0.0.1",
                    port: int = 0) -> TraceCollector:
    """Spin up a ``TraceCollector`` over ``bus`` on an ephemeral port."""
    return TraceCollector(bus, host=host, port=port)


def adopt_trace(req: Dict[str, Any], bus: EventBus,
                proc: Optional[str] = None) -> Dict[str, Any]:
    """Server side of the ``obs_trace`` hello: adopt the peer-assigned
    trace context onto ``bus`` and start forwarding if a collector is
    named. Returns the response fields — crucially echoing the trace id,
    which is what distinguishes a trace-aware peer from a legacy service
    answering a generic ``{"ok": true}``. Idempotent: a second hello with
    the same collector reuses the existing forwarder (the store hears the
    hello from the driver *and* from every worker's store client)."""
    trace_id = str(req.get("trace") or "")
    if not trace_id:
        raise ValueError("obs_trace without a trace id")
    bus.trace_id = trace_id
    label = proc if proc is not None else str(req.get("proc") or "")
    if label and not bus.proc:
        # first label wins: an in-process service sharing the driver's bus
        # must not relabel the driver's own events
        bus.proc = label
    collector = req.get("collector")
    if collector and str(collector) in bus.local_collectors:
        collector = None        # the collector ingests into this very bus:
                                # forwarding would loop records back forever
    if collector:
        prev = bus.forward_sink
        if prev is not None and prev.collector == collector:
            pass                                # already forwarding there
        else:
            if prev is not None:
                bus.remove_sink(prev)
                prev.close(timeout=0.5)
            sink = ForwardingSink(str(collector), proc=bus.proc or label)
            bus.add_sink(sink)                  # enables the bus
            bus.forward_sink = sink
    else:
        bus.enable()
    return {"trace": trace_id, "server_ts": time.time(),
            "server_mono": time.monotonic()}


def propagate_trace(transport, trace_id: str, *, collector: Optional[str]
                    = None, proc: str = "", bus: Optional[EventBus] = None,
                    ) -> bool:
    """Client side of the ``obs_trace`` hello. Returns True iff the peer
    echoed the trace id (trace-aware); False means a legacy peer — the
    connection simply stays untraced. On success the transport starts
    stamping ``_trace`` metadata on every request, and the round-trip
    yields one NTP-style clock sample: offset = peer wall clock at the
    midpoint minus ours, emitted as ``ClockSync`` for the merge to apply.
    """
    from repro_torch.service.codec import CodecError
    from repro_torch.service.transport import TransportError
    req: Dict[str, Any] = {"op": "obs_trace", "trace": trace_id,
                           "proc": proc}
    if collector:
        req["collector"] = collector
    t0 = time.time()
    try:
        resp = transport.request(req)
    except (OSError, TransportError, CodecError):
        return False                            # legacy / unreachable peer
    t1 = time.time()
    if not isinstance(resp, dict) or not resp.get("ok") \
            or resp.get("trace") != trace_id:
        return False
    try:
        transport.trace = trace_id
    except AttributeError:
        pass
    server_ts = resp.get("server_ts")
    if bus is not None and bus.enabled and server_ts is not None:
        offset = float(server_ts) - (t0 + t1) / 2.0
        bus.emit(ClockSync(proc=proc, offset_s=offset, rtt_s=t1 - t0))
    return True
