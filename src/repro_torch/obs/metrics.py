"""Scrapeable metrics + live event tailing over the existing RPC framing:
the counterpart of ``repro.obs.metrics``, with its ops, text format and
default prefix, so a scraper reads either package's endpoint alike.

``ObsService`` serves one ``EventBus`` through the same length-prefixed
JSON protocol every other repro service speaks (``JsonRPCServer``):

    metrics {}            -> {ok, text}: Prometheus-style counters/gauges
    counters {}           -> {ok, counters, seq}: the raw numbers
    tail {cursor, limit}  -> {ok, events, cursor}: ring records past cursor

Gauges are *derived* from the event stream (live workers = joined -
retired, trials in flight = dispatched - completed), so the endpoint needs
no extra bookkeeping on any hot path. ``python -m repro_torch.obs tail
tcp://HOST:PORT`` is the terminal client; anything that can speak the
framing (or just hit ``metrics`` and split lines) can scrape it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.obs.events import EventBus, get_bus
from repro_torch.service.transport import (JsonRPCServer, SocketTransport,
                                     TransportError)

__all__ = ["render_metrics", "ObsService", "ObsServer", "ObsClient",
           "ObsUnreachable", "serve_obs"]


class ObsUnreachable(RuntimeError):
    """The obs endpoint stayed unreachable through every retry."""


def render_metrics(bus: EventBus, prefix: str = "repro") -> str:
    """The bus's counters + derived gauges in Prometheus text exposition
    format (one family of per-kind counters, plus the two gauges every
    elastic-path dashboard starts from)."""
    with bus._lock:
        counters = dict(bus.counters)
        seq = bus._seq
    get = counters.get
    lines = [
        f"# HELP {prefix}_events_total telemetry records emitted",
        f"# TYPE {prefix}_events_total counter",
        f"{prefix}_events_total {seq}",
        f"# HELP {prefix}_events telemetry records by kind",
        f"# TYPE {prefix}_events counter",
    ]
    for kind in sorted(counters):
        lines.append(f'{prefix}_events{{kind="{kind}"}} {counters[kind]}')
    workers = get("worker_joined", 0) - get("worker_retired", 0)
    inflight = get("trial_dispatched", 0) - get("trial_completed", 0)
    lines += [
        f"# HELP {prefix}_workers_live workers joined minus retired",
        f"# TYPE {prefix}_workers_live gauge",
        f"{prefix}_workers_live {workers}",
        f"# HELP {prefix}_trials_inflight trials dispatched minus completed",
        f"# TYPE {prefix}_trials_inflight gauge",
        f"{prefix}_trials_inflight {inflight}",
        f"# HELP {prefix}_heartbeats_missed coordinator TTL prunes",
        f"# TYPE {prefix}_heartbeats_missed counter",
        f"{prefix}_heartbeats_missed {get('heartbeat_missed', 0)}",
    ]
    return "\n".join(lines) + "\n"


class ObsService:
    """Request handler of the observability endpoint (transport-agnostic,
    like every other repro service): dicts in, dicts out, every response
    carrying ``ok``. Construction enables the bus — attaching an observer
    is what turns emission on."""

    def __init__(self, bus: Optional[EventBus] = None):
        self.bus = (bus if bus is not None else get_bus()).enable()

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = str(req.get("op", ""))
        fn = getattr(self, f"_op_{op}", None)
        if fn is None or op.startswith("_"):
            return {"ok": False, "error": f"unknown op {op!r}"}
        try:
            out = fn(req) or {}
        except Exception as e:                          # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out["ok"] = True
        return out

    def _op_metrics(self, req) -> Dict[str, Any]:
        return {"text": render_metrics(self.bus)}

    def _op_counters(self, req) -> Dict[str, Any]:
        with self.bus._lock:
            return {"counters": dict(self.bus.counters), "seq": self.bus._seq}

    def _op_tail(self, req) -> Dict[str, Any]:
        cursor = int(req.get("cursor", 0))
        limit = max(1, min(int(req.get("limit", 256)), 4096))
        events = self.bus.events_since(cursor, limit=limit)
        return {"events": events,
                "cursor": events[-1]["seq"] if events else cursor}


class ObsServer(JsonRPCServer):
    """Serve one ``ObsService``. Port 0 binds an ephemeral port."""

    def __init__(self, address: Tuple[str, int], service: ObsService):
        super().__init__(address, service.handle)
        self.service = service


def serve_obs(bus: Optional[EventBus] = None, host: str = "127.0.0.1",
              port: int = 7081, background: bool = False) -> ObsServer:
    """Run an observability endpoint over `bus` (default: the process
    bus); ``background=True`` serves from a daemon thread and returns
    immediately (the normal mode — the run being observed owns the main
    thread)."""
    server = ObsServer((host, port), ObsService(bus))
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    else:
        server.serve_forever()
    return server


class ObsClient:
    """Client of an ``ObsServer``: scrape metrics text, tail events.

    Connection is lazy and self-healing: each request (re)dials on demand
    and retries refused/reset connections with bounded exponential backoff
    — ``python -m repro_torch.obs tail`` started a beat before the run
    opens its endpoint just waits it out, and an endpoint restart costs
    one retried call. ``ObsUnreachable`` is raised only once the retry
    budget is spent."""

    def __init__(self, address: str, timeout: float = 10.0,
                 wire: str = "auto", connect_retries: int = 5,
                 retry_backoff_s: float = 0.25):
        from repro_torch.service.dispatch import parse_tcp_address
        self.address = parse_tcp_address(address)
        self._timeout = timeout
        self._wire = wire
        self._retries = max(0, int(connect_retries))
        self._backoff_s = retry_backoff_s
        self.transport: Optional[SocketTransport] = None
        self.cursor = 0

    def _request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        delay = self._backoff_s
        resp = None
        for attempt in range(self._retries + 1):
            try:
                if self.transport is None:
                    self.transport = SocketTransport(
                        *self.address, timeout=self._timeout,
                        connect_retries=1, wire=self._wire)
                resp = self.transport.request(req)
                break
            except (TransportError, ConnectionError, OSError) as e:
                self.close()
                if attempt == self._retries:
                    raise ObsUnreachable(
                        f"obs endpoint tcp://{self.address[0]}:"
                        f"{self.address[1]} unreachable after "
                        f"{self._retries + 1} attempt(s): {e}") from e
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
        if not resp.get("ok"):
            raise RuntimeError(
                f"obs endpoint rejected {req.get('op')!r}: "
                f"{resp.get('error', 'unknown error')}")
        return resp

    def metrics(self) -> str:
        return self._request({"op": "metrics"})["text"]

    def counters(self) -> Dict[str, int]:
        return self._request({"op": "counters"})["counters"]

    def tail(self, limit: int = 256):
        """Events past this client's cursor (advances it)."""
        resp = self._request({"op": "tail", "cursor": self.cursor,
                              "limit": limit})
        self.cursor = resp["cursor"]
        return resp["events"]

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()
            self.transport = None
