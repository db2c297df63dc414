"""Worker discovery: a coordinator workers announce to, pools read from;
the counterpart of ``repro.service.coordinator``.

``--workers`` froze the remote pool at launch; this module makes it
elastic. One small registry service — the same length-prefixed JSON framing
as the store and trial-worker servers, hosted by ``JsonRPCServer`` — tracks
the live worker roster:

    register  {address, kind, capacity,
               speed_factor}          -> {worker_id, ttl_s}: join the roster
    heartbeat {worker_id}             -> {} (error when unknown: the worker
                                       expired or the coordinator restarted —
                                       the announcer re-registers)
    leave     {worker_id}             -> {} graceful departure
    roster    {}                      -> {workers, version}: live members,
                                       expired entries pruned
    version   {}                      -> {version}: cheap change polling

A worker whose heartbeats stop arriving for ``ttl_s`` is pruned — crashed
workers leave the roster without saying goodbye. ``version`` bumps on every
membership change, so clients ping it instead of re-reading the roster.

The pieces:

* ``CoordinatorService`` / ``CoordinatorTCPServer`` — the server
  (``python -m repro_torch.coordinator``).
* ``WorkerAnnouncer`` — the client a trial worker runs
  (``python -m repro_torch.worker --announce tcp://COORD``): registers,
  heartbeats
  from a daemon thread, re-registers when expired, leaves on shutdown.
* ``CoordinatorClient`` — roster reader (reconnects across coordinator
  restarts).
* ``ElasticWorkerPoolExecutor`` — a ``WorkerPoolExecutor`` whose pool syncs
  the roster between waves and while blocked on completions: joins become
  ``RemoteWorker``s (handed the experiment's runner spec), leaves and missed
  heartbeats retire the worker and re-place its in-flight trials. The
  experiment side is ``--coordinator tcp://HOST:PORT``.

The messages are the reference's, so workers and drivers of either package
share one coordinator. The ``obs_trace`` hello and ``enable_trace`` join
the coordinator's membership events to a driver's distributed trace
(``repro_torch.obs.forward``).
"""
from __future__ import annotations

import argparse
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.worker import Worker, WorkerPoolExecutor
from repro_torch.obs.events import (HeartbeatMissed, WorkerJoined,
                                    WorkerRetired, get_bus)
from repro_torch.service.dispatch import (RemoteWorker, WorkerError,
                                          parse_tcp_address)
from repro_torch.service.transport import (JsonRPCServer, SocketTransport,
                                           TransportError)

__all__ = ["CoordinatorService", "CoordinatorTCPServer", "CoordinatorClient",
           "CoordinatorError", "WorkerAnnouncer", "ElasticWorkerPoolExecutor",
           "serve_coordinator", "main"]


class CoordinatorError(RuntimeError):
    """A coordinator request failed (server error or broken transport)."""


class CoordinatorService:
    """Request handler of the worker registry (transport-agnostic, like
    ``GroundTruthService``): dicts in, dicts out, every response carrying
    ``ok``. ``ttl_s`` bounds how long a silent worker stays listed."""

    def __init__(self, ttl_s: float = 10.0, clock=time.monotonic):
        if ttl_s <= 0:
            raise ValueError("ttl_s must be > 0")
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self.bus = get_bus()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._workers: Dict[str, dict] = {}     # worker_id -> entry
        self._version = 0

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

    # ------------------------------------------------------------------ ops
    def _op_register(self, req) -> Dict[str, Any]:
        address = str(req.get("address", ""))
        if not address.startswith("tcp://"):
            raise ValueError(f"address must be tcp://HOST:PORT, "
                             f"got {address!r}")
        entry = {
            "address": address,
            "kind": str(req.get("kind", "remote")),
            "capacity": int(req.get("capacity", 1)),
            "speed_factor": float(req.get("speed_factor", 1.0)),
        }
        with self._lock:
            self._prune()
            # one roster slot per address: a re-registering (restarted)
            # worker replaces its old entry instead of ghosting next to it
            for wid, old in list(self._workers.items()):
                if old["address"] == address:
                    del self._workers[wid]
            worker_id = f"w-{next(self._ids)}"
            self._workers[worker_id] = {**entry, "last_seen": self._clock()}
            self._version += 1
            if self.bus.enabled:
                self.bus.emit(WorkerJoined(
                    worker=address, worker_kind="roster",
                    capacity=entry["capacity"],
                    speed_factor=entry["speed_factor"]))
            return {"worker_id": worker_id, "ttl_s": self.ttl_s,
                    "version": self._version}

    def _op_heartbeat(self, req) -> Dict[str, Any]:
        worker_id = str(req.get("worker_id", ""))
        with self._lock:
            self._prune()
            entry = self._workers.get(worker_id)
            if entry is None:
                # expired, or the coordinator restarted: tell the worker so
                # its announcer re-registers
                raise KeyError(f"unknown worker {worker_id!r} (re-register)")
            entry["last_seen"] = self._clock()
            return {}

    def _op_leave(self, req) -> Dict[str, Any]:
        worker_id = str(req.get("worker_id", ""))
        with self._lock:
            entry = self._workers.pop(worker_id, None)
            if entry is not None:
                self._version += 1
                if self.bus.enabled:
                    self.bus.emit(WorkerRetired(worker=entry["address"],
                                                reason="leave"))
            return {}

    def _op_roster(self, req) -> Dict[str, Any]:
        with self._lock:
            self._prune()
            return {"version": self._version, "ttl_s": self.ttl_s,
                    "workers": [
                        {"worker_id": wid,
                         **{k: e[k] for k in ("address", "kind", "capacity",
                                              "speed_factor")}}
                        for wid, e in sorted(self._workers.items())]}

    def _op_version(self, req) -> Dict[str, Any]:
        with self._lock:
            self._prune()
            return {"version": self._version}

    def _op_obs_trace(self, req) -> Dict[str, Any]:
        # distributed-tracing hello (repro_torch.obs.forward): membership
        # events (joins, prunes) get tagged + forwarded into the driver's
        # trace
        from repro_torch.obs.forward import adopt_trace
        return adopt_trace(req, self.bus)

    # ------------------------------------------------------------ internals
    def _prune(self) -> None:
        now = self._clock()
        cutoff = now - self.ttl_s
        expired = [wid for wid, e in self._workers.items()
                   if e["last_seen"] < cutoff]
        for wid in expired:
            entry = self._workers.pop(wid)
            if self.bus.enabled:
                self.bus.emit(HeartbeatMissed(
                    worker=entry["address"],
                    age_s=now - entry["last_seen"], ttl_s=self.ttl_s))
                self.bus.emit(WorkerRetired(worker=entry["address"],
                                            reason="heartbeat"))
        if expired:
            self._version += 1


class CoordinatorTCPServer(JsonRPCServer):
    """Serve one ``CoordinatorService``. Port 0 binds an ephemeral port."""

    def __init__(self, address: Tuple[str, int], service: CoordinatorService):
        super().__init__(address, service.handle)
        self.service = service


def serve_coordinator(service: Optional[CoordinatorService] = None,
                      host: str = "127.0.0.1", port: int = 7079,
                      background: bool = False) -> CoordinatorTCPServer:
    """Run a coordinator server; ``background=True`` serves from a daemon
    thread and returns immediately (tests, co-located services)."""
    server = CoordinatorTCPServer((host, port),
                                  service or CoordinatorService())
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    else:
        server.serve_forever()
    return server


class CoordinatorClient:
    """Coordinator protocol over TCP, reconnecting per request on failure —
    a coordinator restart costs one failed call, not the session."""

    def __init__(self, address: str, connect_timeout: float = 10.0,
                 request_timeout: float = 10.0, wire: str = "auto"):
        host, port = parse_tcp_address(address)
        self.address = (host, port)
        self._connect_timeout = connect_timeout
        self._request_timeout = request_timeout
        self._wire = wire
        self._transport: Optional[SocketTransport] = None
        self._trace: Optional[str] = None
        self._lock = threading.Lock()

    def _request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            try:
                if self._transport is None:
                    self._transport = SocketTransport(
                        *self.address, timeout=self._connect_timeout,
                        connect_retries=1,
                        request_timeout=self._request_timeout,
                        wire=self._wire)
                    self._transport.trace = self._trace
                resp = self._transport.request(req)
            except (TransportError, ConnectionError, OSError) as e:
                self._reset_transport()
                raise CoordinatorError(
                    f"coordinator tcp://{self.address[0]}:{self.address[1]} "
                    f"unreachable: {e}") from e
        if not resp.get("ok"):
            raise CoordinatorError(
                f"coordinator rejected {req.get('op')!r}: "
                f"{resp.get('error', 'unknown error')}")
        return resp

    def register(self, address: str, kind: str = "remote", capacity: int = 1,
                 speed_factor: float = 1.0) -> Tuple[str, float]:
        resp = self._request({"op": "register", "address": address,
                              "kind": kind, "capacity": capacity,
                              "speed_factor": speed_factor})
        return resp["worker_id"], float(resp["ttl_s"])

    def heartbeat(self, worker_id: str) -> bool:
        """True when accepted; False when the coordinator no longer knows
        the id (expired/restarted) — re-register."""
        try:
            self._request({"op": "heartbeat", "worker_id": worker_id})
            return True
        except CoordinatorError as e:
            if "unknown worker" in str(e):
                return False
            raise

    def leave(self, worker_id: str) -> None:
        self._request({"op": "leave", "worker_id": worker_id})

    def roster(self) -> List[Dict[str, Any]]:
        return self._request({"op": "roster"})["workers"]

    def version(self) -> int:
        return self._request({"op": "version"})["version"]

    def enable_trace(self, trace_id: str, collector: Optional[str] = None,
                     bus=None) -> bool:
        """Send the ``obs_trace`` hello so the coordinator tags + forwards
        its membership events into this trace. Best-effort and never
        raises: False means the coordinator is away or predates tracing
        (the run proceeds with the driver-side view only). ``_trace``
        request metadata keeps riding across reconnects either way."""
        self._trace = trace_id
        peer = f"coordinator@{self.address[0]}:{self.address[1]}"
        from repro_torch.obs.forward import propagate_trace
        try:
            with self._lock:
                if self._transport is None:
                    self._transport = SocketTransport(
                        *self.address, timeout=self._connect_timeout,
                        connect_retries=1,
                        request_timeout=self._request_timeout,
                        wire=self._wire)
                return propagate_trace(self._transport, trace_id,
                                       collector=collector, proc=peer,
                                       bus=bus)
        except (TransportError, ConnectionError, OSError):
            self.close()
            return False

    def _reset_transport(self) -> None:
        """Drop the cached connection. Caller must hold ``self._lock`` (the
        in-request failure path already does; ``close`` takes it)."""
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    def close(self) -> None:
        with self._lock:
            self._reset_transport()


class WorkerAnnouncer:
    """The trial worker's side of discovery: register, heartbeat from a
    daemon thread at a third of the TTL, re-register when forgotten, leave
    on ``stop``. Transport failures are retried forever — a coordinator
    restart must not kill a healthy worker."""

    def __init__(self, coordinator: str, address: str, kind: str = "remote",
                 capacity: int = 1, speed_factor: float = 1.0):
        self.client = CoordinatorClient(coordinator)
        self.address = address
        self.kind = kind
        self.capacity = capacity
        self.speed_factor = speed_factor
        self.worker_id: Optional[str] = None
        self.ttl_s = 10.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> str:
        """Register (raising if the coordinator is unreachable — a worker
        told to announce should fail loudly when it can't) and start the
        heartbeat thread. Returns the assigned worker id."""
        self.worker_id, self.ttl_s = self._register()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"announce-{self.address}")
        self._thread.start()
        return self.worker_id

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        try:
            if self.worker_id is not None:
                self.client.leave(self.worker_id)
        except CoordinatorError:
            pass                                # it will expire via TTL
        self.client.close()

    # ------------------------------------------------------------ internals
    def _register(self) -> Tuple[str, float]:
        return self.client.register(self.address, kind=self.kind,
                                    capacity=self.capacity,
                                    speed_factor=self.speed_factor)

    def _loop(self) -> None:
        while not self._stop.wait(self.ttl_s / 3.0):
            try:
                if not self.client.heartbeat(self.worker_id):
                    self.worker_id, self.ttl_s = self._register()
            except CoordinatorError:
                continue                        # coordinator down: keep trying


class ElasticWorkerPoolExecutor(WorkerPoolExecutor):
    """``WorkerPoolExecutor`` over a live roster (module docstring).

    ``workers`` seeds the pool (static entries the coordinator never
    retires); discovered workers come and go with the roster. The pool's
    ``maintenance`` hook runs ``sync_roster`` between waves and while
    blocked on completions; a worker that dies mid-trial is retired either
    by its transport error (``WorkerLostError`` → ``retire_on_error``) or by
    its missed heartbeats dropping it from the roster — both re-place its
    in-flight trials on the survivors.
    """

    def __init__(self, coordinator, workers: Sequence[Worker] = (),
                 sticky: bool = True, refresh_s: float = 0.5,
                 runner_spec: Optional[dict] = None,
                 join_timeout_s: float = 60.0,
                 worker_kw: Optional[dict] = None):
        super().__init__(list(workers), sticky=sticky, allow_empty=True)
        self.coordinator = (CoordinatorClient(coordinator)
                            if isinstance(coordinator, str) else coordinator)
        self.refresh_s = refresh_s
        self._explicit_spec = dict(runner_spec) \
            if runner_spec is not None else None
        self._runner_spec = self._explicit_spec
        self._worker_kw = dict(worker_kw or {})
        self._worker_kw.setdefault("connect_timeout", 5.0)
        self._worker_kw.setdefault("connect_retries", 1)
        self._static = list(self.workers)
        self._discovered: Dict[str, Worker] = {}    # address -> worker
        self._cooldown: Dict[str, float] = {}       # address -> retry-at
        self._last_sync = float("-inf")
        self._roster_version = -1
        self.pool.retire_on_error = True
        self.pool.join_timeout_s = join_timeout_s
        self.pool.maintenance = self.sync_roster

    def configure_runner_spec(self, spec: Optional[dict]) -> None:
        if spec is None:
            spec = self._explicit_spec
        if spec is None:
            raise ValueError(
                "experiments using a coordinator dispatch trials to remote "
                "workers, which mirror the runner from a spec (tuner/backend "
                "registry names) — and none could be derived. Configure the "
                "tuner and backend by registry name (share state via a TCP "
                "--store), or build ElasticWorkerPoolExecutor(..., "
                "runner_spec=...) explicitly (runner_spec={} opts into each "
                "worker process's own CLI defaults).")
        if spec:
            super().configure_runner_spec(spec)
        else:
            # {} — explicit opt-in to each worker process's own defaults
            self._runner_spec = {}
            for w in self.workers:
                if getattr(w, "accepts_runner_spec", False) and \
                        w.runner_spec is None:
                    w.runner_spec = {}

    def enable_trace(self, trace_id: Optional[str] = None,
                     collector: Optional[str] = None) -> str:
        """Trace the whole elastic topology: the pool + every current
        worker (via the base executor), plus the coordinator's membership
        events. Workers that join later are handshaked by
        ``WorkerPool.add_worker`` from the pool's stored trace context."""
        tid = super().enable_trace(trace_id=trace_id, collector=collector)
        self.coordinator.enable_trace(tid, collector=collector,
                                      bus=self.pool.bus)
        return tid

    def run_wave(self, runner, workload: str, proposals):
        # a wave boundary forces a sync (one version ping; the roster is
        # only re-read when it bumped): a worker that announced while the
        # scheduler was deciding must be dispatched to in *this* wave, not
        # whenever the rate-limited maintenance hook next fires — a fast
        # run can otherwise finish inside the refresh_s window and never
        # see the join
        self.sync_roster(force=True)
        return super().run_wave(runner, workload, proposals)

    def sync_roster(self, force: bool = False) -> None:
        """Reconcile the pool with the coordinator's live roster: joins
        become ``RemoteWorker``s, leaves retire (re-placing their trials).
        Rate-limited by ``refresh_s``; coordinator outages are skipped — the
        pool keeps running on the roster it has."""
        now = time.monotonic()
        if not force and now - self._last_sync < self.refresh_s:
            return
        self._last_sync = now
        try:
            version = self.coordinator.version()
            # drop book-keeping for workers the pool retired on error, so a
            # recovered (still-listed) address can be re-dialed
            stale = [a for a, w in self._discovered.items()
                     if w not in self.pool.workers]
            for a in stale:
                del self._discovered[a]
            if version == self._roster_version and not stale:
                return
            roster = {e["address"]: e for e in self.coordinator.roster()}
            self._roster_version = version
        except CoordinatorError:
            return                              # coordinator briefly away
        for address, w in list(self._discovered.items()):
            if address not in roster:
                del self._discovered[address]
                # re-places its trials on the survivors
                self.pool.remove_worker(w, reason="roster")
        for address, entry in roster.items():
            if address in self._discovered or now < self._cooldown.get(
                    address, float("-inf")):
                continue
            if any(getattr(w, "address", None) == parse_tcp_address(address)
                   for w in self._static):
                continue                        # statically seeded already
            try:
                worker = RemoteWorker(address, runner_spec=self._runner_spec,
                                      **self._worker_kw)
                self.pool.add_worker(worker)
            except (WorkerError, ValueError):
                # unreachable, a non-worker peer, or it rejected the runner
                # spec — one bad volunteer must not kill the run; retry
                # after a beat rather than hammering every refresh
                self._cooldown[address] = now + 2.0
                continue
            self._discovered[address] = worker

    def close(self) -> None:
        super().close()
        self.coordinator.close()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a PipeTune worker-discovery coordinator "
                    "(python -m repro_torch.coordinator)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7079,
                    help="TCP port (0 binds an ephemeral one)")
    ap.add_argument("--ttl", type=float, default=10.0,
                    help="seconds of heartbeat silence before a worker is "
                         "dropped from the roster")
    args = ap.parse_args(argv)
    service = CoordinatorService(ttl_s=args.ttl)
    server = CoordinatorTCPServer((args.host, args.port), service)
    host, port = server.server_address[:2]
    print(f"coordinator on {host}:{port} (ttl {args.ttl:.0f}s)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
