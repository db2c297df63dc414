"""Remote trial worker: serve the trial-dispatch protocol over TCP, the
counterpart of ``repro.service.worker``.

    PYTHONPATH=src python -m repro_torch.worker --port 0 [--device cpu]

One worker process hosts one runner (tuner + backend, built from registry
names) and executes whole trials on request — the server side of
``repro_torch.service.dispatch``. Clients ``bind`` a runner spec (anything
the spec omits falls back to this process's CLI flags), then ``run``
proposals; the completed ``TrialRecord`` goes back over the wire. Trial
state lives here, so rung-resumed trials and PBT clones must keep hitting
the same worker (the client pool's sticky placement guarantees it). The
first line printed names the bound address (``--port 0`` binds a free
port).

The backend trains on the card unless the bind spec's ``backend_kw`` or
this process's ``--device`` asks for the CPU: ``--device`` fills the
``device`` of a spec that names none, for backends that take one, and the
backend resolves it through ``repro_torch.device`` (no GPU and no CPU
asked for: the bind fails, naming the device). Trials run one at a time
on the RPC handler threads under ``backends.serial_lane``, so on the card a
trial runs on the stream, and through the step cache, that an in-process
serial trial would.

Workers share tuning state the same way jobs do: pass
``--store tcp://HOST:PORT`` of a running ``python -m repro_torch.service``
(or put it in the bind spec) and this worker's PipeTune runner reads/feeds
the shared ground truth.

Discovery: ``--announce tcp://COORD`` self-registers with a running
``python -m repro_torch.coordinator`` and heartbeats until shutdown, so
experiments launched with ``--coordinator`` pick this worker up (and drop
it when it dies) without editing any ``--workers`` list. ``--speed-factor``
declares relative throughput — heterogeneous pools weight placement by it.
``--plugin MODULE`` imports a module for its ``register_*`` side effects
(a user backend such as the LM example's). The ``obs_trace`` hello joins
the process to a driver's distributed trace (``repro_torch.obs.forward``):
its bus is stamped with the trace before the next trial's
``TrialStarted``, and its records ship to the driver's collector.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch import device as device_lib
from repro_torch.core.backends import serial_lane
from repro_torch.obs.events import EpochCompleted, TrialStarted, get_bus
from repro_torch.service.dispatch import parse_tcp_address, record_to_payload
from repro_torch.service.transport import JsonRPCServer

__all__ = ["TrialWorkerService", "TrialWorkerTCPServer", "serve_worker",
           "main"]


class TrialWorkerService:
    """Request handler of one trial worker (transport-agnostic, like
    ``GroundTruthService``): dicts in, dicts out, every response carrying
    ``ok``. Constructor arguments are the process-level defaults a client's
    bind spec overrides field by field."""

    def __init__(self, tuner: str = "v1", tuner_kw: Optional[dict] = None,
                 backend: str = "sim", backend_kw: Optional[dict] = None,
                 seed: int = 0, store: Optional[str] = None,
                 speed_factor: float = 1.0,
                 device: Optional[str] = None):
        self.defaults: Dict[str, Any] = {
            "tuner": tuner, "tuner_kw": dict(tuner_kw or {}),
            "backend": backend, "backend_kw": dict(backend_kw or {}),
            "seed": int(seed), "store": store}
        self.speed_factor = float(speed_factor)
        # --device: the device of a bind spec that names none
        self.device = device
        self.runner = None
        self.spec: Optional[dict] = None
        self._store_client = None
        self.bus = get_bus()
        self._epochs_seen: Dict[str, int] = {}  # trial -> epochs emitted
        # one worker process executes one trial at a time: the server is
        # threaded (one handler per connection), so bind/clone/run from
        # different connections must not interleave on the shared runner
        self._lock = threading.Lock()

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

    def close(self) -> None:
        # the runner (and with it _store_client) is mutated under the lock
        # by bind/clone handlers on server threads; teardown must not race
        # a concurrent bind's _build_runner
        with self._lock:
            if self._store_client is not None:
                self._store_client.close()
                self._store_client = None
        sink = self.bus.forward_sink
        if sink is not None:        # ship the tail of the trace home
            sink.flush(timeout=1.0)

    # ------------------------------------------------------------------ ops
    def _op_hello(self, req) -> Dict[str, Any]:
        # capacity is structurally 1: one runner, one trial at a time
        return {"kind": "remote", "capacity": 1, "pid": os.getpid(),
                "speed_factor": self.speed_factor,
                "defaults": {k: self.defaults[k]
                             for k in ("tuner", "backend", "seed", "store")}}

    def _op_bind(self, req) -> Dict[str, Any]:
        spec = {**self.defaults, **{k: v for k, v in
                                    (req.get("spec") or {}).items()
                                    if v is not None}}
        with self._lock:
            self.runner = self._build_runner(spec)
            self.spec = spec
            self._epochs_seen = {}      # fresh trial state per job
        return {"tuner": spec["tuner"], "backend": spec["backend"],
                "store": spec.get("store")}

    def _op_obs_trace(self, req) -> Dict[str, Any]:
        # distributed-tracing hello (repro_torch.obs.forward): adopt the
        # client-assigned trace context + proc label, echo the trace id,
        # forward local events to the named collector
        from repro_torch.obs.forward import adopt_trace
        out = adopt_trace(req, self.bus)
        with self._lock:
            if self._store_client is not None:
                self._wire_store_trace(self._store_client)
        return out

    def _op_clone(self, req) -> Dict[str, Any]:
        with self._lock:
            self._require_runner().clone_trial(str(req["dst"]),
                                               str(req["src"]))
        return {}

    def _op_run(self, req) -> Dict[str, Any]:
        with self._lock, serial_lane():
            runner = self._require_runner()
            rec = self._run_trial(runner, str(req["workload"]),
                                  str(req["trial_id"]),
                                  dict(req["hparams"]), int(req["epochs"]))
            out = {"record": record_to_payload(rec)}
        self._kick_forwarder()
        return out

    def _op_run_many(self, req) -> Dict[str, Any]:
        """A wave's worth of trials in one round-trip. Trials run in
        order under the runner lock; each answers with its own
        ``{ok, record|error}`` so one bad trial doesn't poison the batch.
        Nothing is acked until the whole batch returns — a client that
        loses the connection mid-batch treats every member as unknown and
        re-places it (deterministic backends make the re-run identical)."""
        workload = str(req["workload"])
        results = []
        with self._lock, serial_lane():
            runner = self._require_runner()
            for t in req.get("trials", []):
                try:
                    rec = self._run_trial(runner, workload,
                                          str(t["trial_id"]),
                                          dict(t["hparams"]),
                                          int(t["epochs"]))
                    results.append({"ok": True,
                                    "record": record_to_payload(rec)})
                except Exception as e:              # noqa: BLE001
                    results.append(
                        {"ok": False,
                         "error": f"{type(e).__name__}: {e}"})
        self._kick_forwarder()
        return {"results": results}

    def _kick_forwarder(self) -> None:
        """Nudge the forwarding sink at the end of each run request so the
        wave's events ship before the driver acts on the response — a
        worker SIGKILL'd (or a run ending) right after the last wave would
        otherwise lose everything queued since the previous 0.2s tick."""
        sink = self.bus.forward_sink
        if sink is not None:
            sink.kick()

    # ------------------------------------------------------------ internals
    def _require_runner(self):
        if self.runner is None:
            raise RuntimeError("no runner bound (send a 'bind' op first)")
        return self.runner

    def _run_trial(self, runner, workload: str, trial_id: str,
                   hparams: dict, epochs: int):
        """``runner.run_trial`` plus, when traced, the worker-side event
        stream: ``trial_started`` at entry, then one ``epoch_completed``
        per *new* epoch with its timestamp allocated across the measured
        wall interval proportionally to epoch duration (sim backends
        report simulated seconds, so raw ``duration_s`` is not wall time
        — the allocation keeps worker timelines causally ordered)."""
        if not self.bus.enabled:
            return runner.run_trial(workload, trial_id, hparams, epochs)
        label = self.bus.proc or f"worker:{os.getpid()}"
        t0 = time.time()
        self.bus.emit(TrialStarted(trial_id=trial_id, worker=label,
                                   epochs=int(epochs)))
        rec = runner.run_trial(workload, trial_id, hparams, epochs)
        t1 = time.time()
        seen = self._epochs_seen.get(trial_id, 0)
        new = rec.epochs[seen:]
        self._epochs_seen[trial_id] = len(rec.epochs)
        if new:
            weights = [max(0.0, float(e.duration_s)) for e in new]
            total = sum(weights)
            if total <= 0.0:
                weights, total = [1.0] * len(new), float(len(new))
            done = 0.0
            for i, e in enumerate(new, start=seen):
                done += weights[i - seen]
                self.bus.emit(EpochCompleted(
                    trial_id=trial_id, worker=label, epoch=i,
                    duration_s=float(e.duration_s)),
                    ts=t0 + (t1 - t0) * (done / total))
        return rec

    def _wire_store_trace(self, client) -> None:
        """Join the worker's store traffic to the adopted trace: store
        RPCs emit ``RpcCompleted`` on this process's bus and carry the
        ``_trace`` metadata (the driver handshakes the store *service*
        itself; re-helloing from every worker would duplicate sinks)."""
        if self.bus.trace_id is None:
            return
        client.bus = self.bus
        try:
            client.transport.trace = self.bus.trace_id
        except AttributeError:
            pass

    def _build_runner(self, spec: Dict[str, Any]):
        # lazy: repro_torch.api sits above repro_torch.service in the layer
        # order
        from repro_torch.api import registry
        backend_kw = dict(spec.get("backend_kw") or {})
        if self.device is not None and "device" not in backend_kw and \
                _takes_device(registry.backend_factory(spec["backend"])):
            backend_kw["device"] = self.device
        backend = registry.make_backend(spec["backend"], **backend_kw)
        groundtruth = None
        store = spec.get("store")
        if store:
            from repro_torch.service.transport import (SocketTransport,
                                                       StoreClient)
            host, port = parse_tcp_address(store)
            groundtruth = StoreClient(SocketTransport(host, port))
            self._wire_store_trace(groundtruth)
        if self._store_client is not None:
            self._store_client.close()
        self._store_client = groundtruth
        tuner_kw = dict(spec.get("tuner_kw") or {})
        tuner_kw.setdefault("seed", int(spec.get("seed", 0)))
        return registry.make_tuner(
            spec["tuner"], backend,
            sys_space=registry.default_sys_space(spec["backend"],
                                                 **backend_kw),
            groundtruth=groundtruth, **tuner_kw)


def _takes_device(factory) -> bool:
    """Whether a backend factory takes a ``device`` keyword (the sim
    backend, which touches no device, does not)."""
    params = inspect.signature(factory).parameters.values()
    return any(p.name == "device" or p.kind is p.VAR_KEYWORD
               for p in params)


class TrialWorkerTCPServer(JsonRPCServer):
    """Serve one ``TrialWorkerService``. Port 0 binds an ephemeral port."""

    def __init__(self, address: Tuple[str, int],
                 service: TrialWorkerService):
        super().__init__(address, service.handle)
        self.service = service


def serve_worker(service: TrialWorkerService, host: str = "127.0.0.1",
                 port: int = 7078,
                 background: bool = False) -> TrialWorkerTCPServer:
    """Run a trial worker server; ``background=True`` serves from a daemon
    thread and returns immediately (tests, co-located pools)."""
    server = TrialWorkerTCPServer((host, port), service)
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    else:
        server.serve_forever()
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a PipeTune trial worker over TCP "
                    "(python -m repro_torch.worker)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7078,
                    help="TCP port (0 binds an ephemeral one)")
    ap.add_argument("--tuner", default="v1",
                    help="default tuner registry name (a bind spec "
                         "overrides it)")
    ap.add_argument("--backend", default="sim",
                    help="default backend registry name")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None,
                    help="tcp://HOST:PORT of a shared `python -m "
                         "repro_torch.service` ground-truth store")
    ap.add_argument("--announce", default=None,
                    help="tcp://HOST:PORT of a running `python -m "
                         "repro_torch.coordinator` to register with "
                         "(heartbeats until shutdown, so --coordinator "
                         "experiments discover this worker)")
    ap.add_argument("--advertise-host", default=None,
                    help="hostname workers are dialed back on when "
                         "announcing (default: --host; set it when binding "
                         "0.0.0.0)")
    ap.add_argument("--advertise-port", type=int, default=None,
                    help="port workers are dialed back on when announcing "
                         "(default: the bound port; set it when a proxy or "
                         "port-forward sits in front of this worker)")
    ap.add_argument("--speed-factor", type=float, default=1.0,
                    help="declared relative throughput of this worker "
                         "(1.0 = baseline); elastic pools weight placement "
                         "by it")
    ap.add_argument("--plugin", action="append", default=[],
                    help="module to import for register_* side effects")
    ap.add_argument("--device", default=None,
                    help="device of the backends that take one, where the "
                         "bind spec names none: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    for mod in args.plugin:
        importlib.import_module(mod)
    device = None
    if args.device is not None:     # a card asked for and absent: raise now
        device = str(device_lib.resolve(args.device))

    service = TrialWorkerService(tuner=args.tuner, backend=args.backend,
                                 seed=args.seed, store=args.store,
                                 speed_factor=args.speed_factor,
                                 device=device)
    server = TrialWorkerTCPServer((args.host, args.port), service)
    host, port = server.server_address[:2]
    print(f"trial worker on {host}:{port} (tuner={args.tuner}, "
          f"backend={args.backend}, device={device or 'cuda'}"
          + (f", store {args.store}" if args.store else "") + ")",
          flush=True)
    announcer = None
    if args.announce:
        from repro_torch.service.coordinator import WorkerAnnouncer
        advertise = args.advertise_host or args.host
        advertise_port = args.advertise_port or port
        announcer = WorkerAnnouncer(
            args.announce, address=f"tcp://{advertise}:{advertise_port}",
            speed_factor=args.speed_factor)
        worker_id = announcer.start()
        print(f"announced to {args.announce} as {worker_id}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if announcer is not None:
            announcer.stop()
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
