"""Trial-dispatch wire protocol: remote workers next to the store's wire,
the counterpart of ``repro.service.dispatch``.

A ``RemoteWorker`` is the client side of a small request/response protocol
— the length-prefixed framing ``repro_torch.service.transport`` speaks
(JSON by default; connections negotiate the binary codec via the ``_wire``
hello, see ``repro_torch.service.codec``) — served by a ``python -m
repro_torch.worker`` process (``repro_torch.service.worker``):

    hello                      -> {ok, kind, capacity, defaults}
    bind  {spec}               -> build the worker's runner (tuner/backend/
                                  seed/store registry names; CLI defaults
                                  fill whatever the spec omits)
    clone {dst, src}           -> PBT exploit on the worker's runner
    run   {workload, trial_id,
           hparams, epochs}    -> {record}: the completed TrialRecord
    run_many {workload,
              trials: [...]}   -> {results}: per-trial {ok, record|error},
                                  in order — one round-trip per wave
                                  (``submit_many``; falls back to ``run``
                                  on workers that predate it)

The worker process owns the trial state (rung resumes and clones must keep
landing on the same worker — sticky pool placement guarantees that) and
runs each trial on its *own* runner; the completed record is serialized
back and installed into the local runner, so job-level bookkeeping (best
trial, tuning time, energy) is oblivious to where epochs ran. Every codec
round-trips Python floats and ints exactly, so a remote run on a
deterministic backend is bit-identical to an in-process one — the
acceptance property the tests assert. A numpy scalar or a 0-d tensor is
not in the codecs' data model (JSON refuses an ``np.int64``, and a CUDA
tensor's value lives on the device), so every payload here goes through
``codec.plain`` first. The messages are the reference's, so a worker of
either package serves a driver of the other. Cross-worker tuning state is
the store: point every worker at one ``python -m repro_torch.service`` via
the spec's ``store`` field and their PipeTune runners share ground truth.
``enable_trace`` joins the worker process to a distributed trace
(``repro_torch.obs.forward``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.backends import EpochResult
from repro_torch.core.pipetune import TrialRecord
from repro_torch.core.profiler import EpochProfile
from repro_torch.core.schedulers import TrialProposal
from repro_torch.core.worker import (TrialCompletion, Worker,
                                     WorkerCapabilities)
from repro_torch.obs.events import EpochCompleted, RpcCompleted
from repro_torch.service.codec import plain
from repro_torch.service.transport import SocketTransport, TransportError

__all__ = ["RemoteWorker", "WorkerError", "WorkerLostError",
           "parse_tcp_address", "record_to_payload", "record_from_payload"]


class WorkerError(RuntimeError):
    """A remote worker request failed (server error or broken transport)."""


class WorkerLostError(WorkerError):
    """The worker's transport died mid-run (connection refused, reset, or
    closed). Always names the worker's ``tcp://`` address, so pool-level
    retirement and users can tell which worker went away, and — when the
    client has history with the worker — how stale it was when it died:
    ``age_s`` (seconds since the last successful request) and
    ``last_trial``/``last_epochs`` (the last trial it completed and that
    record's epoch count). ``worker_lost`` is the layering-safe flag
    ``WorkerPool.retire_on_error`` keys on (``repro_torch.core`` cannot
    import this module)."""

    worker_lost = True

    def __init__(self, message: str, age_s: Optional[float] = None,
                 last_trial: Optional[str] = None,
                 last_epochs: Optional[int] = None):
        super().__init__(message)
        self.age_s = age_s
        self.last_trial = last_trial
        self.last_epochs = last_epochs


def parse_tcp_address(spec: str) -> Tuple[str, int]:
    """``tcp://HOST:PORT`` -> ``(host, port)``; host defaults to loopback."""
    if not spec.startswith("tcp://"):
        raise ValueError(f"expected tcp://HOST:PORT, got {spec!r}")
    host, _, port = spec[len("tcp://"):].rpartition(":")
    if not port.isdigit():
        raise ValueError(f"{spec!r}: expected tcp://HOST:PORT")
    return host or "127.0.0.1", int(port)


# ---------------------------------------------------------------------------
# record serialization (the wire format of a completed trial)
# ---------------------------------------------------------------------------

def _epoch_to_payload(e: EpochResult) -> Dict[str, Any]:
    return {
        "duration_s": float(e.duration_s), "energy_j": float(e.energy_j),
        "loss": float(e.loss), "accuracy": float(e.accuracy),
        "profile": {"events": {k: float(v)
                               for k, v in e.profile.events.items()},
                    "raw": bool(e.profile.raw)},
        "sys_config": plain(dict(e.sys_config)),
        "step_times": [float(t) for t in e.step_times],
        "compile_s": float(e.compile_s),
    }


def _epoch_from_payload(d: Dict[str, Any]) -> EpochResult:
    prof = d.get("profile") or {"events": {}, "raw": False}
    return EpochResult(
        duration_s=d["duration_s"], energy_j=d["energy_j"], loss=d["loss"],
        accuracy=d["accuracy"],
        profile=EpochProfile(dict(prof["events"]), raw=bool(prof["raw"])),
        sys_config=dict(d["sys_config"]),
        step_times=list(d["step_times"]), compile_s=d.get("compile_s", 0.0))


def record_to_payload(rec: TrialRecord) -> Dict[str, Any]:
    return {"trial_id": rec.trial_id, "hparams": plain(dict(rec.hparams)),
            "epochs": [_epoch_to_payload(e) for e in rec.epochs],
            "sys_history": [plain(dict(s)) for s in rec.sys_history],
            "gt_hit": bool(rec.gt_hit),
            "probe_epochs": int(rec.probe_epochs)}


def record_from_payload(d: Dict[str, Any]) -> TrialRecord:
    return TrialRecord(
        trial_id=str(d["trial_id"]), hparams=dict(d["hparams"]),
        epochs=[_epoch_from_payload(e) for e in d["epochs"]],
        sys_history=[dict(s) for s in d["sys_history"]],
        gt_hit=bool(d["gt_hit"]), probe_epochs=int(d["probe_epochs"]))


# ---------------------------------------------------------------------------
# the remote worker (client side)
# ---------------------------------------------------------------------------

class RemoteWorker(Worker):
    """Worker-protocol client of one ``python -m repro_torch.worker``
    process.

    ``runner_spec`` is the recipe the worker uses to mirror the local
    runner: ``{"tuner", "tuner_kw", "backend", "backend_kw", "seed",
    "store"}`` — all registry names / JSON values, all optional (the worker
    process's CLI defaults fill the gaps). ``Experiment`` derives it
    automatically from its own tuner/backend configuration via
    ``WorkerPoolExecutor.configure_runner_spec``.

    Requests are serialized over one persistent connection; ``submit`` is
    non-blocking (a dispatcher thread issues the ``run`` request), trial
    results land in a completion queue drained by ``poll``.
    """

    kind = "remote"
    accepts_runner_spec = True

    def __init__(self, address: str, runner_spec: Optional[dict] = None,
                 connect_timeout: float = 30.0, connect_retries: int = 5,
                 retry_backoff_s: float = 0.2, wire: str = "auto"):
        super().__init__()
        host, port = parse_tcp_address(address)
        self.address = (host, port)
        # {} is a meaningful spec (use the worker process's CLI defaults),
        # distinct from None (no spec yet — Experiment may fill it in)
        self.runner_spec = dict(runner_spec) if runner_spec is not None \
            else None
        # last-contact bookkeeping, set before the first request (hello)
        # so a transport death always has it to report
        self._last_ok_t: Optional[float] = None
        self._last_trial: Optional[str] = None
        self._last_epochs = 0
        self._epochs_seen: Dict[str, int] = {}      # trial -> epochs emitted
        # tracing: once the peer forwards its own events to a collector
        # (enable_trace), the driver stops synthesizing EpochCompleted from
        # returned records — the worker-side stream is the real one
        self._peer_traced = False
        self._pending_compute_s = 0.0   # remote compute seen since last rpc
        # request_timeout=None: a remote trial legitimately runs longer
        # than any sane connect timeout
        try:
            self.transport = SocketTransport(
                host, port, timeout=connect_timeout,
                connect_retries=connect_retries,
                retry_backoff_s=retry_backoff_s, request_timeout=None,
                wire=wire)
        except TransportError as e:
            raise WorkerLostError(
                f"worker tcp://{host}:{port} unreachable: {e}") from e
        hello = self._request({"op": "hello"})  # fail fast on a non-worker
        # one connection executes one trial at a time (requests are
        # serialized, the server locks its runner per trial), so advertise
        # capacity 1 regardless of what the server claims; scale by adding
        # workers, not by inflating one. The worker's declared relative
        # speed does ride along — placement weights load by it.
        self._caps = WorkerCapabilities(
            kind=self.kind, capacity=1, remote=True,
            speed_factor=float(hello.get("speed_factor", 1.0)))
        self._inbox: "queue.Queue" = queue.Queue()
        self._completions: "queue.Queue[TrialCompletion]" = queue.Queue()
        self._outstanding = 0
        self._batched_runs = True       # cleared if the peer lacks run_many
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"remote-worker-{host}:{port}")
        self._thread.start()

    # -------------------------------------------------------------- protocol
    def capabilities(self) -> WorkerCapabilities:
        return self._caps

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def bind(self, runner, workload: str) -> None:
        super().bind(runner, workload)
        if self.runner_spec is None:
            # never fall back silently: a worker running its own default
            # tuner/backend would merge wrong scores without a trace
            raise ValueError(
                f"remote worker {self.address[0]}:{self.address[1]} has no "
                "runner spec — Experiment derives one from registry names, "
                "or pass runner_spec= explicitly (runner_spec={} opts into "
                "the worker process's own CLI defaults)")
        # (re)build the worker's mirror runner; fresh trial state per job
        self._request({"op": "bind", "spec": dict(self.runner_spec)})

    def enable_trace(self, trace_id: str,
                     collector: Optional[str] = None) -> bool:
        """Send the ``obs_trace`` hello so the worker process tags its
        events with this trace and (when ``collector`` is set) forwards
        them home. Returns False for a legacy worker — the run proceeds
        untraced on that peer, with driver-side synthesis as before."""
        from repro_torch.obs.forward import propagate_trace
        label = f"tcp://{self.address[0]}:{self.address[1]}"
        ok = propagate_trace(self.transport, trace_id, collector=collector,
                             proc=label, bus=self.bus)
        self._peer_traced = bool(ok and collector)
        return ok

    def clone(self, dst_id: str, src_id: str) -> None:
        # wave-boundary semantics hold because the pool only clones while
        # the worker is idle (between waves), so this request cannot
        # interleave with an in-flight run
        self._request({"op": "clone", "dst": dst_id, "src": src_id})

    def submit(self, trial: TrialProposal,
               epochs: Optional[int] = None) -> None:
        self._outstanding += 1
        self._inbox.put([(trial, trial.epochs if epochs is None else epochs)])

    def submit_many(self, batch) -> None:
        """One wire round-trip for the whole batch: the dispatcher thread
        sends a single ``run_many`` request (falling back to per-trial
        ``run`` on workers that predate it)."""
        items = [(t, t.epochs if e is None else e) for t, e in batch]
        if not items:
            return
        self._outstanding += len(items)
        self._inbox.put(items)

    def poll(self, timeout: float = 0.0) -> List[TrialCompletion]:
        out = self._poll_queue(self._completions, timeout)
        self._outstanding -= len(out)
        return out

    def close(self) -> None:
        # abandon queued-but-undispatched trials so the shutdown sentinel
        # is next in line; an in-flight trial finishes server-side and its
        # unread completion is dropped with the connection
        try:
            while True:
                self._inbox.get_nowait()
        except queue.Empty:
            pass
        self._inbox.put(None)
        self._thread.join(timeout=2.0)
        self.transport.close()

    # ------------------------------------------------------------ internals
    def _request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        try:
            resp = self.transport.request(req)
        except (TransportError, ConnectionError, OSError) as e:
            # a raw socket error says nothing about *which* worker died;
            # name the address — and how stale it was — so pool-level
            # retirement (and the user) can act on the report
            age = None if self._last_ok_t is None \
                else time.monotonic() - self._last_ok_t
            detail = ""
            if age is not None:
                detail = f" (last ok {age:.1f}s ago"
                if self._last_trial is not None:
                    detail += (f"; last completed trial {self._last_trial} "
                               f"@{self._last_epochs} epochs")
                detail += ")"
            raise WorkerLostError(
                f"worker tcp://{self.address[0]}:{self.address[1]} lost "
                f"during {req.get('op')!r}{detail}: {e}",
                age_s=age, last_trial=self._last_trial,
                last_epochs=self._last_epochs or None) from e
        self._last_ok_t = time.monotonic()
        if not resp.get("ok"):
            raise WorkerError(
                f"worker {self.address[0]}:{self.address[1]} rejected "
                f"{req.get('op')!r}: {resp.get('error', 'unknown error')}")
        return resp

    def _install(self, payload: Dict[str, Any]) -> TrialCompletion:
        """Adopt one completed record from the wire into the local runner."""
        rec = record_from_payload(payload)
        runner = self.runner
        runner.install_record(rec)
        self._last_trial = rec.trial_id
        self._last_epochs = len(rec.epochs)
        if self.bus.enabled:
            # records accumulate epochs across rung resumes:
            # count (and emit) only what this completion added
            label = f"tcp://{self.address[0]}:{self.address[1]}"
            seen = self._epochs_seen.get(rec.trial_id, 0)
            self._pending_compute_s += sum(
                float(e.duration_s) for e in rec.epochs[seen:])
            if not self._peer_traced:
                # the worker emits the real per-epoch stream itself when
                # traced; synthesizing here too would double-count
                for i in range(seen, len(rec.epochs)):
                    self.bus.emit(EpochCompleted(
                        trial_id=rec.trial_id, worker=label, epoch=i,
                        duration_s=rec.epochs[i].duration_s))
            self._epochs_seen[rec.trial_id] = len(rec.epochs)
        return TrialCompletion(rec.trial_id, rec.score(runner.objective))

    def _rpc_done(self, op: str, dt: float, n: int) -> None:
        """Emit the round-trip receipt: overhead is wall duration minus the
        remote compute the installed record(s) accounted for (clamped —
        simulated epoch durations can exceed wall time)."""
        self.bus.emit(RpcCompleted(
            op=op, peer=f"tcp://{self.address[0]}:{self.address[1]}",
            duration_s=dt,
            overhead_s=max(0.0, dt - self._pending_compute_s), n=n))

    def _run_one(self, trial: TrialProposal, epochs: int) -> None:
        try:
            t0 = time.monotonic()
            resp = self._request({
                "op": "run", "workload": self.workload,
                "trial_id": trial.trial_id,
                "hparams": plain(dict(trial.hparams)),
                "epochs": int(epochs)})
            dt = time.monotonic() - t0
            self._pending_compute_s = 0.0
            completion = self._install(resp["record"])
            if self.bus.enabled:
                self._rpc_done("run", dt, 1)
            self._completions.put(completion)
        except BaseException as e:                      # noqa: BLE001
            self._completions.put(TrialCompletion(
                trial.trial_id, float("nan"), error=e))

    def _run_batch(self, items) -> None:
        """One ``run_many`` round-trip for the batch. On a transport death
        mid-batch *every* member reports the same ``WorkerLostError`` —
        nothing acked means nothing is known to have run, so the pool
        retires this worker once and re-places every member; trials the
        server finished before dying re-run deterministically elsewhere
        (the record installs once, from whichever run was acked)."""
        try:
            t0 = time.monotonic()
            resp = self._request({
                "op": "run_many", "workload": self.workload,
                "trials": [{"trial_id": t.trial_id,
                            "hparams": plain(dict(t.hparams)),
                            "epochs": int(e)} for t, e in items]})
            batch_dt = time.monotonic() - t0
        except WorkerLostError as e:
            for trial, _ in items:
                self._completions.put(TrialCompletion(
                    trial.trial_id, float("nan"), error=e))
            return
        except WorkerError:
            # a worker process that predates run_many: replay per trial
            # over the same healthy connection, and stop batching
            self._batched_runs = False
            for trial, epochs in items:
                self._run_one(trial, epochs)
            return
        except BaseException as e:                      # noqa: BLE001
            for trial, _ in items:
                self._completions.put(TrialCompletion(
                    trial.trial_id, float("nan"), error=e))
            return
        results = resp.get("results", [])
        self._pending_compute_s = 0.0
        for (trial, _), sub in zip(items, results):
            try:
                if not sub.get("ok"):
                    raise WorkerError(
                        f"worker {self.address[0]}:{self.address[1]} failed "
                        f"trial {trial.trial_id}: "
                        f"{sub.get('error', 'unknown error')}")
                self._completions.put(self._install(sub["record"]))
            except BaseException as e:                  # noqa: BLE001
                self._completions.put(TrialCompletion(
                    trial.trial_id, float("nan"), error=e))
        if self.bus.enabled:
            self._rpc_done("run_many", batch_dt, len(items))
        for trial, _ in items[len(results):]:           # truncated response
            self._completions.put(TrialCompletion(
                trial.trial_id, float("nan"),
                error=WorkerError(
                    f"worker {self.address[0]}:{self.address[1]} returned "
                    f"no result for trial {trial.trial_id}")))

    def _loop(self) -> None:
        while True:
            items = self._inbox.get()
            if items is None:
                return
            if len(items) == 1 or not self._batched_runs:
                for trial, epochs in items:
                    self._run_one(trial, epochs)
            else:
                self._run_batch(items)
