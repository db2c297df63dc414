"""Chaos orchestrator: inject faults into *real* runs, assert recovery SLOs;
the counterpart of ``repro.obs.chaos``, with its faults, budgets and
verdicts.

The sim engine could always inject stragglers and failures; this module
does it to the live path — a coordinator, real ``python -m
repro_torch.worker`` subprocesses, an ``ElasticWorkerPoolExecutor``
driving a real experiment — and judges the outcome from the structured
event stream instead of ad-hoc test assertions:

    report = run_scenario(SCENARIOS["sigkill_worker"])
    assert report.passed, report.summary()

A ``ChaosScenario`` is declarative: a topology (worker count, heartbeat
TTL, optional shared ground-truth store), one fault
(``KillWorkers`` / ``PartitionCoordinator`` / ``PartitionStore`` /
``SlowWorker``), and an ``SLOBudget``. The orchestrator:

1. starts a coordinator (and optionally a store) in-process, instrumented
   onto a fresh ``EventBus``;
2. spawns the worker subprocesses (``--announce``), waits for discovery;
3. runs the experiment on a background thread behind a wave gate, so the
   fault always lands *mid-run*, after real trials have been dispatched;
4. injects the fault (SIGKILL, a dialed ``ChaosProxy`` partition, a
   degraded ``--speed-factor`` node), releases the gate, lets the run
   finish;
5. evaluates the SLOs: time-to-retire after the kill, every trial that
   was on the victim re-placed and completed, zero epochs lost or
   repeated, and final scores bit-identical to an undisturbed serial run
   on the same (deterministic sim) backend.

Network partitions go through ``ChaosProxy``, a TCP forwarder whose mode
is dialed at runtime: ``refuse`` (connections reset — the peer looks
dead), ``blackhole`` (accepted but stalled — the peer looks hung; bytes
are *paused*, never dropped, so framing survives healing), or ``pass``.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.events import EventBus, worker_label  # noqa: F401
from repro_torch.obs.sinks import JsonlSink, MemorySink

__all__ = ["KillWorkers", "PartitionWorker", "PartitionCoordinator",
           "PartitionStore", "SlowWorker", "SLOBudget", "ChaosScenario",
           "SLOResult", "ChaosReport", "ChaosProxy", "run_scenario"]


# ---------------------------------------------------------------------------
# the declarative surface: faults, budgets, scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KillWorkers:
    """SIGKILL `victims` of the spawned worker subprocesses mid-run (no
    goodbye, no TCP FIN courtesy beyond the kernel's): the crash-failure
    the heartbeat TTL and the transport-death retirement both exist for."""
    victims: int = 1


@dataclasses.dataclass(frozen=True)
class PartitionWorker:
    """Sever one worker's *dispatch* path mid-run and never heal it while
    the run lasts: a ``ChaosProxy`` sits between the pool and the worker
    (the worker announces the proxy's address via ``--advertise-host``/
    ``--advertise-port``) and flips to ``refuse`` — live connections are
    closed, new ones reset — while the worker process itself stays alive
    and heartbeating directly to the coordinator. The roster therefore
    never prunes the victim; only the transport-death retirement path can
    save the run, and the gated wave's ``run_many`` batch dies mid-batch
    (the live connection is severed under it): every member must re-place
    onto a survivor exactly once (no trial lost, none double-run)."""
    mode: str = "refuse"


@dataclasses.dataclass(frozen=True)
class PartitionCoordinator:
    """Partition the coordinator behind a ``ChaosProxy`` for
    ``duration_s``: discovery and heartbeats fail, the pool must keep
    running on the roster it has and re-converge after healing."""
    duration_s: float = 5.0
    mode: str = "refuse"                # "refuse" | "blackhole"


@dataclasses.dataclass(frozen=True)
class PartitionStore:
    """Stall the shared ground-truth store (blackhole: requests pause, no
    bytes lost) for ``duration_s``; lookups ride it out and the run's
    results must not change."""
    duration_s: float = 1.0
    mode: str = "blackhole"


@dataclasses.dataclass(frozen=True)
class SlowWorker:
    """Degrade capacity the legal way: an extra worker joins with a dialed
    ``--speed-factor`` — placement must shed load onto the fast nodes and
    results must not change."""
    speed_factor: float = 0.25


@dataclasses.dataclass(frozen=True)
class SLOBudget:
    """What recovery must look like. ``retire_within_s`` defaults (None)
    to ``2 * ttl_s + 2`` — one full TTL for the silence to be provable,
    one for prune + roster propagation, slack for poll latency."""
    retire_within_s: Optional[float] = None
    require_replacement: bool = True    # >=1 trial re-placed off a victim
    no_lost_epochs: bool = True         # per-trial epochs match serial
    bit_identical: bool = True          # final scores match serial
    min_heartbeats_missed: int = 0      # the fault provably bit (partition)
    max_dispatch_share: Optional[float] = None  # slow node's dispatch cap


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    name: str
    description: str
    fault: Any = dataclasses.field(default_factory=KillWorkers)
    n_workers: int = 2
    ttl_s: float = 2.0
    epochs: int = 9
    tuner: str = "v1"
    with_store: bool = False            # shared TCP ground-truth store
    gate_after_wave: int = 2            # fault lands before this wave + 1
    seed: int = 0
    slo: SLOBudget = dataclasses.field(default_factory=SLOBudget)

    def retire_budget_s(self) -> float:
        if self.slo.retire_within_s is not None:
            return self.slo.retire_within_s
        return 2.0 * self.ttl_s + 2.0


@dataclasses.dataclass
class SLOResult:
    name: str
    ok: bool
    value: Any
    budget: Any
    detail: str = ""


@dataclasses.dataclass
class ChaosReport:
    scenario: str
    passed: bool
    slos: List[SLOResult]
    recovery_s: Optional[float]         # kill -> pool retirement (worst
                                        # victim)
    replaced: int                       # trials re-placed off victims
    n_events: int
    wall_s: float
    counters: Dict[str, int]

    def summary(self) -> str:
        lines = [f"chaos scenario {self.scenario!r}: "
                 f"{'PASS' if self.passed else 'FAIL'} "
                 f"({self.n_events} events, {self.wall_s:.1f}s wall)"]
        for s in self.slos:
            mark = "ok " if s.ok else "VIOLATED"
            detail = " — " + s.detail if s.detail else ""
            lines.append(f"  [{mark}] {s.name}: {s.value} "
                         f"(budget {s.budget}){detail}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the partition tool
# ---------------------------------------------------------------------------

class ChaosProxy:
    """TCP forwarder with a runtime-dialed fault mode.

    ``pass``      forward both directions transparently.
    ``refuse``    reset new connections immediately and close live ones —
                  the upstream looks crashed.
    ``blackhole`` accept and hold: no bytes move in either direction while
                  the mode is set, but nothing is dropped — healing back to
                  ``pass`` resumes mid-stream with framing intact.
    """

    def __init__(self, upstream: Tuple[str, int], host: str = "127.0.0.1"):
        self.upstream = upstream
        self.mode = "pass"
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(32)
        self.address = self._listener.getsockname()
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    @property
    def tcp(self) -> str:
        return f"tcp://{self.address[0]}:{self.address[1]}"

    def set_mode(self, mode: str) -> None:
        if mode not in ("pass", "refuse", "blackhole"):
            raise ValueError(f"unknown proxy mode {mode!r}")
        self.mode = mode
        if mode == "refuse":
            with self._lock:
                conns, self._conns = self._conns, []
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.set_mode("refuse")         # closes live pipes

    # ------------------------------------------------------------ internals
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            if self.mode == "refuse":
                client.close()
                continue
            try:
                server = socket.create_connection(self.upstream, timeout=10)
            except OSError:
                client.close()
                continue
            with self._lock:
                self._conns += [client, server]
            for src, dst in ((client, server), (server, client)):
                threading.Thread(target=self._pump, args=(src, dst),
                                 daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        src.settimeout(0.1)
        try:
            while not self._stop.is_set():
                if self.mode == "blackhole":
                    time.sleep(0.05)    # pause — bytes wait in the kernel
                    continue
                try:
                    data = src.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

class _GatedScheduler:
    """Hold wave ``gate_after + 1`` until the orchestrator releases the
    gate — the deterministic way to land a fault *mid-run*, after real
    waves have dispatched and bindings exist."""

    def __init__(self, inner, gate_after: int):
        self.inner = inner
        self.gate = threading.Event()
        self.reached = threading.Event()    # waves before the gate all ran
        self._waves = 0
        self._gate_after = gate_after

    def suggest(self):
        wave = self.inner.suggest()
        if wave:
            if self._waves == self._gate_after:
                self.reached.set()
                assert self.gate.wait(timeout=120.0), "chaos gate timed out"
            self._waves += 1
        return wave

    def report(self, trial_id, score):
        self.inner.report(trial_id, score)

    def best(self):
        return self.inner.best()

    @property
    def done(self):
        return self.inner.done


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _reserve_port(host: str = "127.0.0.1") -> int:
    """Bind-and-release an ephemeral port so a proxy can be built in front
    of a worker before the worker process exists (small reuse race,
    acceptable for chaos runs)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _WorkerProc:
    """One spawned ``python -m repro_torch.worker`` subprocess + its
    address."""

    def __init__(self, announce: str, store: Optional[str] = None,
                 speed_factor: float = 1.0, timeout: float = 30.0,
                 port: int = 0,
                 advertise: Optional[Tuple[str, int]] = None):
        argv = [sys.executable, "-m", "repro_torch.worker", "--port",
                str(port), "--announce", announce]
        if advertise is not None:
            argv += ["--advertise-host", advertise[0],
                     "--advertise-port", str(advertise[1])]
        if store:
            argv += ["--store", store]
        if speed_factor != 1.0:
            argv += ["--speed-factor", str(speed_factor)]
        src = os.path.join(_repo_root(), "src")
        env = {**os.environ,
               "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH",
                                                               "")}
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=_repo_root(), env=env)
        self.address = ""
        deadline = time.time() + timeout
        announced = False
        while time.time() < deadline and not (self.address and announced):
            line = self.proc.stdout.readline()
            if not line and self.proc.poll() is not None:
                break
            if "trial worker on " in line:
                hp = line.split("trial worker on ", 1)[1].split()[0]
                self.address = f"tcp://{hp}"
            if "announced to" in line:
                announced = True
        if not (self.address and announced):
            self.kill()
            raise RuntimeError("worker subprocess failed to start/announce")

    def sigkill(self) -> None:
        os.kill(self.proc.pid, signal.SIGKILL)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()


def _job(epochs: int, seed: int):
    from repro_torch.core.job import HPTJob, Param, SearchSpace
    space = SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        Param("learning_rate", "log", 0.001, 0.1),
    ])
    return HPTJob(workload="lenet-mnist", space=space, max_epochs=epochs,
                  seed=seed)


def _serial_baseline(scn: ChaosScenario):
    """The undisturbed run every SLO compares against: same job, same
    tuner, serial in-process execution on the deterministic sim backend.
    A PipeTune baseline gets its own fresh ground-truth store — the same
    starting state the disturbed run's shared TCP store had."""
    from repro_torch.api import Experiment
    exp = (Experiment(_job(scn.epochs, scn.seed))
           .with_tuner(scn.tuner)
           .with_backend("sim")
           .with_scheduler("hyperband"))
    if scn.tuner == "pipetune":
        from repro_torch.core import GroundTruth
        exp.with_groundtruth(GroundTruth())
    return exp.run()


def run_scenario(scenario: ChaosScenario,
                 trace_path: Optional[str] = None,
                 bus: Optional[EventBus] = None) -> ChaosReport:
    """Execute one scenario end to end and judge it (module docstring).
    Always tears its processes/servers down, pass or fail."""
    from repro_torch.api import Experiment, make_scheduler
    from repro_torch.service import (CoordinatorService,
                               ElasticWorkerPoolExecutor, GroundTruthService,
                               serve, serve_coordinator)

    bus = bus if bus is not None else EventBus()
    mem = MemorySink()
    bus.add_sink(mem)
    sink = JsonlSink(trace_path) if trace_path else None
    if sink is not None:
        bus.add_sink(sink)

    t0 = time.time()
    fault = scenario.fault
    procs: List[_WorkerProc] = []
    proxies: List[ChaosProxy] = []
    servers = []
    store_service = None
    ex = None
    collector = None
    try:
        # -- topology: coordinator (maybe proxied), optional store ---------
        coord_svc = CoordinatorService(ttl_s=scenario.ttl_s)
        coord_svc.bus = bus
        coord_server = serve_coordinator(coord_svc, port=0, background=True)
        servers.append(coord_server)
        coord_direct = f"tcp://127.0.0.1:{coord_server.server_address[1]}"
        coord_addr = coord_direct
        coord_proxy = None
        if isinstance(fault, PartitionCoordinator):
            coord_proxy = ChaosProxy(tuple(coord_server.server_address[:2]))
            proxies.append(coord_proxy)
            coord_addr = coord_proxy.tcp

        store_addr = None
        store_proxy = None
        if scenario.with_store or isinstance(fault, PartitionStore):
            store_service = GroundTruthService()
            store_service.bus = bus
            store_server = serve(store_service, port=0, background=True)
            servers.append(store_server)
            up = tuple(store_server.server_address[:2])
            if isinstance(fault, PartitionStore):
                store_proxy = ChaosProxy(up)
                proxies.append(store_proxy)
                store_addr = store_proxy.tcp
            else:
                store_addr = f"tcp://{up[0]}:{up[1]}"

        # -- workers -------------------------------------------------------
        worker_proxy = None
        worker_proxy_addr = None
        if isinstance(fault, PartitionWorker):
            # the pool must dial the proxy, so the victim announces the
            # proxy's address; the proxy needs its upstream up front, so
            # reserve the victim's port before the subprocess exists
            victim_port = _reserve_port()
            worker_proxy = ChaosProxy(("127.0.0.1", victim_port))
            proxies.append(worker_proxy)
            worker_proxy_addr = worker_proxy.tcp
            procs.append(_WorkerProc(
                coord_addr, store=store_addr, port=victim_port,
                advertise=tuple(worker_proxy.address[:2])))
        for _ in range(scenario.n_workers - len(procs)):
            procs.append(_WorkerProc(coord_addr, store=store_addr))
        slow_addr = None
        if isinstance(fault, SlowWorker):
            procs.append(_WorkerProc(coord_addr, store=store_addr,
                                     speed_factor=fault.speed_factor))
            slow_addr = procs[-1].address

        # -- the experiment, gated so the fault lands mid-run --------------
        # the runner spec (tuner/backend names + the store address) is
        # derived by Experiment.run via configure_runner_spec, exactly the
        # production path
        ex = ElasticWorkerPoolExecutor(coord_addr, refresh_s=0.1)
        ex.attach_bus(bus)
        # distributed trace: the chaos run exercises the full cross-process
        # path — worker subprocesses and the store forward their events home
        # through the collector, so the CI trace artifact is one merged
        # timeline that `python -m repro_torch.obs analyze` can profile
        from repro_torch.obs.forward import start_collector
        collector = start_collector(bus)
        ex.enable_trace(collector=collector.address)
        job = _job(scenario.epochs, scenario.seed)
        sched = _GatedScheduler(make_scheduler("hyperband", job),
                                gate_after=scenario.gate_after_wave)
        exp = (Experiment(job).with_tuner(scenario.tuner)
               .with_backend("sim").with_scheduler(sched))
        if store_addr:
            from repro_torch.service.dispatch import parse_tcp_address
            from repro_torch.service.transport import (SocketTransport,
                                                 StoreClient)
            exp.with_groundtruth(
                StoreClient(SocketTransport(*parse_tcp_address(store_addr))))
        holder: Dict[str, Any] = {}

        def run():
            try:
                holder["res"] = exp.run(executor=ex)
            except BaseException as e:              # noqa: BLE001
                holder["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()

        n_expected = len(procs)
        deadline = time.time() + 60.0
        while len(ex.workers) < n_expected and time.time() < deadline:
            time.sleep(0.05)
        assert sched.reached.wait(timeout=120.0), \
            "experiment never reached the gated wave"

        # -- inject --------------------------------------------------------
        t_kill: Optional[float] = None
        victims: List[str] = []
        if isinstance(fault, KillWorkers):
            t_kill = time.time()
            for p in procs[:fault.victims]:
                victims.append(p.address)
                p.sigkill()
            sched.gate.set()
        elif isinstance(fault, PartitionWorker):
            # sever the victim's live dispatch connection, then release
            # the gate: the freed wave's run_many batch dies on the dead
            # path — and the partition never heals, so with the worker
            # still heartbeating only transport-death retirement can
            # re-place the batch
            t_kill = time.time()
            victims.append(worker_proxy_addr)
            worker_proxy.set_mode(fault.mode)
            sched.gate.set()
        elif isinstance(fault, (PartitionCoordinator, PartitionStore)):
            proxy = coord_proxy if isinstance(fault, PartitionCoordinator) \
                else store_proxy
            proxy.set_mode(fault.mode)
            sched.gate.set()            # partition overlaps the live waves
            time.sleep(fault.duration_s)
            if isinstance(fault, PartitionCoordinator):
                # observe the silence before healing: pruning runs inside
                # request handling, and the partition blocks every remote
                # caller — so poke the in-process service directly, the
                # way a real deployment's timer or any live client would
                coord_svc.handle({"op": "version"})
            proxy.set_mode("pass")
        else:                           # SlowWorker: topology IS the fault
            sched.gate.set()

        t.join(timeout=240.0)
        if t.is_alive():
            raise RuntimeError(
                f"experiment hung after fault injection "
                f"({scenario.name}); events so far: {len(mem.records)}")
        if "error" in holder:
            raise RuntimeError(
                f"experiment died instead of recovering: "
                f"{holder['error']}") from holder["error"]

        # -- judge ---------------------------------------------------------
        serial = _serial_baseline(scenario)
        report = _evaluate(scenario, mem.records, holder["res"], serial,
                           t_kill, victims, slow_addr, bus,
                           time.time() - t0)
        return report
    finally:
        if ex is not None:
            try:
                ex.close()
            except Exception:                       # noqa: BLE001
                pass
        for p in procs:
            p.kill()
        if collector is not None:
            try:
                collector.close()
            except Exception:                       # noqa: BLE001
                pass
        for proxy in proxies:
            proxy.close()
        for server in servers:
            server.shutdown()
        if store_service is not None:
            store_service.close()
        if sink is not None:
            sink.close()


# ---------------------------------------------------------------------------
# SLO evaluation (pure: events + results in, verdicts out)
# ---------------------------------------------------------------------------

def _evaluate(scn: ChaosScenario, records: List[dict], result, serial,
              t_kill: Optional[float], victims: List[str],
              slow_addr: Optional[str], bus: EventBus,
              wall_s: float) -> ChaosReport:
    slos: List[SLOResult] = []
    slo = scn.slo

    # recovery: kill -> the pool retiring the victim (either path: its
    # transport died on the next dispatch, or the roster pruned it)
    recovery_s = None
    if t_kill is not None and victims:
        worst = None
        missing = []
        for v in victims:
            retire = [r for r in records if r["kind"] == "worker_retired"
                      and r["worker"] == v and r["ts"] >= t_kill
                      and r.get("reason") in ("worker_lost", "roster")]
            if not retire:
                missing.append(v)
                continue
            dt = retire[0]["ts"] - t_kill
            worst = dt if worst is None else max(worst, dt)
        budget = scn.retire_budget_s()
        recovery_s = worst
        ok = not missing and worst is not None and worst <= budget
        slos.append(SLOResult(
            "time_to_retire_s", ok,
            round(worst, 3) if worst is not None else None,
            f"<= {budget:.1f}",
            f"never retired: {missing}" if missing else ""))

    # replacement: every trial dispatched to a victim either completed on
    # it before the kill or was re-dispatched to a survivor and completed
    replaced = 0
    if victims:
        lost, never_done = [], []
        for v in victims:
            tids = {r["trial_id"] for r in records
                    if r["kind"] == "trial_dispatched" and r["worker"] == v}
            for tid in sorted(tids):
                done_on_victim = any(
                    r["kind"] == "trial_completed" and r["worker"] == v
                    and r["trial_id"] == tid and not r.get("error")
                    and (t_kill is None or r["ts"] <= t_kill)
                    for r in records)
                moved = [r for r in records
                         if r["kind"] == "trial_dispatched"
                         and r["trial_id"] == tid and r["worker"] != v
                         and (t_kill is None or r["ts"] >= t_kill)]
                done_elsewhere = any(
                    r["kind"] == "trial_completed" and r["worker"] != v
                    and r["trial_id"] == tid and not r.get("error")
                    for r in records)
                if moved and done_elsewhere:
                    replaced += 1
                elif not done_on_victim:
                    (never_done if not moved else lost).append(tid)
        if slo.require_replacement:
            ok = not lost and not never_done and replaced >= 1
            slos.append(SLOResult(
                "trials_replaced", ok, replaced, ">= 1, none lost",
                f"stranded={never_done} incomplete={lost}"
                if (lost or never_done) else ""))

    # epochs: per-trial epoch sequences match the undisturbed run exactly
    if slo.no_lost_epochs:
        bad = []
        for tid, rec in serial.records.items():
            got = result.records.get(tid)
            if got is None or len(got.epochs) != len(rec.epochs) or \
                    [e.accuracy for e in got.epochs] != \
                    [e.accuracy for e in rec.epochs]:
                bad.append(tid)
        extra = sorted(set(result.records) - set(serial.records))
        ok = not bad and not extra
        slos.append(SLOResult(
            "no_lost_or_repeated_epochs", ok,
            f"{len(serial.records) - len(bad)}/{len(serial.records)} trials",
            "exact", f"mismatched={bad[:5]} extra={extra[:5]}"
            if not ok else ""))

    # determinism: the fault changed *where and when*, never *what*
    if slo.bit_identical:
        ok = (result.best_score == serial.best_score
              and sorted(result.records) == sorted(serial.records))
        slos.append(SLOResult(
            "bit_identical_scores", ok,
            f"best={result.best_score:.6f}",
            f"serial best={serial.best_score:.6f}",
            "" if ok else "disturbed run diverged from serial"))

    if slo.min_heartbeats_missed:
        n = sum(1 for r in records if r["kind"] == "heartbeat_missed")
        slos.append(SLOResult(
            "heartbeats_missed", n >= slo.min_heartbeats_missed, n,
            f">= {slo.min_heartbeats_missed}",
            "the partition never provably bit" if n == 0 else ""))

    # degraded node: weighted placement must shed load onto the fast nodes
    if slo.max_dispatch_share is not None and slow_addr is not None:
        pool_dispatch = [r for r in records if r["kind"] == "trial_dispatched"
                         and r["worker"].startswith("tcp://")]
        n_slow = sum(1 for r in pool_dispatch if r["worker"] == slow_addr)
        share = n_slow / max(1, len(pool_dispatch))
        slos.append(SLOResult(
            "slow_node_dispatch_share", share <= slo.max_dispatch_share,
            f"{share:.2f} ({n_slow}/{len(pool_dispatch)})",
            f"<= {slo.max_dispatch_share}",
            "" if share <= slo.max_dispatch_share
            else "placement overloaded the degraded node"))

    return ChaosReport(
        scenario=scn.name, passed=all(s.ok for s in slos), slos=slos,
        recovery_s=None if recovery_s is None else round(recovery_s, 3),
        replaced=replaced, n_events=len(records), wall_s=round(wall_s, 2),
        counters=dict(bus.counters))
