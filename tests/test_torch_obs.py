"""The port's observability and chaos modules (``repro_torch.obs``: sinks,
metrics endpoint, chaos orchestrator, scenario pack, the launcher's
``--trace``) against the reference's ``repro.obs``.

Host code, so "the same" means equal: ``render_metrics`` prints the
reference's text on the same event stream, the endpoint answers its ops
alike to a client of either package, ``MetricsStoreSink`` files the same
rows, ``_evaluate`` returns the reference's verdicts on the same records
(the clean recovery and each violation of the reference suite), and the
scenario pack has the reference's names, topologies and budgets. The
launcher's ``--trace`` writes a readable trace on the serial, parallel,
cluster and workers executors and is refused on an executor that cannot
attach a bus. The live chaos tests are ``slow``, as the reference's are.
"""
import dataclasses
import math
import socket
import threading
import time
import types

import pytest

import repro.obs.chaos as jchaos
import repro.obs.events as jevents
import repro.obs.metrics as jmetrics
import repro.obs.scenarios as jscenarios
import repro.obs.sinks as jsinks
import repro_torch.obs as tobs
import repro_torch.obs.chaos as tchaos
import repro_torch.obs.events as tevents
import repro_torch.obs.metrics as tmetrics
import repro_torch.obs.scenarios as tscenarios
import repro_torch.obs.sinks as tsinks
from repro_torch.api import registry
from repro_torch.launch import tune as tune_launch
from torch_service_util import assert_same

PKG = {"reference": (jevents, jmetrics, jsinks, jchaos),
       "port": (tevents, tmetrics, tsinks, tchaos)}


def _membership(ev):
    return [ev.WorkerJoined(worker="a"), ev.WorkerJoined(worker="b"),
            ev.WorkerRetired(worker="a", reason="leave"),
            ev.TrialDispatched(trial_id="t", worker="b"),
            ev.HeartbeatMissed(worker="a", age_s=3.0, ttl_s=2.0)]


def _mixed(ev):
    return _membership(ev) + [
        ev.TrialCompleted(trial_id="t", worker="b", score=0.5),
        ev.EpochCompleted(trial_id="t", worker="b", epoch=0,
                          duration_s=0.1),
        ev.StoreRefit(version=2, n_entries=9),
        ev.RpcCompleted(op="run", peer="tcp://b:1", duration_s=0.2,
                        overhead_s=0.01, n=1),
        ev.Resharded(trial_id="t", src="b", dst="c", at_s=2.5),
        ev.ClockSync(proc="b", offset_s=0.001, rtt_s=0.002),
        ev.ForwardDropped(proc="b", dropped=4)]


STREAMS = {"empty": lambda ev: [], "membership": _membership,
           "mixed": _mixed}


def _bus(pkg, stream, ingest=()):
    ev = PKG[pkg][0]
    bus = ev.EventBus().enable()
    for e in STREAMS[stream](ev):
        bus.emit(e)
    for rec in ingest:
        bus.ingest(dict(rec))
    return bus


# ------------------------------------------------------------- metrics

@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("prefix", [None, "pipetune"])
def test_render_metrics_prints_the_references_text(stream, prefix):
    remote = [{"kind": "trial_started", "seq": 7, "ts": 1.0,
               "trial_id": "t", "worker": "w", "epochs": 3, "proc": "w"}]
    kw = {} if prefix is None else {"prefix": prefix}
    ours = tmetrics.render_metrics(_bus("port", stream, remote), **kw)
    theirs = jmetrics.render_metrics(_bus("reference", stream, remote),
                                     **kw)
    assert ours == theirs
    assert f"{prefix or 'repro'}_events_total " in ours


@pytest.mark.parametrize("client", ["port", "reference"])
def test_obs_endpoint_answers_as_the_references(client):
    """The port's endpoint over a bus and the reference's over the same
    stream answer each op alike to a client of either package."""
    buses = {pkg: _bus(pkg, "membership") for pkg in PKG}
    servers = {pkg: PKG[pkg][1].serve_obs(buses[pkg], port=0,
                                          background=True) for pkg in PKG}
    try:
        got = {}
        for pkg, srv in servers.items():
            c = PKG[client][1].ObsClient(
                f"tcp://127.0.0.1:{srv.server_address[1]}")
            text, counters = c.metrics(), c.counters()
            first = [(e["kind"], e["seq"]) for e in c.tail(limit=3)]
            rest = [(e["kind"], e["seq"]) for e in c.tail()]
            empty = c.tail()
            buses[pkg].emit(PKG[pkg][0].TrialCompleted(
                trial_id="t", worker="b", score=1.0))
            late = [e["kind"] for e in c.tail()]
            bad = c.transport.request({"op": "nope"})
            c.close()
            got[pkg] = (text, counters, first, rest, empty, late, c.cursor,
                        bad)
        assert got["port"] == got["reference"]
        text = got["port"][0]
        assert "repro_workers_live 1" in text
        assert "repro_trials_inflight 1" in text
        assert got["port"][6] == 6 and got["port"][7]["ok"] is False
    finally:
        for srv in servers.values():
            srv.shutdown()


# ---------------------------------------------------------------- sinks

def test_metrics_store_sink_files_the_references_rows(tmp_path):
    """The same records through each package's ``MetricsStoreSink`` into
    its ``MetricsStore`` give equal query results."""
    from repro.core.store import MetricsStore as JStore
    from repro_torch.core.store import MetricsStore as TStore
    recs = [{"kind": "worker_retired", "ts": 10.5, "seq": 1,
             "worker": "tcp://h:1", "reason": "heartbeat"},
            {"kind": "trial_dispatched", "ts": 11.0, "seq": 2,
             "trial_id": "t0", "worker": "tcp://h:2"},
            {"kind": "store_refit", "ts": 12.25, "seq": 3, "version": 4,
             "n_entries": 9, "trace": "f" * 16, "proc": "store@h:3"}]
    rows = {}
    for pkg, store_cls in (("port", TStore), ("reference", JStore)):
        with store_cls(str(tmp_path / pkg)) as store:
            sink = PKG[pkg][2].MetricsStoreSink(store)
            for r in recs:
                sink(dict(r))
            store.flush()
            rows[pkg] = [store.query("events", tags={"kind": k})
                         for k in ("worker_retired", "trial_dispatched",
                                   "store_refit")] + \
                [store.query("events", tags={"trial_id": "t0"})]
    assert_same(rows["port"], rows["reference"])
    assert rows["port"][0][0]["fields"]["reason"] == "heartbeat"


def test_memory_sink_decodes_typed_events():
    bus = tevents.EventBus()
    mem = tsinks.MemorySink()
    bus.add_sink(mem)
    for e in _mixed(tevents):
        bus.emit(e)
    typed = mem.typed()
    assert [type(e).__name__ for e in typed] == \
        [type(e).__name__ for e in _mixed(tevents)]
    assert len(mem.of_kind("worker_joined")) == 2


# -------------------------------------------------------- SLO verdicts

def _fake_result(trials, best=0.9):
    rec = lambda accs: types.SimpleNamespace(     # noqa: E731
        epochs=[types.SimpleNamespace(accuracy=a) for a in accs])
    return types.SimpleNamespace(
        records={tid: rec(accs) for tid, accs in trials.items()},
        best_score=best)


def _mk_records(t_kill):
    mk = lambda kind, ts, **kw: {"kind": kind, "ts": ts, **kw}  # noqa: E731
    v, s = "tcp://victim:1", "tcp://survivor:2"
    return [
        mk("worker_joined", t_kill - 5.0, worker=v),
        mk("worker_joined", t_kill - 5.0, worker=s),
        mk("trial_dispatched", t_kill - 4.0, trial_id="t0", worker=v),
        mk("trial_dispatched", t_kill - 4.0, trial_id="t1", worker=s),
        mk("trial_completed", t_kill - 3.0, trial_id="t1", worker=s,
           error=None),
        mk("worker_retired", t_kill + 1.5, worker=v, reason="worker_lost"),
        mk("trial_dispatched", t_kill + 1.6, trial_id="t0", worker=s),
        mk("trial_completed", t_kill + 2.0, trial_id="t0", worker=s,
           error=None),
    ]


T_KILL = 1000.0
TRIALS = {"t0": [0.5, 0.6], "t1": [0.7]}
VICTIM = "tcp://victim:1"


def _slo_case(case, chaos):
    """(scenario, records, result, serial, t_kill, victims, slow) of one
    case of the reference suite's SLO tests, built from `chaos`."""
    kill = chaos.ChaosScenario(name="synthetic", description="", ttl_s=2.0,
                               fault=chaos.KillWorkers(victims=1))
    ok = _fake_result(TRIALS)
    if case == "clean":
        return kill, _mk_records(T_KILL), ok, ok, T_KILL, [VICTIM], None
    if case == "never-retired":
        recs = [r for r in _mk_records(T_KILL)
                if not (r["ts"] > T_KILL or r["kind"] == "worker_retired")]
        bad = _fake_result({"t0": [0.5, 0.99], "t1": [0.7]}, best=0.1)
        return kill, recs, bad, ok, T_KILL, [VICTIM], None
    if case == "late-retire":
        recs = _mk_records(T_KILL)
        recs[5] = {**recs[5], "ts": T_KILL + kill.retire_budget_s() + 1.0}
        return kill, recs, ok, ok, T_KILL, [VICTIM], None
    if case == "no-heartbeat-missed":
        scn = chaos.ChaosScenario(
            name="part", description="",
            fault=chaos.PartitionCoordinator(),
            slo=chaos.SLOBudget(require_replacement=False,
                                min_heartbeats_missed=1))
        return scn, _mk_records(T_KILL), ok, ok, None, [], None
    if case == "slow-node":
        scn = chaos.ChaosScenario(
            name="slow", description="",
            slo=chaos.SLOBudget(require_replacement=False,
                                max_dispatch_share=0.25))
        slow = "tcp://slow:3"
        recs = _mk_records(T_KILL) + [
            {"kind": "trial_dispatched", "ts": T_KILL, "trial_id": f"s{i}",
             "worker": slow} for i in range(3)]
        return scn, recs, ok, ok, None, [], slow
    raise KeyError(case)


@pytest.mark.parametrize("case", ["clean", "never-retired", "late-retire",
                                  "no-heartbeat-missed", "slow-node"])
def test_slo_verdicts_equal_the_references(case):
    reports = {}
    for pkg in PKG:
        chaos = PKG[pkg][3]
        scn, recs, res, serial, t_kill, victims, slow = \
            _slo_case(case, chaos)
        reports[pkg] = chaos._evaluate(scn, recs, res, serial, t_kill,
                                       victims, slow,
                                       PKG[pkg][0].EventBus(), 3.0)
    ours, theirs = reports["port"], reports["reference"]
    assert_same(dataclasses.asdict(ours), dataclasses.asdict(theirs))
    assert ours.summary() == theirs.summary()
    by_name = {s.name: s for s in ours.slos}
    if case == "clean":
        assert ours.passed and ours.recovery_s == 1.5 and ours.replaced == 1
    else:
        assert not ours.passed
    if case == "never-retired":
        assert "never retired" in by_name["time_to_retire_s"].detail
        assert not by_name["bit_identical_scores"].ok


def _as_plain(scn):
    return {"type": type(scn).__name__, "fault": type(scn.fault).__name__,
            **dataclasses.asdict(scn), "budget": scn.retire_budget_s()}


def test_scenario_pack_is_the_references():
    ours, theirs = tscenarios.SCENARIOS, jscenarios.SCENARIOS
    assert list(ours) == list(theirs) and len(ours) == 6
    for name in ours:
        assert_same(_as_plain(ours[name]), _as_plain(theirs[name]))
    assert tobs.SCENARIOS is ours
    assert isinstance(ours["sigkill_worker"], tobs.ChaosScenario)


def test_obs_package_exports_the_references_names_without_torch():
    import subprocess
    import sys

    import repro.obs as jobs
    port_only = ["spans"]       # spans inside the port's hot path
    assert [n for n in tobs.__all__ if n not in port_only] == jobs.__all__
    assert sorted(tobs._LAZY) == sorted(list(jobs._LAZY) + port_only)
    for name in tobs.__all__:
        assert getattr(tobs, name) is not None
    code = ("import sys, repro_torch.obs as o; o.EventBus().enable(); "
            "print('torch' in sys.modules)")
    from torch_service_util import ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "False", out.stderr


# ------------------------------------------------------------ the proxy

def _echo_server():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)

    def serve():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return

            def pump(c=c):
                with c:
                    while True:
                        data = c.recv(1024)
                        if not data:
                            return
                        c.sendall(data)
            threading.Thread(target=pump, daemon=True).start()
    threading.Thread(target=serve, daemon=True).start()
    return srv


def test_chaos_proxy_passes_blackholes_and_refuses():
    upstream = _echo_server()
    proxy = tchaos.ChaosProxy(upstream.getsockname())
    try:
        c = socket.create_connection(proxy.address, timeout=5)
        c.sendall(b"ping")
        assert c.recv(16) == b"ping"
        proxy.set_mode("blackhole")
        time.sleep(0.3)                     # the pumps see the mode
        c.sendall(b"held")
        c.settimeout(0.3)
        with pytest.raises(socket.timeout):
            c.recv(16)
        proxy.set_mode("pass")              # bytes were paused, not lost
        c.settimeout(5)
        assert c.recv(16) == b"held"
        proxy.set_mode("refuse")            # live pipes close
        assert c.recv(16) == b""
        c.close()
        late = socket.create_connection(proxy.address, timeout=5)
        late.settimeout(2)
        try:
            data = late.recv(16)
        except (ConnectionResetError, socket.timeout):
            data = b""
        assert data == b""
        late.close()
        with pytest.raises(ValueError, match="unknown proxy mode"):
            proxy.set_mode("drop")
    finally:
        proxy.close()
        upstream.close()


# ----------------------------------------------------- the launcher flag

@pytest.mark.parametrize("flags", [
    [], ["--parallelism", "2"], ["--executor", "cluster"],
    ["--workers", "sim,sim"]], ids=["serial", "parallel", "cluster",
                                    "workers"])
def test_launcher_trace_writes_a_readable_trace(tmp_path, flags):
    path = str(tmp_path / "run.jsonl")
    res = tune_launch.main(["--backend", "sim", "--epochs", "3",
                            "--trace", path, *flags])
    recs = tsinks.read_trace(path)
    kinds = {r["kind"] for r in recs}
    assert {"trial_dispatched", "trial_completed"} <= kinds
    done = [r for r in recs if r["kind"] == "trial_completed"]
    assert {r["trial_id"] for r in done} == set(res.records)
    if flags[:2] == ["--executor", "cluster"]:
        assert "epoch_completed" in kinds       # the engine's sim events
    n = len(recs)
    tune_launch.main(["--backend", "sim", "--epochs", "3", "--trace", path,
                      *flags])
    assert len(tsinks.read_trace(path)) == 2 * n    # appended, same run


def test_launcher_trace_on_the_cluster_gives_the_references_stream(
        tmp_path, monkeypatch):
    import sys

    from repro.launch import tune as jtune
    paths = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in PKG}
    argv = ["--backend", "sim", "--epochs", "9", "--executor", "cluster"]
    tune_launch.main(argv + ["--trace", paths["port"]])
    monkeypatch.setattr(sys, "argv",
                        ["tune"] + argv + ["--trace", paths["reference"]])
    jtune.main()

    def shape(recs):
        # a worker's label carries its object's id: number them instead
        names = {}
        return [(r["kind"], r.get("trial_id"), r.get("epoch"),
                 names.setdefault(r.get("worker"), len(names)),
                 r.get("node"), r.get("reason"), r.get("duration_s"))
                for r in recs]
    ours = tsinks.read_trace(paths["port"])
    assert shape(ours) == shape(jsinks.read_trace(paths["reference"]))
    assert ours


def test_launcher_trace_is_refused_without_a_bus(monkeypatch):
    class Busless:
        def run_wave(self, runner, workload, proposals):
            raise AssertionError("never reached")

        def close(self):
            pass

    monkeypatch.setitem(registry._EXECUTORS, "busless", Busless)
    with pytest.raises(ValueError, match="--trace conflicts with "
                                         "--executor busless"):
        tune_launch.main(["--backend", "sim", "--epochs", "3",
                          "--executor", "busless", "--trace", "x.jsonl"])


# ---------------------------------------------------- the pool's context

def test_enable_trace_stamps_the_pool_and_late_joiners():
    from repro_torch.api import WorkerPoolExecutor
    from repro_torch.core.worker import InprocWorker

    class Traceable(InprocWorker):
        def __init__(self):
            super().__init__()
            self.traced = []

        def enable_trace(self, trace_id, collector=None):
            self.traced.append((trace_id, collector))
            return True

    first = Traceable()
    ex = WorkerPoolExecutor([first])
    bus = tevents.EventBus()
    mem = tsinks.MemorySink()
    bus.add_sink(mem)
    ex.attach_bus(bus)
    tid = ex.enable_trace(collector="tcp://127.0.0.1:9")
    assert bus.trace_id == tid and bus.proc == "driver" and bus.enabled
    assert ex.trace_context == {"trace_id": tid,
                                "collector": "tcp://127.0.0.1:9"}
    assert ex.trace_bus is bus
    late = Traceable()
    ex.add_worker(late)
    assert first.traced == late.traced == [(tid, "tcp://127.0.0.1:9")]
    assert ex.enable_trace("a" * 16) == "a" * 16
    assert all(r["trace"] == tid for r in mem.of_kind("worker_joined"))
    ex.close()


# ------------------------------------------ live chaos (slow, real procs)

@pytest.mark.slow
def test_chaos_partition_coordinator_scenario_live():
    """A refused coordinator mid-run: the pool keeps driving on the roster
    it has, heartbeats provably miss, and results stay serial-identical."""
    report = tchaos.run_scenario(tscenarios.SCENARIOS[
        "partition_coordinator"])
    assert report.passed, report.summary()
    assert report.counters.get("heartbeat_missed", 0) >= 1


@pytest.mark.slow
def test_chaos_trace_artifact_is_readable(tmp_path, capsys):
    """``python -m repro_torch.obs chaos sigkill_worker --trace``: the run
    passes its SLOs and its artifact decodes into typed events that both
    packages analyze into one report."""
    import repro.obs.trace as jtrace
    import repro_torch.obs.__main__ as tcli
    import repro_torch.obs.trace as ttrace
    path = str(tmp_path / "chaos.jsonl")
    t0 = time.time()
    assert tcli.main(["chaos", "sigkill_worker", "--trace", path]) == 0
    out = capsys.readouterr().out
    assert "'sigkill_worker': PASS" in out and "time_to_retire_s" in out
    recs = tsinks.read_trace(path)
    decoded = [tevents.event_from_dict(r) for r in recs]
    kinds = {e.kind for _, _, e in decoded}
    assert {"worker_joined", "trial_dispatched", "trial_completed",
            "worker_retired", "resharded", "epoch_completed"} <= kinds
    lost = [ts for ts, _, e in decoded if isinstance(e, tevents.WorkerRetired)
            and e.reason in ("worker_lost", "roster")]
    assert lost and all(t0 <= ts <= time.time() for ts in lost)
    report = ttrace.analyze_trace(recs)
    assert_same(report, jtrace.analyze_trace(recs))
    assert len(report["trace_ids"]) == 1 and not math.isnan(
        report["breakdown"]["wall_s"])
