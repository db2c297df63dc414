"""The port's distributed tracing (``repro_torch.obs.forward``, ``.trace``,
``.sinks``, the CLI) against the reference's ``repro.obs``.

This is host code, so "the same" means equal: on the same records the port's
``analyze_trace`` returns the reference's report and ``render_report`` its
text, for the reference test suite's fixtures (clock skew, rung resumes,
residual skew, orphans, forward drops) and for a live traced run. A JSONL
trace written by either package's sink is read by the other's
``read_trace`` (torn last line included); a ``ForwardingSink`` of either
package ships to a ``TraceCollector`` of the other over loopback TCP; the
``obs_trace`` hello and the ``_trace`` metadata behave as the reference's on
all three codecs. The last test (``slow``, as the reference's) drives
``--workers --trace`` against a ``python -m repro_torch.worker`` process
and a TCP store and reads one merged timeline back.
"""
import argparse
import json
import socket
import threading
import time

import pytest

import repro.obs.__main__ as jcli
import repro.obs.events as jevents
import repro.obs.forward as jforward
import repro.obs.sinks as jsinks
import repro.obs.trace as jtrace
import repro.service as jservice
import repro_torch.obs.__main__ as tcli
import repro_torch.obs.events as tevents
import repro_torch.obs.forward as tforward
import repro_torch.obs.sinks as tsinks
import repro_torch.obs.trace as ttrace
import repro_torch.service as tservice
from repro.api import Experiment as JExperiment
from repro.api import RemoteWorker as JRemoteWorker
from repro.api import WorkerPoolExecutor as JWorkerPoolExecutor
from repro_torch.api import Experiment, RemoteWorker, WorkerPoolExecutor
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.obs.metrics import ObsClient, ObsUnreachable, serve_obs
from torch_service_util import assert_same, spawn, stop

PKG = {"reference": (jevents, jforward, jsinks, jtrace, jservice, jcli),
       "port": (tevents, tforward, tsinks, ttrace, tservice, tcli)}


def _space():
    return SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        Param("learning_rate", "log", 0.001, 0.1)])


def _job(epochs=9):
    return HPTJob(workload="lenet-mnist", space=_space(), max_epochs=epochs)


def _jjob(epochs=9):
    from repro.core.job import HPTJob as JJob, Param as JParam, \
        SearchSpace as JSpace
    return JJob(workload="lenet-mnist", max_epochs=epochs, space=JSpace([
        JParam("batch_size", "choice", choices=(32, 64, 256, 1024)),
        JParam("learning_rate", "log", 0.001, 0.1)]))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(pkg, handler):
    server = PKG[pkg][4].JsonRPCServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


# ---------------------------------------------------- the analyzer's input

def _rec(kind, ts, seq, **kw):
    r = {"kind": kind, "ts": ts, "seq": seq, "trace": "t" * 16}
    r.update(kw)
    return r


def _synthetic_run():
    """The reference suite's fixture: driver + one worker whose clock runs
    0.5 s ahead, two trials; t1 resumes once; t2 is gated by t1."""
    w = "tcp://w:1"
    return [
        _rec("clock_sync", 0.0, 1, proc=w, offset_s=0.5, rtt_s=0.001),
        _rec("trial_dispatched", 0.0, 2, proc="driver", trial_id="t1",
             worker=w),
        _rec("trial_started", 0.51, 3, proc=w, trial_id="t1", worker=w),
        _rec("epoch_completed", 0.7, 4, proc=w, trial_id="t1", worker=w,
             epoch=0, duration_s=0.19),
        _rec("trial_completed", 0.3, 5, proc="driver", trial_id="t1",
             worker=w, score=0.5),
        _rec("rpc_completed", 0.3, 6, proc="driver", op="run", peer=w,
             duration_s=0.3, overhead_s=0.05),
        _rec("trial_dispatched", 0.4, 7, proc="driver", trial_id="t1",
             worker=w),
        _rec("trial_started", 0.91, 8, proc=w, trial_id="t1", worker=w),
        _rec("epoch_completed", 1.1, 9, proc=w, trial_id="t1", worker=w,
             epoch=1, duration_s=0.19),
        _rec("trial_completed", 0.7, 10, proc="driver", trial_id="t1",
             worker=w, score=0.8),
        _rec("rpc_completed", 0.7, 11, proc="driver", op="run", peer=w,
             duration_s=0.3, overhead_s=0.04),
        _rec("trial_dispatched", 0.75, 12, proc="driver", trial_id="t2",
             worker=w),
        _rec("trial_completed", 1.0, 13, proc="driver", trial_id="t2",
             worker=w, score=0.9),
        _rec("rpc_completed", 1.0, 14, proc="driver", op="refit",
             peer="store@h:1", duration_s=0.02, overhead_s=0.02),
    ]


def _residual_skew():
    w = "tcp://w:1"
    return [
        _rec("trial_dispatched", 1.0, 1, proc="driver", trial_id="t",
             worker=w),
        _rec("trial_started", 0.9985, 2, proc=w, trial_id="t", worker=w),
        _rec("trial_completed", 1.4, 3, proc="driver", trial_id="t",
             worker=w, score=1.0),
    ]


def _orphans_and_drops():
    return _synthetic_run() + [
        _rec("epoch_completed", 0.5, 90, proc="tcp://w:1",
             trial_id="ghost", worker="tcp://w:1", epoch=0,
             duration_s=0.1),
        _rec("forward_dropped", 0.6, 91, proc="tcp://w:1", dropped=7)]


def _two_workers_skewed():
    """Two workers with opposite skews, a straggler and an error."""
    a, b = "tcp://a:1", "tcp://b:2"
    return [
        _rec("clock_sync", 0.0, 1, proc=a, offset_s=-0.25, rtt_s=0.004),
        _rec("clock_sync", 0.0, 2, proc=a, offset_s=-0.2, rtt_s=0.001),
        _rec("clock_sync", 0.0, 3, proc=b, offset_s=0.125, rtt_s=0.002),
        _rec("trial_dispatched", 0.0, 4, proc="driver", trial_id="x",
             worker=a),
        _rec("trial_dispatched", 0.0, 5, proc="driver", trial_id="y",
             worker=b),
        _rec("trial_started", -0.19, 6, proc=a, trial_id="x", worker=a),
        _rec("trial_started", 0.13, 7, proc=b, trial_id="y", worker=b),
        _rec("epoch_completed", 0.2, 8, proc=a, trial_id="x", worker=a,
             epoch=0, duration_s=0.35),
        _rec("trial_completed", 0.45, 9, proc="driver", trial_id="x",
             worker=a, score=0.4),
        _rec("epoch_completed", 1.6, 10, proc=b, trial_id="y", worker=b,
             epoch=0, duration_s=1.4),
        _rec("trial_completed", 1.5, 11, proc="driver", trial_id="y",
             worker=b, score=float("nan"), error="RuntimeError: boom"),
        _rec("rpc_completed", 1.5, 12, proc="driver", op="run_many",
             peer=b, duration_s=1.5, overhead_s=0.1),
        _rec("store_refit", 1.2, 13, proc="store@h:1", version=2,
             n_entries=4),
    ]


CASES = {"skew-and-resume": _synthetic_run, "residual-skew": _residual_skew,
         "orphans-and-drops": _orphans_and_drops,
         "two-workers": _two_workers_skewed, "empty": lambda: []}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reports_and_text_equal_the_reference(case):
    records = CASES[case]()
    ours = ttrace.analyze_trace(records)
    theirs = jtrace.analyze_trace(records)
    assert_same(ours, theirs)
    assert ttrace.render_report(ours) == jtrace.render_report(theirs)
    assert ttrace.clock_offsets(records) == jtrace.clock_offsets(records)
    assert ttrace.merge_events(records) == jtrace.merge_events(records)


def test_report_fields_hold_the_reference_suites_values():
    """The reference suite's expectations, read off the port's report."""
    report = ttrace.analyze_trace(_synthetic_run())
    assert report["n_trials"] == 2 and report["n_segments"] == 3
    assert report["clock_offsets"]["tcp://w:1"] == pytest.approx(0.5)
    b = report["breakdown"]
    assert b["wall_s"] == pytest.approx(1.0)
    assert b["rpc_overhead_s"] == pytest.approx(0.09)
    assert b["store_wait_s"] == pytest.approx(0.02)
    assert [s["trial_id"] for s in report["critical_path"]["segments"]] \
        == ["t1", "t1", "t2"]
    assert report["workers"][0]["busy_s"] == pytest.approx(0.85)
    tr = ttrace.build_trace(_residual_skew())
    assert not tr.orphans and tr.trials["t"].segments[0].queue_wait_s == 0
    bad = ttrace.analyze_trace(_orphans_and_drops())
    assert bad["orphan_trials"] == ["ghost"] and bad["forward_dropped"] == 7
    assert "ORPHAN" in ttrace.render_report(bad)


# ------------------------------------------------------------ JSONL traces

@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_each_package_reads_the_others_trace(tmp_path, writer, reader):
    """Records emitted on one package's bus through its ``attach_trace``
    come back equal through the other's ``read_trace``, the torn last line
    of a killed writer dropped, with or without its newline."""
    ev = PKG[writer][0]
    path = str(tmp_path / "t.jsonl")
    bus = ev.EventBus()
    bus.trace_id, bus.proc = "a" * 16, "driver"
    sink = PKG[writer][2].attach_trace(bus, path)
    bus.emit(ev.TrialDispatched(trial_id="t0", worker="tcp://w:1"))
    bus.emit(ev.EpochCompleted(trial_id="t0", worker="tcp://w:1", epoch=0,
                               duration_s=0.1 + 0.2))
    bus.emit(ev.StoreRefit(version=3, n_entries=7))
    sink.close()
    read = PKG[reader][2].read_trace
    own = PKG[writer][2].read_trace(path)
    assert read(path) == own and len(own) == 3
    assert read(path, kind="store_refit") == [own[2]]
    text = open(path).read()
    for tail in ('{"kind": "trial_co', '{"kind": "trial_co\n'):
        with open(path, "w") as f:
            f.write(text + tail)
        assert read(path) == own
    with open(path, "w") as f:
        f.write('{"kind": "trial_co\n' + text)
    with pytest.raises(ValueError):
        read(path)
    # the CLI of each package analyzes the other's file alike
    with open(path, "w") as f:
        for r in _synthetic_run():
            f.write(json.dumps(r) + "\n")
    loaded = PKG[reader][3].load_events([path])
    assert loaded == _synthetic_run()


def test_cli_analyze_and_chaos_list_print_the_references_text(tmp_path,
                                                               capsys):
    path = tmp_path / "trace.jsonl"
    sink = tsinks.JsonlSink(str(path))
    for r in _orphans_and_drops():
        sink(r)
    sink.close()
    outs = {}
    for pkg in PKG:
        cli = PKG[pkg][5]
        assert cli.main(["analyze", str(path)]) == 0
        table = capsys.readouterr().out
        assert cli.main(["analyze", str(path), "--json"]) == 0
        outs[pkg] = (table, json.loads(capsys.readouterr().out))
        assert cli.main(["chaos", "--list"]) == 0
        outs[pkg] += (capsys.readouterr().out,)
    assert outs["port"][0] == outs["reference"][0]
    assert_same(outs["port"][1], outs["reference"][1])
    assert outs["port"][2] == outs["reference"][2]
    assert tcli.main(["analyze", str(tmp_path / "missing.jsonl")]) == 1
    assert "error:" in capsys.readouterr().err
    (tmp_path / "empty.jsonl").write_text("")
    assert tcli.main(["analyze", str(tmp_path / "empty.jsonl")]) == 1
    assert "empty" in capsys.readouterr().err
    assert tcli.main(["chaos", "no_such_scenario"]) == 2


# ----------------------------------------------------------- forwarding

def test_forwarding_sink_drops_oldest_when_bounded(monkeypatch):
    monkeypatch.setattr(tforward.ForwardingSink, "_run", lambda self: None)
    sink = tforward.ForwardingSink("tcp://127.0.0.1:9", maxlen=8, batch=64)
    for i in range(20):
        sink({"seq": i})
    assert sink.dropped_total == 12
    assert [r["seq"] for r in sink._queue] == list(range(12, 20))
    sink.close(timeout=0.2)
    sink({"seq": 99})
    assert len(sink._queue) == 8


@pytest.mark.parametrize("sender,collector", [("reference", "port"),
                                              ("port", "reference")])
def test_forwarding_crosses_the_packages(sender, collector):
    """A ``ForwardingSink`` of one package ships batches and a drop receipt
    to the other's ``TraceCollector``: the collector's bus holds what the
    sender's own collector would, remote ``seq`` kept as ``rseq``."""
    ev = PKG[collector][0]
    home = ev.EventBus()
    mem = PKG[collector][2].MemorySink()
    home.add_sink(mem)
    coll = PKG[collector][1].start_collector(home)
    sink = PKG[sender][1].ForwardingSink(coll.address, proc="w", batch=4,
                                         flush_interval_s=0.05)
    try:
        for i in range(6):
            sink({"kind": "epoch_completed", "seq": i, "ts": float(i),
                  "proc": "w", "trial_id": "t", "epoch": i,
                  "duration_s": 0.25})
        assert sink.flush(timeout=5.0) and sink.dropped_total == 0
        got = mem.of_kind("epoch_completed")
        assert [r["rseq"] for r in got] == list(range(6))
        assert [r["seq"] for r in got] == list(range(1, 7))
        assert all(r["proc"] == "w" and r["trial_id"] == "t" for r in got)
        with sink._lock:
            sink._unreported_drops += 3
            sink._idle.clear()
        assert sink.flush(timeout=5.0)
        drops = mem.of_kind("forward_dropped")
        assert [(d["proc"], d["dropped"]) for d in drops] == [("w", 3)]
        assert home.counters == {"epoch_completed": 6,
                                 "forward_dropped": 1}
    finally:
        sink.close()
        coll.close(drain_s=0.1)


# ------------------------------------------------- obs_trace negotiation

@pytest.mark.parametrize("peer", ["legacy", "generic-ok", "dead"])
def test_propagate_trace_stays_untraced_on_a_legacy_peer(peer):
    """A peer that errors the hello, one that answers a generic ``ok``
    without echoing the trace, and one that hangs up: the port's client
    returns False and stamps nothing, as the reference's does."""
    handler = {"legacy": lambda req: {"ok": False, "error":
                                      f"unknown op {req.get('op')!r}"},
               "generic-ok": lambda req: {"ok": True},
               "dead": lambda req: (_ for _ in ()).throw(
                   tservice.DropConnection())}[peer]
    server = _serve("port", handler)
    try:
        for pkg in PKG:
            t = PKG[pkg][4].SocketTransport(
                "127.0.0.1", server.server_address[1], wire="json",
                connect_retries=1)
            bus = PKG[pkg][0].EventBus().enable()
            assert PKG[pkg][1].propagate_trace(t, "c" * 16, proc="p",
                                               bus=bus) is False
            assert t.trace is None and bus.events("clock_sync") == []
            t.close()
    finally:
        server.shutdown()


@pytest.mark.parametrize("client,server", [("port", "port"),
                                           ("port", "reference"),
                                           ("reference", "port")])
@pytest.mark.parametrize("service", ["store", "worker", "coordinator"])
def test_obs_trace_hello_across_the_packages(client, server, service):
    """The store, worker and coordinator services of either package adopt
    a trace from a client of either package: the client's transport starts
    stamping ``_trace``, its bus gets one ``clock_sync``, and the service's
    bus carries the trace id and the client's label."""
    mod = PKG[server][4]
    svc = {"store": mod.GroundTruthService,
           "worker": mod.TrialWorkerService,
           "coordinator": mod.CoordinatorService}[service]()
    svc.bus = PKG[server][0].EventBus()
    serve = {"store": mod.serve, "worker": mod.serve_worker,
             "coordinator": mod.serve_coordinator}[service]
    srv = serve(svc, port=0, background=True)
    t = PKG[client][4].SocketTransport("127.0.0.1", srv.server_address[1])
    bus = PKG[client][0].EventBus().enable()
    try:
        assert PKG[client][1].propagate_trace(t, "d" * 16, proc="tcp://x:1",
                                              bus=bus)
        assert t.trace == "d" * 16
        syncs = bus.events("clock_sync")
        assert len(syncs) == 1 and syncs[0]["proc"] == "tcp://x:1"
        assert svc.bus.trace_id == "d" * 16 and svc.bus.proc == "tcp://x:1"
        assert svc.bus.enabled and svc.bus.forward_sink is None
        assert t.request({"op": "version" if service == "store" else
                          "hello" if service == "worker" else
                          "roster"})["ok"]
    finally:
        t.close()
        srv.shutdown()
        if hasattr(svc, "close"):
            svc.close()


@pytest.mark.parametrize("wire", ["json", "tlv", "msgpack"])
def test_trace_metadata_rides_every_codec_as_the_references(wire):
    """A traced transport of either package adds ``_trace`` to public ops
    only, on every codec, and the server of either package decodes the
    same request; an untraced request carries no ``_trace``."""
    seen = {pkg: [] for pkg in PKG}

    def recorder(pkg):
        def handle(req):
            seen[pkg].append(dict(req))
            if req.get("op") == "_wire":
                return {"ok": True, "codec": req.get("codec")}
            return {"ok": True}
        return handle

    servers = {pkg: _serve(pkg, recorder(pkg)) for pkg in PKG}
    try:
        for client in PKG:
            for pkg, srv in servers.items():
                t = PKG[client][4].SocketTransport(
                    "127.0.0.1", srv.server_address[1], wire=wire)
                t.request({"op": "version", "x": 0.1 + 0.2})
                t.trace = "e" * 16
                t.request({"op": "lookup", "x": [1, 2.5]})
                t.request({"op": "_private"})
                t.close()
        for pkg in PKG:
            public = [r for r in seen[pkg] if r["op"] != "_wire"]
            assert public == 2 * [
                {"op": "version", "x": 0.1 + 0.2},
                {"op": "lookup", "x": [1, 2.5], "_trace": "e" * 16},
                {"op": "_private"}]
        assert_same(seen["port"], seen["reference"])
    finally:
        for srv in servers.values():
            srv.shutdown()


# ------------------------------------------- a traced remote-worker job

def _traced_job(pkg, tmp_path):
    """One sim hyperband job on a worker served in this process, under a
    distributed trace with a collector: the driver bus's records."""
    ev, fw, sinks = PKG[pkg][0], PKG[pkg][1], PKG[pkg][2]
    mod = PKG[pkg][4]
    svc = mod.TrialWorkerService()
    svc.bus = ev.EventBus()
    server = mod.serve_worker(svc, port=0, background=True)
    addr = f"tcp://127.0.0.1:{server.server_address[1]}"
    bus = ev.EventBus()
    path = str(tmp_path / f"{pkg}.jsonl")
    sinks.attach_trace(bus, path)
    collector = fw.start_collector(bus)
    if pkg == "port":
        ex = WorkerPoolExecutor([RemoteWorker(addr)])
        exp = Experiment(_job())
    else:
        ex = JWorkerPoolExecutor([JRemoteWorker(addr)])
        exp = JExperiment(_jjob())
    ex.attach_bus(bus)
    tid = ex.enable_trace(collector=collector.address)
    ex._trace_collector = collector
    try:
        res = (exp.with_tuner("v1").with_backend("sim")
               .with_scheduler("hyperband").run(executor=ex))
        assert svc.bus.forward_sink.flush(timeout=5.0)
    finally:
        ex.close()
        server.shutdown()
        svc.close()
    return addr, tid, res, PKG[pkg][2].read_trace(path)


def _shape(records, addr):
    out = []
    for r in records:
        key = [r["kind"], r.get("trial_id"), r.get("epoch"),
               r.get("op"), r.get("reason")]
        key += [r.get("worker") == addr, r.get("proc") == addr]
        out.append(tuple(key))
    return sorted(out, key=repr)


def test_traced_remote_job_gives_the_references_stream(tmp_path):
    """The same traced sim job in each package: every (trial, epoch) is
    reported once, by the worker, and the two streams hold the same
    records bar times, ports and trace ids. Both packages analyze the
    port's trace into the same report."""
    addr, tid, res, ours = _traced_job("port", tmp_path)
    jaddr, _, jres, theirs = _traced_job("reference", tmp_path)
    epochs = [r for r in ours if r["kind"] == "epoch_completed"]
    keys = [(r["trial_id"], r["epoch"]) for r in epochs]
    assert epochs and len(keys) == len(set(keys))
    assert all(r["proc"] == addr for r in epochs)
    assert {r["trace"] for r in ours} == {tid}
    assert {r["trial_id"] for r in ours if r["kind"] == "trial_started"} \
        == {r["trial_id"] for r in ours if r["kind"] == "trial_dispatched"}
    assert _shape(ours, addr) == _shape(theirs, jaddr)
    assert res.best_score == jres.best_score
    report = ttrace.analyze_trace(ours)
    assert_same(report, jtrace.analyze_trace(ours))
    assert report["n_orphans"] == 0 and report["forward_dropped"] == 0
    assert report["n_segments"] == len(
        [r for r in ours if r["kind"] == "trial_dispatched"])


# ------------------------------------------- the self-healing obs client

def test_obs_client_waits_out_a_slow_endpoint_and_bounds_a_dead_one():
    port = _free_port()
    client = ObsClient(f"tcp://127.0.0.1:{port}", connect_retries=40,
                       retry_backoff_s=0.05)
    out = {}

    def scrape():
        try:
            out["text"] = client.metrics()
        except Exception as e:                      # noqa: BLE001
            out["err"] = e

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    time.sleep(0.4)
    server = serve_obs(tevents.EventBus(), port=port, background=True)
    try:
        t.join(timeout=10.0)
        assert "repro_events_total 0" in out.get("text", ""), out
    finally:
        client.close()
        server.shutdown()
    dead = ObsClient(f"tcp://127.0.0.1:{_free_port()}", connect_retries=1,
                     retry_backoff_s=0.01)
    with pytest.raises(ObsUnreachable, match="unreachable"):
        dead.metrics()
    dead.close()


# --------------------------------------- acceptance: distributed end-to-end

@pytest.mark.slow
def test_distributed_run_under_trace_yields_one_merged_timeline(tmp_path):
    """A ``python -m repro_torch.worker`` process and a TCP store, driven
    through ``--workers --trace``, leave ONE merged trace: every trial's
    span joins the worker's start and epochs to the driver's dispatch and
    completion, no orphans, store RPCs traced."""
    from repro_torch.launch.sysargs import executor_from_args

    trace_path = str(tmp_path / "run_trace.jsonl")
    store_svc = tservice.GroundTruthService()
    store_svc.bus = tevents.EventBus()
    store_srv = tservice.serve(store_svc, port=0, background=True)
    s_host, s_port = store_srv.server_address[:2]
    proc, _, worker_proc = spawn(["repro_torch.worker", "--port", "0"],
                                 "trial worker on")
    try:
        args = argparse.Namespace(
            executor="serial", parallelism=1, cluster_nodes=4,
            straggler_prob=0.0, backends=None, shard_capacity=1,
            workers=worker_proc, coordinator=None, trace=trace_path,
            wire="auto")
        ex = executor_from_args(args)
        res = (Experiment(_job(epochs=6))
               .with_tuner("pipetune", max_probes=4).with_backend("sim")
               .with_groundtruth(tservice.StoreClient(
                   tservice.SocketTransport(s_host, s_port)))
               .with_scheduler("random", n_trials=4).run(executor=ex))
        assert res.best_hparams
        time.sleep(0.5)
        ex.close()
    finally:
        stop(proc)
        store_srv.shutdown()
        store_svc.close()

    records = ttrace.load_events([trace_path])
    report = ttrace.analyze_trace(records)
    assert len(report["trace_ids"]) == 1, report["trace_ids"]
    assert "driver" in report["procs"] and worker_proc in report["procs"]
    assert any(p.startswith("store@") for p in report["procs"])
    assert report["n_orphans"] == 0 and report["n_trials"] >= 4
    for tid, segs in report["trials"].items():
        for seg in segs:
            assert not seg["orphan"] and seg["completed_ts"] is not None
        assert any(s["started_ts"] is not None for s in segs), tid
    epochs = [r for r in records if r.get("kind") == "epoch_completed"]
    keys = [(r["trial_id"], r["epoch"]) for r in epochs]
    assert epochs and len(keys) == len(set(keys))
    assert all(r.get("proc") == worker_proc for r in epochs)
    assert any(str(r.get("peer", "")).startswith("store@")
               for r in records if r.get("kind") == "rpc_completed")
    assert report["breakdown"]["wall_s"] > 0
    assert report["workers"] and report["workers"][0]["util"] <= 1.0
    assert_same(report, jtrace.analyze_trace(records))
