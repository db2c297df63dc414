"""The port's elastic pool (``repro_torch.service.coordinator``, the
``WorkerPool`` hooks of ``repro_torch.core.worker``) and sharded executor
(``repro_torch.service.sharded``) against the reference's.

- The coordinator's register, heartbeat, expire and leave give the
  reference's replies under one injected clock; the announcer registers
  and leaves (with a port and with a reference coordinator); its events
  reach the bus.
- The pool's hooks: roster sync while workers are busy, a lost worker
  retired with its trials re-placed, the bounded wait for a join.
- Subprocesses (``python -m repro_torch.coordinator`` and
  ``repro_torch.worker --announce``): a worker joining mid-run receives
  trials; a worker killed (SIGKILL) mid-job is retired and its trials
  finish on the other; both runs give the serial records.
- ``ShardedTrialExecutor`` equals the reference's in the cases of
  tests/test_service.py: tagged engine dispatch, one shard equal to serial,
  registry names, shards kept across rungs, one store shared by shards.
"""
import argparse
import os
import signal
import threading
import time

import pytest

import repro.api as japi
import repro.cluster.engine as jengine
import repro.cluster.sim as jsim
import repro.core.groundtruth as jgt
import repro.core.job as jjob
import repro.service as jservice
import repro_torch.api as tapi
import repro_torch.cluster.engine as tengine
import repro_torch.cluster.sim as tsim
import repro_torch.core.groundtruth as tgt
import repro_torch.core.job as tjob
import repro_torch.core.worker as tworker
import repro_torch.service as tservice
from repro_torch.core.pipetune import TuneV1
from repro_torch.obs.events import EventBus
from torch_service_util import addr_of, spawn, stop

PKGS = {"reference": (japi, jengine, jsim, jgt, jjob, jservice),
        "port": (tapi, tengine, tsim, tgt, tjob, tservice)}


def _job(pkg="port", epochs=9):
    job = PKGS[pkg][4]
    return job.HPTJob(workload="lenet-mnist", space=job.SearchSpace([
        job.Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        job.Param("learning_rate", "log", 0.001, 0.1)]), max_epochs=epochs)


def _records(res):
    return {t: ([e.accuracy for e in r.epochs], [e.loss for e in r.epochs],
                r.sys_history, r.gt_hit, r.probe_epochs)
            for t, r in sorted(res.records.items())}


# ------------------------------------------------------------ coordinator

def _roster_story(pkg):
    clock = [0.0]
    svc = PKGS[pkg][5].CoordinatorService(ttl_s=10.0, clock=lambda: clock[0])
    seen = []

    def call(op, **kw):
        seen.append(svc.handle({"op": op, **kw}))
        return seen[-1]
    a = call("register", address="tcp://10.0.0.1:7078")["worker_id"]
    b = call("register", address="tcp://10.0.0.2:7078", speed_factor=2.0,
             capacity=2)["worker_id"]
    call("roster")
    clock[0] = 8.0
    call("heartbeat", worker_id=b)
    clock[0] = 12.0
    call("roster")                      # a went silent past the ttl
    call("heartbeat", worker_id=a)      # rejected: a re-registers
    call("register", address="tcp://10.0.0.1:7078")
    call("register", address="tcp://10.0.0.1:7078")     # no ghost
    call("version")
    call("leave", worker_id=b)
    call("roster")
    call("register", address="http://x")
    call("nope")
    return seen


def test_coordinator_replies_equal_the_reference_under_one_clock():
    ours, theirs = _roster_story("port"), _roster_story("reference")
    assert ours == theirs
    assert [w["address"] for w in ours[-3]["workers"]] == \
        ["tcp://10.0.0.1:7078"]
    assert not ours[5]["ok"] and "re-register" in ours[5]["error"]
    assert [r["ok"] for r in ours[-2:]] == [False, False]


def test_coordinator_events_reach_the_bus():
    clock = [0.0]
    svc = tservice.CoordinatorService(ttl_s=5.0, clock=lambda: clock[0])
    svc.bus = EventBus()
    kinds = []
    svc.bus.add_sink(lambda rec: kinds.append((rec["kind"],
                                               rec.get("reason"))))
    wid = svc.handle({"op": "register", "address": "tcp://h:1"})["worker_id"]
    svc.handle({"op": "register", "address": "tcp://h:2"})
    clock[0] = 6.0
    svc.handle({"op": "roster"})
    assert kinds == [("worker_joined", None), ("worker_joined", None),
                     ("heartbeat_missed", None), ("worker_retired",
                                                  "heartbeat"),
                     ("heartbeat_missed", None), ("worker_retired",
                                                  "heartbeat")]
    assert not svc.handle({"op": "heartbeat", "worker_id": wid})["ok"]
    resp = svc.handle({"op": "obs_trace", "trace": "t", "proc": "c"})
    assert resp["ok"] and resp["trace"] == "t"
    assert (svc.bus.trace_id, svc.bus.proc) == ("t", "c")
    svc.handle({"op": "register", "address": "tcp://h:3"})
    assert kinds[-1] == ("worker_joined", None)
    assert svc.bus.events()[-1]["trace"] == "t"


@pytest.mark.parametrize("coord_pkg", ["port", "reference"])
def test_announcer_registers_and_leaves(coord_pkg):
    mod = PKGS[coord_pkg][5]
    server = mod.serve_coordinator(mod.CoordinatorService(ttl_s=5.0),
                                   port=0, background=True)
    try:
        coord = "tcp://127.0.0.1:%d" % server.server_address[1]
        ann = tservice.WorkerAnnouncer(coord, "tcp://127.0.0.1:9999",
                                       speed_factor=1.5)
        ann.start()
        client = tservice.CoordinatorClient(coord)
        roster = client.roster()
        assert [(w["address"], w["speed_factor"]) for w in roster] == \
            [("tcp://127.0.0.1:9999", 1.5)]
        ann.stop()
        assert client.roster() == []
        client.close()
    finally:
        server.shutdown()


# ------------------------------------------------------------- pool hooks

class _Scripted(tworker.Worker):
    """Completes a trial at a blocking poll; fails each with `fail_with`
    when set; never completes when `hung`."""

    def __init__(self, name, fail_with=None, hung=False):
        super().__init__()
        self.name, self.fail_with, self.hung = name, fail_with, hung
        self.submitted, self._pending = [], []

    def capabilities(self):
        return tworker.WorkerCapabilities(kind="scripted")

    @property
    def outstanding(self):
        return len(self._pending)

    def submit(self, trial, epochs=None):
        self.submitted.append(trial.trial_id)
        self._pending.append(trial)

    def poll(self, timeout=0.0):
        if not self._pending or self.hung:
            return []
        if self.fail_with is not None:
            return [tworker.TrialCompletion(self._pending.pop(0).trial_id,
                                            float("nan"),
                                            error=self.fail_with)]
        if timeout <= 0:
            return []
        return [tworker.TrialCompletion(self._pending.pop(0).trial_id, 1.0)]


class _P:
    def __init__(self, tid, epochs=1):
        self.trial_id, self.clone_from = tid, None
        self.hparams, self.epochs = {}, epochs


def test_maintenance_retires_a_hung_worker_while_the_pool_waits():
    hung, healthy = _Scripted("hung", hung=True), _Scripted("healthy")
    pool = tworker.WorkerPool([hung, healthy], sticky=True)
    runner = TuneV1(tsim.SimBackend())
    pool.bind(runner, "lenet-mnist")
    pool._bindings["a"] = hung
    calls = []

    def evict():
        calls.append(1)
        if len(calls) > 1 and hung in pool.workers:
            pool.remove_worker(hung)
    pool.maintenance = evict
    out = pool.run_wave(runner, "lenet-mnist", [_P("a")])
    assert [(p.trial_id, s) for p, s in out] == [("a", 1.0)]
    assert pool.workers == [healthy] and len(calls) > 1


def test_a_lost_worker_is_retired_and_its_trials_re_placed():
    lost = RuntimeError("boom")
    lost.worker_lost = True
    dying, healthy = _Scripted("dying", fail_with=lost), _Scripted("ok")
    pool = tworker.WorkerPool([dying, healthy], sticky=True)
    pool.retire_on_error = True
    runner = TuneV1(tsim.SimBackend())
    out = pool.run_wave(runner, "lenet-mnist", [_P(f"t{i}") for i in
                                                range(4)])
    assert [p.trial_id for p, _ in out] == ["t0", "t1", "t2", "t3"]
    assert pool.workers == [healthy]
    assert sorted(healthy.submitted) == ["t0", "t1", "t2", "t3"]
    strict = tworker.WorkerPool([_Scripted("d2", fail_with=lost)])
    with pytest.raises(RuntimeError, match="boom"):
        strict.run_wave(runner, "lenet-mnist", [_P("x")])


def test_an_empty_elastic_pool_waits_a_bounded_time_for_a_join():
    pool = tworker.WorkerPool([], sticky=True, allow_empty=True,
                              join_timeout_s=0.3)
    runner = TuneV1(tsim.SimBackend())
    joiner = _Scripted("late")
    ticks = []

    def roster():
        ticks.append(1)
        if len(ticks) == 3:
            pool.add_worker(joiner)
    pool.maintenance = roster
    out = pool.run_wave(runner, "lenet-mnist", [_P("a"), _P("b")])
    assert [p.trial_id for p, _ in out] == ["a", "b"]
    assert joiner.submitted == ["a", "b"]
    never = tworker.WorkerPool([], allow_empty=True, join_timeout_s=0.2)
    never.maintenance = lambda: None
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no worker joined the pool"):
        never.run_wave(runner, "lenet-mnist", [_P("x")])
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(ValueError, match="at least one worker"):
        tworker.WorkerPool([])


def test_sysargs_coordinator_flag_and_the_runner_spec():
    from repro_torch.launch.sysargs import (add_executor_args,
                                            executor_from_args)

    def parse(argv):
        return add_executor_args(argparse.ArgumentParser()).parse_args(argv)
    with pytest.raises(ValueError, match="--coordinator.*cluster"):
        executor_from_args(parse(["--coordinator", "tcp://h:1",
                                  "--executor", "cluster"]))
    with pytest.raises(ValueError, match="--executor workers needs"):
        executor_from_args(parse(["--executor", "workers"]))
    with pytest.raises(ValueError, match="--backends .*conflicts"):
        executor_from_args(parse(["--backends", "sim"]))
    server = tservice.serve_coordinator(tservice.CoordinatorService(),
                                        port=0, background=True)
    try:
        coord = "tcp://127.0.0.1:%d" % server.server_address[1]
        ex = executor_from_args(parse(["--coordinator", coord, "--workers",
                                       "sim", "--wire", "json"]))
        assert isinstance(ex, tapi.ElasticWorkerPoolExecutor)
        assert [type(w) for w in ex.workers] == [tworker.InprocWorker]
        assert ex._worker_kw["wire"] == "json"
        with pytest.raises(ValueError, match="runner_spec"):
            ex.configure_runner_spec(None)
        ex.close()
        explicit = tapi.ElasticWorkerPoolExecutor(coord, runner_spec={})
        explicit.configure_runner_spec(None)
        assert explicit._runner_spec == {}
        explicit.close()
    finally:
        server.shutdown()


# ---------------------------------------------------- subprocesses, elastic

class _Gated:
    """A scheduler whose wave `after` + 1 waits for the test's gate."""

    def __init__(self, inner, after=1):
        self.inner, self.gate, self.after = inner, threading.Event(), after
        self.held = threading.Event()       # set when a wave waits
        self.waves = 0

    def suggest(self):
        wave = self.inner.suggest()
        if wave:
            if self.waves == self.after:
                self.held.set()
                assert self.gate.wait(timeout=60.0), "gate timed out"
            self.waves += 1
        return wave

    def report(self, trial_id, score):
        self.inner.report(trial_id, score)

    def best(self):
        return self.inner.best()

    @property
    def done(self):
        return self.inner.done


@pytest.fixture
def coordinator():
    procs = []
    proc, _, addr = spawn(["repro_torch.coordinator", "--port", "0",
                           "--ttl", "10"], "coordinator on")
    procs.append(proc)

    def worker():
        p, _, _ = spawn(["repro_torch.worker", "--port", "0", "--announce",
                         addr], "announced to")
        procs.append(p)
        with open(p.log) as f:
            return p, addr_of(f.readline())
    yield addr, worker
    stop(*procs)


def _elastic_run(coord, sched=None):
    ex = tapi.make_executor("workers", coordinator=coord)
    holder = {}
    exp = (tapi.Experiment(_job()).with_tuner("v1").with_backend("sim")
           .with_scheduler(sched if sched is not None else "hyperband"))

    def run():
        holder["res"] = exp.run(executor=ex)
    t = threading.Thread(target=run, daemon=True)
    return ex, holder, t


def test_a_worker_joining_mid_run_receives_trials(coordinator):
    coord, worker = coordinator
    worker()
    sched = _Gated(tapi.make_scheduler("hyperband", _job()))
    ex, holder, t = _elastic_run(coord, sched)
    try:
        t.start()
        worker()                                # joins before wave 2
        client = tservice.CoordinatorClient(coord)
        deadline = time.monotonic() + 30.0
        while len(client.roster()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        client.close()
        sched.gate.set()
        t.join(timeout=120.0)
        assert not t.is_alive(), "the experiment hung"
        assert len(ex.workers) == 2
        assert all(n > 0 for n in ex.pool.dispatched.values())
    finally:
        ex.close()
    serial = (tapi.Experiment(_job()).with_tuner("v1").with_backend("sim")
              .with_scheduler("hyperband").run())
    assert _records(holder["res"]) == _records(serial)


def test_a_killed_worker_is_retired_and_its_trials_finish_elsewhere(
        coordinator):
    """SIGKILL one of two workers between waves: the rung resumes bound to
    it fail on its dead connection, the pool retires it and re-places
    them on the survivor, which re-runs them from their start; every
    proposal completes once and the records are the serial run's."""
    coord, worker = coordinator
    (victim, vaddr), (_, saddr) = worker(), worker()
    sched = _Gated(tapi.make_scheduler("hyperband", _job()))
    ex, holder, t = _elastic_run(coord, sched)
    bus = EventBus()
    events = []
    bus.add_sink(events.append)
    ex.attach_bus(bus)
    try:
        t.start()
        assert sched.held.wait(timeout=60.0)    # wave 1 done, 2 held
        assert len(ex.workers) == 2
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=10)
        sched.gate.set()
        t.join(timeout=120.0)
        assert not t.is_alive(), "the experiment hung"
        assert [w.address for w in ex.workers] == \
            [tservice.dispatch.parse_tcp_address(saddr)]
    finally:
        ex.close()
    retired = [e for e in events if e["kind"] == "worker_retired"]
    assert [(e["worker"], e["reason"]) for e in retired] == \
        [(vaddr, "worker_lost")]
    moved = {e["trial_id"] for e in events if e["kind"] == "resharded"}
    assert moved and all(e["dst"] == saddr for e in events
                         if e["kind"] == "resharded")
    done = [e for e in events if e["kind"] == "trial_completed"]
    assert all(e["error"] is None for e in done)
    assert {e["worker"] for e in done if e["trial_id"] in moved
            and e["seq"] > retired[0]["seq"]} == {saddr}
    dispatched = [e for e in events if e["kind"] == "trial_dispatched"]
    assert len(done) == len(dispatched) - len(
        [e for e in events if e["kind"] == "resharded"])
    serial = (tapi.Experiment(_job()).with_tuner("v1").with_backend("sim")
              .with_scheduler("hyperband").run())
    assert _records(holder["res"]) == _records(serial)


# ----------------------------------------------------------------- sharded

def test_tagged_engine_dispatch_matches_the_reference():
    def story(pkg):
        eng_mod = PKGS[pkg][1]
        eng = eng_mod.EventEngine(eng_mod.ClusterConfig(
            n_nodes=3, node_tags=("a", "a", "b"), seed=0))
        stats = [eng.submit(f"b{i}", iter([5.0]), tag="b") for i in range(3)]
        free = eng.submit("free", iter([5.0]))
        eng.run()
        with pytest.raises(ValueError):
            eng.submit("x", iter([1.0]), tag="missing")
        with pytest.raises(ValueError):
            eng_mod.ClusterConfig(n_nodes=2, node_tags=("a",))
        return [(s.node, s.start_s, s.finish_s) for s in stats + [free]]
    ours = story("port")
    assert ours == story("reference")
    assert all(node == 2 for node, _, _ in ours[:3])


def _sharded(pkg, tuner, backends, scheduler="hyperband", store=None,
             epochs=9, **sched_kw):
    api, _, sim, gt, _, service = PKGS[pkg]
    shards = [(tag, sim.SimBackend()) for tag in backends]
    ex = service.ShardedTrialExecutor(backends=shards, capacity=1)
    exp = (api.Experiment(_job(pkg, epochs))
           .with_tuner(tuner, **({"max_probes": 4} if tuner == "pipetune"
                                 else {}))
           .with_backend("sim")
           .with_groundtruth(store if store is not None else gt.GroundTruth())
           .with_scheduler(scheduler, **sched_kw))
    res = exp.run(executor=ex)
    history = [(d.trial_id, d.backend, d.node) for d in ex.history]
    return res, history, ex


@pytest.mark.parametrize("tuner", ["v1", "pipetune"])
def test_one_shard_equals_serial_and_the_reference(tuner):
    ours, hist, _ = _sharded("port", tuner, ["sim"])
    theirs, ref_hist, _ = _sharded("reference", tuner, ["sim"])
    serial = (tapi.Experiment(_job()).with_tuner(
        tuner, **({"max_probes": 4} if tuner == "pipetune" else {}))
        .with_backend("sim").with_groundtruth(tgt.GroundTruth())
        .with_scheduler("hyperband").run())
    assert _records(ours) == _records(serial) == _records(theirs)
    assert (ours.gt_hits, ours.gt_misses) == (theirs.gt_hits,
                                              theirs.gt_misses)
    assert hist == ref_hist and ours.sim_time_s == theirs.sim_time_s > 0


def test_shards_keep_their_trials_across_rungs_as_the_reference():
    ours, hist, ex = _sharded("port", "v1", ["s0", "s1"])
    theirs, ref_hist, _ = _sharded("reference", "v1", ["s0", "s1"])
    assert hist == ref_hist and _records(ours) == _records(theirs)
    assert {b for _, b, _ in hist} == {"s0", "s1"}
    by_trial = {}
    for tid, shard, node in hist:
        by_trial.setdefault(tid, set()).add(shard)
        assert ex.engine._tags[node] == shard
    assert all(len(s) == 1 for s in by_trial.values())
    assert any(sum(t == tid for t, _, _ in hist) > 1 for tid in by_trial)


def test_sharded_registry_name_resolves_backends():
    def run(api):
        return (api.Experiment(_job("port" if api is tapi else "reference",
                                    6))
                .with_tuner("v1").with_backend("sim")
                .with_scheduler("random", n_trials=4)
                .with_executor("sharded", backends=["sim", "sim"],
                               capacity=1).run())
    ours, theirs = run(tapi), run(japi)
    assert len(ours.records) == 4 and ours.sim_time_s > 0
    assert _records(ours) == _records(theirs)
    assert ours.sim_time_s == theirs.sim_time_s


def test_shards_share_one_groundtruth_service(tmp_path):
    svc = tservice.GroundTruthService(path=str(tmp_path / "gt.jsonl"))
    client = tservice.StoreClient(tservice.InprocTransport(svc))
    ours, _, _ = _sharded("port", "pipetune", ["s0", "s1"], "random",
                          store=client, epochs=6, n_trials=6)
    jsvc = jservice.GroundTruthService(path=str(tmp_path / "ref.jsonl"))
    theirs, _, _ = _sharded("reference", "pipetune", ["s0", "s1"], "random",
                            store=jservice.StoreClient(
                                jservice.InprocTransport(jsvc)),
                            epochs=6, n_trials=6)
    assert ours.gt_hits + ours.gt_misses == len(ours.records)
    assert len(svc.store.entries) >= 1 and ours.gt_hits >= 1
    assert _records(ours) == _records(theirs)
    svc.close()
    jsvc.close()
    assert (tmp_path / "gt.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
