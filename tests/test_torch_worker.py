"""The port's worker pool and executors (``repro_torch.core.worker``,
``core.executor``) against the reference's, and concurrent trials of
``TorchRealBackend`` on the CPU.

- The pool's placement, membership changes and loss handling make the same
  choices as the reference's on the same scripted workers, and its event
  stream on the simulated cluster is the reference's record for record.
- ``ParallelTrialExecutor(2)`` on the CPU ``TorchRealBackend`` gives the
  serial run's TuneV1 and PBT records: hparams and sys histories equal,
  losses and accuracies within 1e-6 * (1 + |x|).
- Concurrent ``get_step`` calls build each step once.
- A sticky ``WorkerPoolExecutor`` over ``InprocWorker(backend=...)`` shards
  keeps each trial, its rung resumes and its clones on one shard.
- The executors and launcher flags of the tuning service (ROADMAP item
  12) build and run, and so do those of tracing (item 13): an executor's
  ``enable_trace`` and the launcher's ``--trace``. A name the port leaves
  to a later item raises naming it (``registry._LATER``, none today).
"""
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.cluster.sim as jsim
import repro.core.job as jjob
import repro.core.worker as jworker
import repro.obs.events as jevents
import repro_torch.api as tapi
import repro_torch.cluster.sim as tsim
import repro_torch.core.job as tjob
import repro_torch.core.worker as tworker
import repro_torch.obs.events as tevents
from repro_torch.api import registry
from repro_torch.core.backends import TorchRealBackend
from repro_torch.core.executor import (ParallelTrialExecutor,
                                       SerialTrialExecutor)
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.core.pipetune import TuneV1
from repro_torch.launch import tune as tune_launch

PKGS = {"reference": (japi, jworker, jevents, jsim),
        "port": (tapi, tworker, tevents, tsim)}
JOBS = {"reference": jjob, "port": tjob}
ROADMAP = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
TOL = 1e-6


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


# ------------------------------------------------------- the pool, scripted

class _P:
    def __init__(self, tid, clone_from=None, epochs=1):
        self.trial_id, self.clone_from = tid, clone_from
        self.hparams, self.epochs = {}, epochs


def _scripted(mod):
    class Scripted(mod.Worker):
        """Completes every submitted trial at its next poll with score 1."""

        def __init__(self, name, speed=1.0, capacity=1, fail_with=None):
            super().__init__()
            self.name, self.speed, self.cap = name, speed, capacity
            self.fail_with = fail_with
            self.submitted, self._pending = [], []

        def capabilities(self):
            return mod.WorkerCapabilities(kind="scripted",
                                          capacity=self.cap,
                                          speed_factor=self.speed)

        @property
        def outstanding(self):
            return len(self._pending)

        def submit(self, trial, epochs=None):
            self.submitted.append(trial.trial_id)
            self._pending.append(trial.trial_id)

        def poll(self, timeout=0.0):
            out, self._pending = self._pending, []
            if self.fail_with is not None and out:
                return [mod.TrialCompletion(t, float("nan"),
                                            error=self.fail_with)
                        for t in out]
            return [mod.TrialCompletion(t, 1.0) for t in out]
    return Scripted


def _pool_story(pkg):
    """Weighted sticky placement, joins and leaves mid-run (a leaver's
    trials re-placed), a worker's error raised: what each worker was
    handed, in order."""
    api, mod, _, sim = PKGS[pkg]
    W = _scripted(mod)
    slow, fast = W("slow"), W("fast", speed=3.0)
    pool = mod.WorkerPool([slow, fast], sticky=True)
    runner = api.make_tuner("v1", sim.SimBackend())
    pool.bind(runner, "lenet-mnist")
    for i in range(4):
        pool._dispatch(_P(f"t{i}"), 1)
    joined = W("joined", capacity=2)
    pool.add_worker(joined)
    for i in range(4, 8):
        pool._dispatch(_P(f"t{i}"), 1)
    pool.remove_worker(fast)
    wave = pool.run_wave(runner, "lenet-mnist",
                         [_P("t1"), _P("c", clone_from="t8"), _P("t9")])
    dying = W("dying", fail_with=RuntimeError("boom"))
    pool.add_worker(dying)
    pool._bindings.clear()
    try:
        pool.run_wave(runner, "lenet-mnist", [_P(f"u{i}") for i in range(5)])
        out = "no error"
    except RuntimeError as e:
        out = str(e)
    wide, narrow = W("wide", capacity=4), W("narrow")
    free = mod.WorkerPool([narrow, wide], sticky=False)
    wide._pending, narrow._pending = [1, 2], [1]
    return ([(w.name, w.submitted) for w in (slow, fast, joined, dying)],
            [w.name for w in pool.workers],
            [(p.trial_id, s) for p, s in wave],
            out, free.place(_P("x")).name)


def test_pool_placement_and_membership_are_the_reference():
    ours, theirs = _pool_story("port"), _pool_story("reference")
    assert ours == theirs
    handed = dict(ours[0])
    assert handed["fast"][:3] == ["t1", "t2", "t3"]     # 3x speed, 3x trials
    assert ours[3] == "boom" and ours[4] == "wide"


def test_pool_stall_and_unbound_errors():
    only = tworker.InprocWorker()
    pool = tworker.WorkerPool([only], sticky=True)
    pool.remove_worker(only)
    with pytest.raises(RuntimeError, match="no workers"):
        pool.place(_P("a"))
    with pytest.raises(ValueError, match="at least one worker"):
        tworker.WorkerPool([])
    with pytest.raises(ValueError, match="capacity"):
        tworker.ThreadWorker(capacity=0)
    caps = tworker.ThreadWorker(capacity=3)
    assert (caps.capabilities().kind, caps.capabilities().capacity) == \
        ("thread", 3)
    caps.close()


def _events(pkg, executor):
    """The event stream of a PipeTune sim job (kinds and fields, without
    the bus's clocks and sequence numbers)."""
    api, _, ev, sim = PKGS[pkg]
    jmod = JOBS[pkg]
    hpt = jmod.HPTJob(workload="lenet-mnist", space=jmod.SearchSpace([
        jmod.Param("batch_size", "choice", choices=(32, 256)),
        jmod.Param("learning_rate", "log", 0.001, 0.1)]), max_epochs=9)
    ex = {"cluster": lambda: api.make_executor("cluster", n_nodes=2,
                                               straggler_prob=0.3, seed=2),
          "workers": lambda: api.make_executor("workers",
                                               workers=["sim", "sim"])}[
        executor]()
    bus = ev.EventBus()
    seen = []
    bus.add_sink(seen.append)
    ex.attach_bus(bus)
    try:
        res = (api.Experiment(hpt).with_tuner("v1").with_backend("sim")
               .with_scheduler("hyperband").run(executor=ex))
    finally:
        ex.close()
    drop = {"ts", "mono", "seq"}

    def label(v):       # an untagged worker's label carries its id()
        return re.sub(r"^(sim|inproc|thread):[0-9a-f]{4}$", r"\1", v) \
            if isinstance(v, str) else v
    return [{k: label(v) for k, v in r.items() if k not in drop}
            for r in seen], res.best_score, dict(bus.counters)


@pytest.mark.parametrize("executor", ["cluster", "workers"])
def test_event_stream_is_the_reference(executor):
    ours, theirs = _events("port", executor), _events("reference", executor)
    assert ours == theirs
    assert tevents.EVENT_TYPES.keys() == jevents.EVENT_TYPES.keys()
    kinds = set(ours[2])
    assert {"trial_dispatched", "trial_completed"} <= kinds
    if executor == "cluster":
        assert "epoch_completed" in kinds


# ----------------------------------------------- concurrent trials, on CPU

SMALL = dict(n_train=64, n_eval=32, steps_per_epoch=3, device="cpu")


@pytest.fixture
def one_thread_per_op():
    """One intra-op thread while two lanes train at once: the lanes'
    thread teams would otherwise oversubscribe the cores of a machine that
    runs other test processes too. Serial and parallel runs of a test both
    run under it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _real_job(workload, epochs=2):
    space = SearchSpace([Param("batch_size", "choice", choices=(8, 16)),
                         Param("learning_rate", "log", 0.01, 0.1),
                         Param("dropout", "float", 0.0, 0.5)])
    return HPTJob(workload=workload, space=space, max_epochs=epochs, seed=1)


def _real_run(workload, executor, scheduler="random", **sched_kw):
    return (tapi.Experiment(_real_job(workload, sched_kw.pop("epochs", 2)))
            .with_tuner("v1").with_backend("real", **SMALL)
            .with_scheduler(scheduler, **sched_kw).run(executor=executor))


def _assert_same_records(par, ser):
    assert par.records.keys() == ser.records.keys()
    for tid, rec in ser.records.items():
        got = par.records[tid]
        assert got.hparams == rec.hparams and \
            got.sys_history == rec.sys_history, tid
        assert len(got.epochs) == len(rec.epochs), tid
        for a, b in zip(got.epochs, rec.epochs):
            assert _rel(a.loss, b.loss) <= TOL, (tid, a.loss, b.loss)
            assert _rel(a.accuracy, b.accuracy) <= TOL, tid
            assert a.sys_config == b.sys_config
    assert par.best_hparams == ser.best_hparams


@pytest.mark.parametrize("workload", ["lenet-mnist", "cnn-news20"])
def test_parallel_lanes_give_the_serial_records(workload, one_thread_per_op):
    ser = _real_run(workload, SerialTrialExecutor(), n_trials=4)
    ex = ParallelTrialExecutor(2)
    try:
        par = _real_run(workload, ex, n_trials=4)
    finally:
        ex.close()
    _assert_same_records(par, ser)
    assert all(np.isfinite(e.loss) for r in par.records.values()
               for e in r.epochs)


def test_pbt_clones_under_the_parallel_executor(one_thread_per_op):
    kw = dict(population=4, interval=1, epochs=3)
    ser = _real_run("lenet-mnist", SerialTrialExecutor(), "pbt", **kw)
    ex = ParallelTrialExecutor(2)
    try:
        par = _real_run("lenet-mnist", ex, "pbt", **kw)
    finally:
        ex.close()
    _assert_same_records(par, ser)
    assert all(len(r.epochs) == 3 for r in par.records.values())


def test_concurrent_get_step_builds_each_key_once(monkeypatch):
    be = TorchRealBackend(**SMALL)
    built = []
    real_build = be._build_step

    def slow_build(*args):
        built.append(args[2]["microbatches"])
        time.sleep(0.05)                    # widen the race window
        return real_build(*args)
    monkeypatch.setattr(be, "_build_step", slow_build)
    ts = be.init_trial("lenet-mnist", {"batch_size": 8,
                                       "learning_rate": 0.05}, seed=0)
    cfgs = [{"remat": "none", "microbatches": m, "precision": "fp32"}
            for m in (1, 2)]
    got = [None] * 8
    start = threading.Barrier(8)

    def ask(i):
        start.wait()
        got[i] = be.get_step(ts, cfgs[i % 2])[0]
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(built) == [1, 2]
    assert all(got[i] is got[i % 2] for i in range(8))
    assert be.lane_stream() is None         # no stream on the CPU


class _RacyStore:
    """A ground-truth store client that is not thread-safe itself: each
    counter update is a read, a yield and a write. The runner's hook lock
    is what keeps concurrent trials from losing updates."""

    def __init__(self):
        self.hits = self.misses = self.added = 0

    def lookup(self, profile):
        n = self.misses
        time.sleep(0)
        self.misses = n + 1
        return 0.0, None

    def add(self, profile, workload, config, objective=None):
        n = self.added
        time.sleep(0)
        self.added = n + 1


def test_lanes_lose_no_runner_update_under_stress():
    """More lanes than cores and a short switch interval over PipeTune's
    shared store client and the runner's dicts: every trial has its record
    and epochs, and every store call is counted."""
    import os
    import sys
    lanes = 2 * (os.cpu_count() or 8)
    store = _RacyStore()
    space = SearchSpace([Param("batch_size", "choice", choices=(32, 256)),
                         Param("learning_rate", "log", 0.001, 0.1)])
    job = HPTJob(workload="lenet-mnist", space=space, max_epochs=3, seed=4)
    out = {}

    def run():
        ex = ParallelTrialExecutor(lanes)
        try:
            out["res"] = (tapi.Experiment(job).with_tuner("pipetune")
                          .with_backend("sim").with_groundtruth(store)
                          .with_scheduler("random", n_trials=3 * lanes)
                          .run(executor=ex))
        finally:
            ex.close()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    res = out["res"]
    assert len(res.records) == 3 * lanes
    assert all(len(r.epochs) == 3 == len(r.sys_history)
               for r in res.records.values())
    assert store.misses == res.gt_misses == len(res.records)
    assert store.added == sum(r.probe_epochs >= 1
                              for r in res.records.values()) > 0


def test_sticky_shards_keep_trials_on_their_backend(one_thread_per_op):
    shards = [TorchRealBackend(**SMALL), TorchRealBackend(**SMALL)]
    workers = [tworker.InprocWorker(backend=b, tag=f"shard{i}")
               for i, b in enumerate(shards)]
    ex = registry.make_executor("workers", workers=workers)
    try:
        res = (tapi.Experiment(_real_job("lenet-mnist", epochs=4))
               .with_tuner("v1").with_backend("real", **SMALL)
               .with_scheduler("hyperband", eta=2).run(executor=ex))
        tags = {tid: ex.pool.worker_of(tid).tag for tid in res.records}
    finally:
        ex.close()
    assert set(tags.values()) == {"shard0", "shard1"}
    # both shards trained: each built steps of its own
    assert all(b._step_cache for b in shards)
    assert all(len(rec.epochs) >= 1 for rec in res.records.values())
    ser = (tapi.Experiment(_real_job("lenet-mnist", epochs=4))
           .with_tuner("v1").with_backend("real", **SMALL)
           .with_scheduler("hyperband", eta=2).run())
    _assert_same_records(res, ser)
    assert any(len(r.epochs) > 1 for r in res.records.values())


def test_sticky_shards_bind_the_runner(monkeypatch):
    """The runner records each trial's shard and sends its rung resumes
    and its PBT clones there."""
    be = [tsim.SimBackend(), tsim.SimBackend()]
    calls = {id(b): [] for b in be}
    for b in be:
        orig = b.run_epoch

        def run_epoch(ts, cfg, _orig=orig, _b=b, **kw):
            calls[id(_b)].append(ts.hparams["batch_size"])
            return _orig(ts, cfg, **kw)
        monkeypatch.setattr(b, "run_epoch", run_epoch)
    ex = tapi.WorkerPoolExecutor([tworker.InprocWorker(backend=b, tag=str(i))
                                  for i, b in enumerate(be)])
    job = HPTJob(workload="lenet-mnist", space=SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 256, 1024))]),
        max_epochs=9, seed=0)
    runner = TuneV1(tsim.SimBackend())
    try:
        res = runner.run_job(job, scheduler="pbt", executor=ex,
                             population=4, interval=3)
        shard_of = {tid: ex.pool.worker_of(tid).backend
                    for tid in res.records}
    finally:
        ex.close()
    assert all(calls[id(b)] for b in be)
    assert all(runner.backend_for(tid) is b for tid, b in shard_of.items())
    ref = TuneV1(tsim.SimBackend()).run_job(job, scheduler="pbt",
                                            population=4, interval=3)
    assert {t: [e.accuracy for e in r.epochs] for t, r in
            res.records.items()} == \
        {t: [e.accuracy for e in r.epochs] for t, r in ref.records.items()}


# ------------------------------------------------- what stays for later

def _item_title(num):
    m = re.search(rf"^{num}\. \*\*(.+?)\.?\*\*", ROADMAP, re.M)
    assert m, f"ROADMAP.md has no item {num}"
    return m.group(1).rstrip(".")


def test_later_items_stand_in_the_roadmap():
    for kind in registry._LATER.values():
        for note in kind.values():
            num, title = re.match(r"(\d+) \((.+)\)$", note).groups()
            assert _item_title(num) == title
    # items 8, 13, 14 and 17 are done and pruned
    for done in (8, 13, 14, 17):
        assert not re.search(rf"^{done}\. \*\*", ROADMAP, re.M)


# The executor surface that raised naming ROADMAP item 13 keeps its id
# and now traces: a fresh trace id stamped on the pool's bus as "driver",
# kept for late joiners and read back by ``Experiment.run``.
@pytest.mark.parametrize("make", [
    lambda: tapi.WorkerPoolExecutor([tworker.InprocWorker()])],
    ids=["enable-trace"])
def test_unported_executors_name_their_item(make):
    ex = make()
    bus = tevents.EventBus()
    ex.attach_bus(bus)
    try:
        tid = ex.enable_trace()
        assert re.fullmatch(r"[0-9a-f]{16}", tid)
        assert (bus.trace_id, bus.proc, bus.enabled) == (tid, "driver",
                                                         True)
        assert ex.trace_context == {"trace_id": tid, "collector": None}
        res = (tapi.Experiment(_sim_job(3)).with_tuner("v1")
               .with_backend("sim").run(executor=ex))
        recs = bus.events()
        assert {r["trial_id"] for r in recs
                if r["kind"] == "trial_completed"} == set(res.records)
        assert {r["trace"] for r in recs} == {tid}
    finally:
        ex.close()


@pytest.fixture
def sim_worker():
    """A trial worker serving in this process (sim defaults) and a
    coordinator it announces to: (worker address, coordinator address)."""
    from repro_torch.service import (CoordinatorService, TrialWorkerService,
                                     WorkerAnnouncer, serve_coordinator,
                                     serve_worker)
    coord = serve_coordinator(CoordinatorService(ttl_s=5.0), port=0,
                              background=True)
    caddr = "tcp://127.0.0.1:%d" % coord.server_address[1]
    service = TrialWorkerService()
    server = serve_worker(service, port=0, background=True)
    waddr = "tcp://127.0.0.1:%d" % server.server_address[1]
    announcer = WorkerAnnouncer(caddr, address=waddr)
    announcer.start()
    yield waddr, caddr
    announcer.stop()
    server.shutdown()
    service.close()
    coord.shutdown()


def _sim_records(res):
    return {t: ([e.accuracy for e in r.epochs], r.sys_history, r.gt_hit)
            for t, r in res.records.items()}


def _sim_job(epochs=6):
    return HPTJob(workload="lenet-mnist", space=SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        Param("learning_rate", "log", 0.001, 0.1)]), max_epochs=epochs)


# The executors that raised naming ROADMAP item 12 keep their ids here and
# now run a TuneV1 sim job: the records equal the serial executor's.
@pytest.mark.parametrize("case", ["sharded", "tcp-worker", "coordinator",
                                  "runner-spec"])
def test_item12_executors_run_jobs(case, sim_worker):
    waddr, caddr = sim_worker
    exp = tapi.Experiment(_sim_job()).with_tuner("v1").with_backend("sim")
    serial = exp.run()
    if case == "runner-spec":
        # an instance backend cannot travel: no spec, and a remote worker
        # without one is refused before any trial runs
        ex = tapi.WorkerPoolExecutor([tapi.RemoteWorker(waddr)])
        try:
            with pytest.raises(ValueError, match="runner spec"):
                (tapi.Experiment(_sim_job()).with_tuner("v1")
                 .with_backend(tsim.SimBackend()).run(executor=ex))
            ex.configure_runner_spec({"tuner": "v1", "backend": "sim"})
            assert ex.workers[0].runner_spec == {"tuner": "v1",
                                                 "backend": "sim"}
            res = exp.run(executor=ex)
        finally:
            ex.close()
    else:
        kw = {"sharded": dict(backends=["sim", "sim"]),
              "tcp-worker": dict(workers=[waddr]),
              "coordinator": dict(coordinator=caddr)}[case]
        name = "sharded" if case == "sharded" else "workers"
        ex = registry.make_executor(name, **kw)
        try:
            res = exp.run(executor=ex)
            if case == "coordinator":
                assert [w.address for w in ex.workers] == \
                    [("127.0.0.1", int(waddr.rsplit(":", 1)[1]))]
        finally:
            ex.close()
    assert _sim_records(res) == _sim_records(serial)


# The launcher flag that raised naming ROADMAP item 13 keeps its id and
# now works: the serial sim job's events land in the JSONL file, one
# dispatch and one completion a trial segment.
@pytest.mark.parametrize("flags", [["--trace", "run.jsonl"]], ids=["trace"])
def test_launcher_flags_of_later_items_raise(flags, tmp_path):
    from repro_torch.obs.sinks import read_trace
    argv = [str(tmp_path / f) if f.endswith(".jsonl") else f for f in flags]
    res = tune_launch.main(["--backend", "sim", "--epochs", "3", *argv])
    recs = read_trace(argv[-1])
    done = [r for r in recs if r["kind"] == "trial_completed"]
    assert {r["trial_id"] for r in done} == set(res.records)
    assert len(done) == len([r for r in recs
                             if r["kind"] == "trial_dispatched"])


def _launcher_lines(main, argv, capsys):
    """What a launcher prints, without its energy line (the port's H100
    power model differs from the reference's TPU constants) and without
    the executor line."""
    main() if argv is None else main(argv)
    return [line for line in capsys.readouterr().out.splitlines()
            if "energy" not in line and "executor=" not in line]


# The launcher flags that raised naming ROADMAP item 12 keep their ids and
# now run the sim launcher: the sharded flags print the reference's
# launcher's numbers for the same flags, the wire and worker flags the
# serial launcher's (the reference's numbers: tests/test_torch_cluster.py).
@pytest.mark.parametrize("flags", [
    ["--executor", "sharded", "--backends", "sim,sim"],
    ["--executor", "sharded", "--shard-capacity", "2"],
    ["--coordinator", "COORD"],
    ["--store", "STORE", "--wire", "json"],
    ["--workers", "WORKER"]],
    ids=["backends", "shard-capacity", "coordinator", "wire",
         "tcp-workers"])
def test_launcher_flags_of_item12_work(flags, sim_worker, capsys,
                                       monkeypatch):
    from repro_torch.service import GroundTruthService, serve
    import repro.launch.tune as jtune_launch
    waddr, caddr = sim_worker
    svc = GroundTruthService()
    store = serve(svc, port=0, background=True)
    saddr = "tcp://127.0.0.1:%d" % store.server_address[1]
    base = ["--backend", "sim", "--system", "pipetune", "--scheduler",
            "hyperband", "--epochs", "9"]
    flags = [{"COORD": caddr, "STORE": saddr, "WORKER": waddr}.get(f, f)
             for f in flags]
    if "--store" not in flags and "sharded" not in flags:
        flags += ["--store", saddr]     # remote workers share the store
    try:
        got = _launcher_lines(tune_launch.main, base + flags, capsys)
    finally:
        store.shutdown()
        svc.close()
    if "sharded" in flags:
        monkeypatch.setattr("sys.argv", ["tune", *base, *flags])
        want = _launcher_lines(jtune_launch.main, None, capsys)
    else:
        want = _launcher_lines(tune_launch.main, base, capsys)
    assert got == want
    assert any("ground truth" in line for line in got)


def test_launcher_flag_conflicts_are_errors():
    with pytest.raises(ValueError, match="conflicts with --executor"):
        tune_launch.main(["--backend", "sim", "--parallelism", "2",
                          "--executor", "cluster"])
    with pytest.raises(ValueError, match="--workers conflicts"):
        tune_launch.main(["--backend", "sim", "--workers", "sim",
                          "--executor", "parallel"])
    with pytest.raises(ValueError, match="needs --workers"):
        tune_launch.main(["--backend", "sim", "--executor", "workers"])
