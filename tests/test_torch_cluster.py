"""The port's simulated cluster (``repro_torch.cluster``) against the
reference's (``repro.cluster``) on the same seeds.

Exact equality (``==`` on float64) throughout: the perf model over a grid
of workloads, batches and chips; the event engine's completion order and
times under faults, stragglers, preemption and node join/retire; every
``JobResult`` field of TuneV1, TuneV2 and PipeTune on ``SimBackend`` under
hyperband, asha, asha-async and pbt on the serial, parallel(4) and cluster
executors; ``ClusterSim``'s outcomes in the event and legacy modes, with
and without ``ElasticPolicy``; and the launcher's printout. Energies are
the port's own power model (the H100's constants) at the reference's
durations and utilisations; with the reference's constants patched into
the port they are the reference's exactly, and so are PipeTune's decisions
under ``probe_objective="energy"``.
"""
import dataclasses
import itertools

import numpy as np
import pytest

import repro.api as japi
import repro.cluster.engine as jengine
import repro.cluster.perfmodel as jperf
import repro.cluster.sim as jsim
import repro.core as jcore
import repro.core.energy as jenergy
import repro.core.job as jjob
import repro_torch.api as tapi
import repro_torch.cluster.engine as tengine
import repro_torch.cluster.perfmodel as tperf
import repro_torch.cluster.sim as tsim
import repro_torch.core as tcore
import repro_torch.core.energy as tenergy
import repro_torch.core.job as tjob
from repro_torch.launch import tune as tune_launch

PKGS = {"reference": (japi, jengine, jsim, jcore, jjob),
        "port": (tapi, tengine, tsim, tcore, tjob)}
WORKLOADS = list(jperf.WORKLOADS)


# ---------------------------------------------------------------- perfmodel

@pytest.mark.parametrize("workload", WORKLOADS)
def test_perfmodel_is_the_reference_exactly(workload):
    assert tperf.WORKLOADS == jperf.WORKLOADS
    assert (tperf.SYNC_COST_S, tperf.PROFILE_DIM) == \
        (jperf.SYNC_COST_S, jperf.PROFILE_DIM)
    for bs, chips in itertools.product((1, 32, 64, 128, 256, 1024),
                                       (1, 2, 4, 8, 16)):
        for mem, prec in itertools.product((1, 4, 32), ("fp32", "bf16")):
            assert tperf.epoch_time_s(workload, bs, chips, mem, prec) == \
                jperf.epoch_time_s(workload, bs, chips, mem, prec)
        assert tperf.utilization(workload, bs, chips) == \
            jperf.utilization(workload, bs, chips)
        for seed in (0, 3):
            a = tperf.profile_vector(workload, bs, chips, seed=seed)
            b = jperf.profile_vector(workload, bs, chips, seed=seed)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for bs, lr, dr, epoch, seed in itertools.product(
            (32, 128, 1024), (0.001, 0.0146, 0.1), (0.0, 0.27), (0, 4, 8),
            (0, 5)):
        hp = {"batch_size": bs, "learning_rate": lr, "dropout": dr}
        assert tperf.accuracy_at(workload, hp, epoch, seed) == \
            jperf.accuracy_at(workload, hp, epoch, seed)


# ------------------------------------------------------------------- engine

def _stats(eng, stats):
    return ([s.task_id for s in eng.completed],
            [dataclasses.asdict(s) for s in stats], eng.now)


def _fifo(m):
    eng = m.EventEngine(m.ClusterConfig(n_nodes=1, seed=0))
    stats = [eng.submit(f"t{i}", iter([10.0, 10.0]), at=float(i))
             for i in range(3)]
    eng.run()
    return _stats(eng, stats)


def _faults(m):
    out = []
    for mitigate in (True, False):
        eng = m.EventEngine(m.ClusterConfig(
            n_nodes=2, straggler_prob=0.3, mtbf_s=200.0, seed=7,
            mitigate_stragglers=mitigate))
        stats = [eng.submit(f"t{i}", iter([50.0, 20.0, 80.0] * 2))
                 for i in range(4)]
        eng.run()
        out.append(_stats(eng, stats))
    return out


def _next_completion(m):
    eng = m.EventEngine(m.ClusterConfig(n_nodes=2, seed=0))
    eng.submit("slow", iter([100.0]))
    eng.submit("fast", iter([10.0]))
    eng.submit("mid", iter([40.0, 5.0]))
    order = []
    while True:
        s = eng.run_next_completion()
        if s is None:
            break
        order.append((s.task_id, eng.now))
    return order


def _nodespecs(m):
    eng = m.EventEngine(m.ClusterConfig(nodes=[
        m.NodeSpec(speed=2.0), m.NodeSpec(speed=0.5, capacity=2),
        m.NodeSpec(tag="x")]))
    stats = [eng.submit(f"t{i}", iter([10.0, 30.0])) for i in range(5)]
    stats.append(eng.submit("tagged", iter([7.0]), tag="x"))
    eng.run()
    return _stats(eng, stats)


def _join_retire_preempt(m):
    cfg = m.ClusterConfig(n_nodes=2, straggler_prob=0.3, mtbf_s=500.0,
                          seed=11)
    eng = m.EventEngine(cfg)
    stats = [eng.submit(f"t{i}", iter([50.0] * 5)) for i in range(5)]
    eng.add_node(m.NodeSpec(speed=0.5), at=60.0)
    eng.retire_node(0, at=120.0)
    eng.preempt("t1", at=80.0)
    eng.add_node(m.NodeSpec(speed=2.0), at=200.0)
    eng.run()
    return _stats(eng, stats)


def _retire_at_boundary(m):
    eng = m.EventEngine(m.ClusterConfig(n_nodes=2, seed=0))
    t = eng.submit("t", iter([10.0] * 4))
    u = eng.submit("u", iter([3.0]))
    eng.retire_node(0, at=15.0)
    eng.preempt("u", at=1.0)
    eng.run()
    return _stats(eng, [t, u])


def _charged_durations(m):
    """The reconfiguration charge on a trial's first epoch (non-default
    config) and on later switches, as ``charged_epoch_durations`` maps
    them."""
    class R:
        def __init__(self, d, cfg):
            self.duration_s, self.sys_config = d, cfg
    cfg = m.ClusterConfig()

    class PT:
        overlap_reconfig = True
    charge = m.reconfig_charge_s(cfg, PT())
    prev = {}
    seq = [R(10.0, {"chips": 4, "memory_gb": 32}),
           R(11.0, {"chips": 4, "memory_gb": 32}),
           R(12.0, {"chips": 16, "memory_gb": 8})]
    return (charge, m.reconfig_charge_s(cfg, object()),
            list(m.charged_epoch_durations(seq, "a", prev, charge,
                                           {"chips": 16, "memory_gb": 32})),
            prev)


SCENARIOS = {"fifo": _fifo, "faults": _faults,
             "next_completion": _next_completion, "nodespecs": _nodespecs,
             "join_retire_preempt": _join_retire_preempt,
             "retire_at_boundary": _retire_at_boundary,
             "charged_durations": _charged_durations}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_is_the_reference_exactly(scenario):
    ours = SCENARIOS[scenario](tengine)
    theirs = SCENARIOS[scenario](jengine)
    assert ours == theirs
    # the scenarios do exercise what they are named for
    if scenario == "faults":
        rows = [r for run in ours for r in run[1]]
        assert sum(r["n_failures"] for r in rows) > 0
        assert sum(r["n_stragglers"] for r in rows) > 0
    if scenario == "join_retire_preempt":
        assert sum(r["n_preemptions"] for r in ours[1]) > 1


def test_engine_unplaceable_task_is_a_loud_error():
    for m in (jengine, tengine):
        eng = m.EventEngine(m.ClusterConfig(n_nodes=1, seed=0))
        eng.submit("a", iter([10.0, 10.0]))
        eng.submit("b", iter([10.0]))
        eng.retire_node(0, at=5.0)
        with pytest.raises(RuntimeError, match="unplaceable"):
            eng.run()


# ---------------------------------------------------------- JobResult parity

def _space(job):
    return job.SearchSpace([
        job.Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        job.Param("learning_rate", "log", 0.001, 0.1),
        job.Param("dropout", "float", 0.0, 0.5),
    ])


SCHED_KW = {"hyperband": {}, "asha": {"n_trials": 9},
            "asha-async": {"n_trials": 9},
            "pbt": {"population": 4, "interval": 3}}
EXECUTORS = {"serial": lambda api, eng: api.make_executor(1),
             "parallel4": lambda api, eng: api.make_executor(4),
             "cluster": lambda api, eng: api.make_executor(
                 "cluster", n_nodes=3, straggler_prob=0.2, seed=1)}


def _run(pkg, tuner, scheduler, executor, **tuner_kw):
    api, eng, sim, core, job = PKGS[pkg]
    hpt = job.HPTJob(workload="cnn-news20", space=_space(job), max_epochs=9,
                     seed=3)
    exp = (api.Experiment(hpt)
           .with_tuner(tuner, **({"max_probes": 4} if tuner == "pipetune"
                                 else {}), **tuner_kw)
           .with_backend("sim")
           .with_scheduler(scheduler, **SCHED_KW[scheduler]))
    if tuner == "pipetune":
        exp = exp.with_groundtruth(core.GroundTruth())
    ex = EXECUTORS[executor](api, eng)
    try:
        return exp.run(executor=ex)
    finally:
        ex.close()


def _port_energy(res):
    """Each epoch's joules under the port's power model, at the epoch's
    duration and perfmodel's utilisation for its batch and chips."""
    return [[tenergy.power_w(jperf.utilization(
        "cnn-news20", int(r.hparams["batch_size"]), e.sys_config["chips"]),
        e.sys_config["chips"]) * e.duration_s for e in r.epochs]
        for _, r in sorted(res.records.items())]


def _fields(res, energy=True):
    recs = {tid: (r.hparams, [e.accuracy for e in r.epochs],
                  [e.loss for e in r.epochs],
                  [e.duration_s for e in r.epochs], r.sys_history,
                  [e.sys_config for e in r.epochs], r.gt_hit,
                  r.probe_epochs)
            for tid, r in res.records.items()}
    out = dict(records=recs, best_hparams=res.best_hparams,
               best_score=res.best_score,
               best_trial=res.best_record.trial_id,
               tuning_time_s=res.tuning_time_s, sim_time_s=res.sim_time_s,
               gt_hits=res.gt_hits, gt_misses=res.gt_misses)
    if energy:
        out["energy"] = [[e.energy_j for e in r.epochs]
                         for _, r in sorted(res.records.items())]
        out["energy_j"] = res.energy_j
    return out


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("scheduler", sorted(SCHED_KW))
@pytest.mark.parametrize("tuner", ["v1", "v2", "pipetune"])
def test_job_result_is_the_reference_exactly(tuner, scheduler, executor):
    ours = _run("port", tuner, scheduler, executor)
    theirs = _run("reference", tuner, scheduler, executor)
    energies = [[e.energy_j for e in r.epochs]
                for _, r in sorted(ours.records.items())]
    if executor == "parallel4" and tuner != "v1":
        # Lanes share TuneV2's sys-config generator and PipeTune's
        # ground-truth store, so which trial draws which config, or finds
        # which store entry, follows the order the lanes reach them (the
        # reference documents this). What no interleaving moves is held
        # exactly: the trials, and for PipeTune the whole search (its
        # accuracy objective ignores sys configs) and the number of store
        # lookups; for TuneV2 every epoch is the reference SimBackend's
        # epoch for the trial's hparams and drawn config.
        assert ours.records.keys() == theirs.records.keys()
        assert energies == _port_energy(ours)
        if tuner == "pipetune":
            def search(res):
                return {t: (r.hparams, [e.accuracy for e in r.epochs],
                            [e.loss for e in r.epochs])
                        for t, r in res.records.items()}
            assert search(ours) == search(theirs)
            assert (ours.best_hparams, ours.best_score) == \
                (theirs.best_hparams, theirs.best_score)
            assert ours.gt_hits + ours.gt_misses == \
                theirs.gt_hits + theirs.gt_misses
        elif scheduler == "pbt":     # fixed population, fixed budget
            assert {t: len(r.epochs) for t, r in ours.records.items()} == \
                {t: len(r.epochs) for t, r in theirs.records.items()}
        else:
            be = jsim.SimBackend()
            for tid, rec in ours.records.items():
                assert rec.hparams == theirs.records[tid].hparams
                assert len({str(h) for h in rec.sys_history}) == 1
                ts = be.init_trial("cnn-news20", rec.hparams, seed=0)
                for e, cfg in zip(rec.epochs, rec.sys_history):
                    _, ref = be.run_epoch(ts, cfg)
                    assert (e.accuracy, e.duration_s, e.sys_config) == \
                        (ref.accuracy, ref.duration_s, ref.sys_config), tid
        return
    assert _fields(ours, energy=False) == _fields(theirs, energy=False)
    assert energies == _port_energy(theirs)
    assert (ours.sim_time_s > 0) == (executor == "cluster")


def test_energy_is_the_reference_with_its_constants(monkeypatch):
    """The port's sim charges the port's power model; with the reference's
    per-chip constants patched in (here only), energies are the
    reference's exactly, and so are PipeTune's probe decisions and
    ground-truth outcomes when probing minimises energy."""
    ours = _run("port", "pipetune", "hyperband", "serial",
                probe_objective="energy")
    assert ours.energy_j != _run("reference", "pipetune", "hyperband",
                                 "serial", probe_objective="energy").energy_j
    monkeypatch.setattr(tenergy, "P_IDLE_W", jenergy.P_IDLE_W)
    monkeypatch.setattr(tenergy, "P_DYN_W", jenergy.P_DYN_W)
    for executor in ("serial", "cluster"):
        ours = _run("port", "pipetune", "hyperband", executor,
                    probe_objective="energy")
        theirs = _run("reference", "pipetune", "hyperband", executor,
                      probe_objective="energy")
        assert _fields(ours) == _fields(theirs)
    assert ours.gt_hits > 0 and any(
        e.sys_config["chips"] != jsim.SIM_SYS_DEFAULT["chips"]
        for r in ours.records.values() for e in r.epochs)


# ---------------------------------------------------------------- ClusterSim

def _outcomes(pkg, mode, elastic, tuner):
    api, eng, sim, core, job = PKGS[pkg]
    jobs = sim.make_arrivals(["lenet-mnist", "cnn-news20", "lstm-news20"],
                             n_jobs=8, mean_interarrival_s=40.0,
                             space=_space(job), max_epochs=6, seed=2)
    cfg = eng.ClusterConfig(n_nodes=2, seed=5, mtbf_s=2000.0,
                            straggler_prob=0.2)
    gt = core.GroundTruth()
    factory = {"v1": lambda: core.TuneV1(sim.SimBackend()),
               "pipetune": lambda: core.PipeTune(
                   sim.SimBackend(), sim.SimSystemSpace(), groundtruth=gt,
                   max_probes=4)}[tuner]
    policy = sim.ElasticPolicy(split_queue=2) if elastic else None
    out = sim.ClusterSim(cfg, factory, mode=mode, elastic=policy).run(
        jobs, scheduler="random", n_trials=3)
    rows = [dataclasses.asdict(o) for o in out]
    if policy is not None:
        return rows, (policy.n_splits, policy.n_merges)
    return rows, None


@pytest.mark.parametrize("mode,elastic", [("event", False), ("event", True),
                                          ("legacy", False)])
@pytest.mark.parametrize("tuner", ["v1", "pipetune"])
def test_cluster_sim_is_the_reference_exactly(monkeypatch, mode, elastic,
                                              tuner):
    # the outcomes' energies are compared at the reference's constants
    monkeypatch.setattr(tenergy, "P_IDLE_W", jenergy.P_IDLE_W)
    monkeypatch.setattr(tenergy, "P_DYN_W", jenergy.P_DYN_W)
    ours = _outcomes("port", mode, elastic, tuner)
    theirs = _outcomes("reference", mode, elastic, tuner)
    assert ours == theirs
    assert all(r["finish"] > r["arrival"] for r in ours[0])
    if elastic:
        assert ours[1][0] > 0


def test_make_arrivals_is_the_reference():
    jobs = [sim.make_arrivals(["lenet-mnist", "cnn-news20"], n_jobs=12,
                              mean_interarrival_s=60.0,
                              space=_space(job), seed=4)
            for _, _, sim, _, job in PKGS.values()]
    assert [(j.workload, j.arrival_time, j.job_id, j.seed, j.max_epochs)
            for j in jobs[0]] == \
        [(j.workload, j.arrival_time, j.job_id, j.seed, j.max_epochs)
         for j in jobs[1]]


# ----------------------------------------------------------------- launcher

LAUNCH = ["--backend", "sim", "--system", "pipetune", "--scheduler",
          "hyperband", "--epochs", "9"]


@pytest.mark.parametrize("flags", [[], ["--parallelism", "4"],
                                   ["--executor", "cluster"]],
                         ids=["serial", "parallel4", "cluster"])
def test_sim_launcher_prints_the_reference_numbers(capsys, flags):
    res = tune_launch.main(LAUNCH + flags)
    text = capsys.readouterr().out
    assert "  best accuracy : 0.9953\n" in text
    assert ("  best hparams  : {'batch_size': 32, 'learning_rate': "
            "0.014589472312361858, 'dropout': 0.26868661472450533}") in text
    assert "  tuning time   : 2978.3s (17 trials)\n" in text
    assert "  ground truth  : 8 hits / 9 misses\n" in text
    assert f"  energy        : {res.energy_j / 1e3:.1f} kJ\n" in text
    assert ("  cluster makespan: 1349.2s simulated\n" in text) == \
        (flags == ["--executor", "cluster"])
    name = {"": "SerialTrialExecutor", "--parallelism": "ParallelTrialExecutor",
            "--executor": "ClusterTrialExecutor"}[flags[0] if flags else ""]
    assert f"executor={name} " in text
    # energy: the port's power model at the modeled durations
    expected = sum(tenergy.power_w(jperf.utilization(
        "lenet-mnist", int(r.hparams["batch_size"]), e.sys_config["chips"]),
        e.sys_config["chips"]) * e.duration_s
        for r in res.records.values() for e in r.epochs)
    assert res.energy_j == pytest.approx(expected, rel=1e-12)


def test_sim_launcher_refuses_a_device():
    with pytest.raises(ValueError, match="touches no device"):
        tune_launch.main(LAUNCH + ["--device", "cpu"])
