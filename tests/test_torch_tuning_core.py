"""The port's tuning core (job, schedulers, executor, trial runner,
Experiment) against the reference's.

Every scheduler, fed the same seeded scores in both packages, proposes the
same waves and picks the same best; ``Experiment`` + ``TuneV1`` + the
serial executor over a deterministic stub backend gives the reference's
records; ``clone_trial`` shares no tensor between source and clone; names
the port lacks raise and name their ROADMAP item, and the names the
tuning-loop slice brought build.
"""
import math

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.backends as jbackends
import repro.core.job as jjob
import repro.core.profiler as jprofiler
import repro.core.schedulers as jsched
import repro_torch.api as tapi
import repro_torch.core.backends as tbackends
import repro_torch.core.job as tjob
import repro_torch.core.profiler as tprofiler
import repro_torch.core.schedulers as tsched
from repro_torch.core.pipetune import TuneV1, copy_tree

PKGS = {"reference": (jjob, jsched, jbackends, jprofiler, japi),
        "port": (tjob, tsched, tbackends, tprofiler, tapi)}


def _space(job):
    return job.SearchSpace([
        job.Param("x", "float", 0.0, 1.0),
        job.Param("lr", "log", 1e-3, 1e-1),
        job.Param("width", "int", 1, 9),
        job.Param("act", "choice", choices=("relu", "tanh", "gelu")),
    ])


def _score(tid, hp, epochs):
    """Deterministic, seed-free score that rises with epochs."""
    base = 1.0 - (hp["x"] - 0.6) ** 2 - 0.1 * abs(math.log10(hp["lr"]) + 2)
    base += 0.01 * hp["width"] + {"relu": 0.0, "tanh": 0.02,
                                  "gelu": 0.04}[hp["act"]]
    return base * (1.0 - math.exp(-epochs)) + 1e-6 * len(tid)


SCHEDULERS = {
    "grid": lambda s, sp: s.GridSearch(sp, per_dim=2, epochs=3),
    "random": lambda s, sp: s.RandomSearch(sp, n_trials=7, epochs=3, seed=3),
    "hyperband": lambda s, sp: s.HyperBand(sp, R=9, eta=3, seed=1),
    "pbt": lambda s, sp: s.PBT(sp, population=6, total_epochs=9,
                               interval=3, seed=2),
    "asha": lambda s, sp: s.ASHA(sp, max_epochs=9, n_trials=10, seed=4),
    "asha-async": lambda s, sp: s.AsyncASHA(sp, max_epochs=9, n_trials=9,
                                            seed=5),
}


def _drive(pkg, name):
    job, sched = PKGS[pkg][:2]
    sch = SCHEDULERS[name](sched, _space(job))
    waves = []
    while True:
        wave = sch.suggest()
        if not wave:
            break
        waves.append([(p.trial_id, p.hparams, p.epochs, p.clone_from)
                      for p in wave])
        for p in wave:
            sch.report(p.trial_id, _score(p.trial_id, p.hparams, p.epochs))
    return waves, sch.best(), sch.done


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_waves_match_reference(name):
    ours, theirs = _drive("port", name), _drive("reference", name)
    assert ours == theirs
    assert len(ours[0]) >= 1 and ours[2]


class StubBackend:
    """Deterministic backend over either package's protocol types: the
    'model' is a parameter vector that each epoch moves toward a target
    set by the hyperparameters; accuracy is a function of it."""

    def __init__(self, pkg):
        _, _, self.be, self.prof, _ = PKGS[pkg]
        self.tensor = pkg == "port"

    def capabilities(self):
        return self.be.BackendCapabilities(deterministic=True)

    def init_trial(self, workload, hparams, seed=0):
        w = np.full(3, 0.1 * seed + 0.5)
        params = {"w": torch.tensor(w) if self.tensor else w}
        return self.be.TrialState(
            workload=workload, hparams=dict(hparams), cfg=None, params=params,
            opt_state=None, step=0, epoch=0, data=None, eval_batch={},
            seed=seed)

    def run_epoch(self, ts, sys_cfg, collect_profile=True):
        target = ts.hparams["x"]
        w = ts.params["w"]
        w += (target - w) * ts.hparams["lr"] * 5      # in place, as a step
        dist = float(((w - 0.6) ** 2).sum())
        ts.epoch += 1
        ts.step += 4
        dur = 0.5 + 0.01 * ts.hparams["width"]
        return ts, self.be.EpochResult(
            duration_s=dur, energy_j=2 * dur, loss=dist,
            accuracy=1.0 / (1.0 + dist), sys_config=dict(sys_cfg),
            profile=self.prof.EpochProfile({"rt.epoch_time": dur}),
            step_times=[dur / 4] * 4)


def _experiment(pkg, scheduler, **kw):
    job, _, _, _, api = PKGS[pkg]
    hpt = job.HPTJob(workload="stub", space=_space(job), max_epochs=9,
                     seed=7)
    return (api.Experiment(hpt).with_tuner("v1")
            .with_backend(StubBackend(pkg))
            .with_scheduler(scheduler, **kw).run())


def _record_view(res):
    recs = {tid: (r.hparams, r.sys_history,
                  [(e.accuracy, e.loss, e.duration_s, e.energy_j,
                    e.sys_config, e.step_times) for e in r.epochs])
            for tid, r in res.records.items()}
    return (list(res.records), recs, res.best_hparams, res.best_score,
            res.best_record.trial_id, res.tuning_time_s, res.energy_j)


@pytest.mark.parametrize("scheduler,kw", [("hyperband", {}),
                                          ("pbt", {"population": 4}),
                                          ("random", {"n_trials": 5})])
def test_experiment_records_match_reference(scheduler, kw):
    ours = _record_view(_experiment("port", scheduler, **kw))
    theirs = _record_view(_experiment("reference", scheduler, **kw))
    assert ours[0] == theirs[0]                         # trial order
    for tid in ours[0]:
        o, t = ours[1][tid], theirs[1][tid]
        assert o[:2] == t[:2]
        np.testing.assert_allclose([e[:4] for e in o[2]],
                                   [e[:4] for e in t[2]], rtol=1e-12)
        assert [e[4:] for e in o[2]] == [e[4:] for e in t[2]]
    assert ours[2] == theirs[2] and ours[4] == theirs[4]
    np.testing.assert_allclose(ours[3], theirs[3], rtol=1e-12)
    np.testing.assert_allclose(ours[5:], theirs[5:], rtol=1e-12)


def test_clone_trial_shares_no_tensor():
    runner = TuneV1(StubBackend("port"))
    runner.run_trial("stub", "src", {"x": 0.9, "lr": 0.05, "width": 2,
                                     "act": "relu"}, 2)
    src = runner.states["src"]
    src.opt_state = {"m": [torch.ones(2), (torch.zeros(3),)], "step": 2}
    runner.clone_trial("dst", "src")
    dst = runner.states["dst"]
    pairs = [(src.params["w"], dst.params["w"]),
             (src.opt_state["m"][0], dst.opt_state["m"][0]),
             (src.opt_state["m"][1][0], dst.opt_state["m"][1][0])]
    for a, b in pairs:
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    before = src.params["w"].clone()
    runner.run_trial("stub", "dst", dst.hparams, 4)     # trains in place
    assert torch.equal(src.params["w"], before)
    assert not torch.equal(dst.params["w"], before)
    assert dst.opt_state["step"] == 2
    assert [e.accuracy for e in runner.records["dst"].epochs[:2]] == \
        [e.accuracy for e in runner.records["src"].epochs]
    assert copy_tree(None) is None and copy_tree((1, "a")) == (1, "a")


# The cases of names that the tuning-loop slice brought (real, pipetune,
# v2) keep their ids and now assert that the name builds.
@pytest.mark.parametrize("kind,name,item", [
    ("backend", "sim", "2b"),
    pytest.param("backend", "real", None, id="backend-real-2b"),
    ("backend", "numeric", "9"),
    pytest.param("tuner", "pipetune", None, id="tuner-pipetune-2b"),
    pytest.param("tuner", "v2", None, id="tuner-v2-2b"),
    ("executor", "parallel", "2b")])
def test_missing_names_list_registered_and_roadmap_item(kind, name, item):
    from repro_torch.api import registry
    space = tjob.SystemSpace(remat=("none",), microbatches=(1,),
                             precision=("fp32",))
    make = {"backend": lambda: registry.make_backend(name, device="cpu"),
            "tuner": lambda: registry.make_tuner(
                name, StubBackend("port"), sys_space=space),
            "executor": lambda: registry.make_executor(name)}[kind]
    if item is None:
        built = make()
        assert type(built).__name__ == {"real": "TorchRealBackend",
                                        "pipetune": "PipeTune",
                                        "v2": "TuneV2"}[name]
        assert name in getattr(registry, f"available_{kind}s")()
    else:
        with pytest.raises(KeyError) as err:
            make()
        msg = str(err.value)
        assert f"item {item}" in msg and "available" in msg
    assert set(registry.available_schedulers()) == {
        "grid", "random", "hyperband", "asha", "asha-async", "pbt"}
