"""PipeTune's own tuners in the port against the reference: probing plans,
the k-means ground-truth store, ``TuneV2`` and ``PipeTune``.

All of it is numpy arithmetic in both packages, so the checks are exact:
the same probe order, the same k-means centroids (to 1e-12), the same
lookups, a store saved by either package loading in the other, and the same
trial records over the deterministic stub backend of
``test_torch_tuning_core.py``, extended so that an epoch's duration depends
on its system config and the profile on the workload.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi
import repro.core.groundtruth as jgt
import repro.core.job as jjob
import repro.core.probing as jprobing
import repro_torch.api as tapi
import repro_torch.core.groundtruth as tgt
import repro_torch.core.job as tjob
import repro_torch.core.probing as tprobing
from test_torch_tuning_core import PKGS, StubBackend, _space

SYS = {"reference": jjob.SystemSpace, "port": tjob.SystemSpace}


def _configs(pkg):
    return SYS[pkg](remat=("none", "block"), microbatches=(1, 2, 4),
                    precision=("fp32", "bf16")).configs()


@pytest.mark.parametrize("max_probes,seed", [(None, 0), (4, 0), (5, 3),
                                             (12, 7), (1, 1)])
def test_probe_plans_match_reference(max_probes, seed):
    for plan in ("plan_grid", "plan_diverse"):
        ours = getattr(tprobing, plan)(_configs("port"), max_probes, seed)
        theirs = getattr(jprobing, plan)(_configs("reference"), max_probes,
                                         seed)
        assert ours.configs == theirs.configs, plan


def test_probe_plan_best_matches_reference():
    plans = []
    for mod, pkg in ((tprobing, "port"), (jprobing, "reference")):
        plan = mod.plan_grid(_configs(pkg), 4)
        i = 0
        while not plan.done:
            plan.record(mod.ProbeResult(sys_config=plan.next_config(),
                                        duration_s=4.0 - i,
                                        energy_j=1.0 + (i - 2) ** 2,
                                        accuracy=0.5, loss=1.0))
            i += 1
        plans.append(plan)
    assert len(plans[0].results) == len(plans[1].results) == 4
    for objective in ("duration", "energy", "edp", "other"):
        assert plans[0].best(objective) == plans[1].best(objective)


def _profiles(n=24, d=58, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(3, d) * 20.0
    return np.stack([centers[i % 3] + rng.randn(d) for i in range(n)])


@pytest.mark.parametrize("k,seed", [(1, 0), (3, 0), (4, 5)])
def test_kmeans_matches_reference(k, seed):
    X = _profiles()
    ours = tgt.KMeans(k=k, seed=seed).fit(X)
    theirs = jgt.KMeans(k=k, seed=seed).fit(X)
    np.testing.assert_allclose(ours.centroids, theirs.centroids, rtol=1e-12)
    np.testing.assert_array_equal(ours.labels_, theirs.labels_)
    assert ours.inertia_ == pytest.approx(theirs.inertia_, rel=1e-12)
    for x in _profiles(5, seed=9):
        assert ours.predict(x) == theirs.predict(x)


def _filled(mod, path=None):
    gt = mod.GroundTruth(k=2, path=path)
    X = _profiles(8)
    for i, x in enumerate(X):
        gt.add(x, f"w{i % 3}", {"remat": "none", "microbatches": 1 + i % 3},
               objective=0.1 * i)
    return gt


def _queries():
    """Jittered copies of stored profiles (hits) and far-away ones
    (misses)."""
    near = _profiles(6) + 0.1 * np.random.RandomState(4).randn(6, 58)
    return np.concatenate([near, _profiles(2) + 500.0])


def _lookups(gt):
    return [gt.lookup(q) for q in _queries()], (gt.hits, gt.misses)


def test_groundtruth_lookups_match_reference():
    ours, theirs = _lookups(_filled(tgt)), _lookups(_filled(jgt))
    assert ours[1] == theirs[1] and ours[1][0] > 0 and ours[1][1] > 0
    for (s1, c1), (s2, c2) in zip(ours[0], theirs[0]):
        assert c1 == c2 and s1 == pytest.approx(s2, rel=1e-12)
    model = _filled(tgt).centroid_model()
    back = tgt.CentroidModel.from_payload(model.to_payload())
    qs = _queries()
    assert back.evaluate_many(qs) == [model.evaluate(q) for q in qs]


@pytest.mark.parametrize("writer,reader", [(tgt, jgt), (jgt, tgt)])
def test_groundtruth_store_round_trips_between_packages(tmp_path, writer,
                                                        reader):
    path = str(tmp_path / "gt.json")
    src = _filled(writer, path)
    src.lookup(_queries()[0])
    src.save(path)
    loaded = reader.GroundTruth(k=2, path=path)
    assert (loaded.hits, loaded.misses, loaded.version) == \
        (src.hits, src.misses, src.version)
    assert [e.sys_config for e in loaded.entries] == \
        [e.sys_config for e in src.entries]
    assert _lookups(loaded) == _lookups(src)


def test_corrupt_store_is_a_hard_error(tmp_path):
    path = tmp_path / "gt.json"
    path.write_text('{"entries": [{"profile": [1.0]')
    with pytest.raises(tgt.GroundTruthError, match="corrupt"):
        tgt.GroundTruth(path=str(path))


class SysStub(StubBackend):
    """The stub backend with an epoch duration that depends on the system
    config (microbatches and remat cost time) and a profile that depends on
    the workload, so PipeTune's probing and ground-truth lookups have
    something to find."""

    def run_epoch(self, ts, sys_cfg, collect_profile=True):
        ts, res = super().run_epoch(ts, sys_cfg, collect_profile)
        res.duration_s *= (1.0 + 0.3 * sys_cfg.get("microbatches", 1)
                           + (0.2 if sys_cfg.get("remat") == "block" else 0.0)
                           + (0.1 if sys_cfg.get("precision") == "bf16"
                              else 0.0))
        res.energy_j = 2.0 * res.duration_s
        res.step_times = [res.duration_s / 4] * 4
        size = {"stub-a": 1.0, "stub-b": 1e6}[ts.workload]
        res.profile = self.prof.EpochProfile(
            {"rt.epoch_time": 1.0, "shape.params": size,
             "shape.batch": 32.0})
        return ts, res


def _tuner_run(pkg, tuner, workloads=("stub-a", "stub-b", "stub-a"), **kw):
    job, _, _, _, api = PKGS[pkg]
    gt = {"reference": jgt, "port": tgt}[pkg].GroundTruth()
    out = []
    for i, wl in enumerate(workloads):
        hpt = job.HPTJob(workload=wl, space=_space(job), max_epochs=9,
                         seed=7 + i)
        exp = (api.Experiment(hpt).with_tuner(tuner, **kw)
               .with_backend(SysStub(pkg))
               .with_sys_space(SYS[pkg](remat=("none", "block"),
                                        microbatches=(1, 2, 4),
                                        precision=("fp32", "bf16")))
               .with_scheduler("hyperband"))
        if tuner == "pipetune":
            exp = exp.with_groundtruth(gt)
        res = exp.run()
        out.append((
            list(res.records),
            {tid: (r.hparams, r.sys_history, r.gt_hit, r.probe_epochs,
                   [(e.duration_s, e.accuracy) for e in r.epochs])
             for tid, r in res.records.items()},
            res.best_hparams, res.best_score, res.best_record.trial_id,
            res.tuning_time_s, res.energy_j, res.gt_hits, res.gt_misses,
            res.sim_time_s))
    return out


@pytest.mark.parametrize("tuner,kw", [("v2", {}), ("tunev2", {}),
                                      ("pipetune", {"max_probes": 4}),
                                      ("pipetune", {"max_probes": 12,
                                                    "probe_order": "grid"})])
def test_tuner_records_match_reference(tuner, kw):
    ours, theirs = _tuner_run("port", tuner, **kw), _tuner_run("reference",
                                                               tuner, **kw)
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        assert o[0] == t[0]
        for tid in o[0]:
            assert o[1][tid][:4] == t[1][tid][:4], tid
            np.testing.assert_allclose(o[1][tid][4], t[1][tid][4],
                                       rtol=1e-12)
        assert o[2] == t[2] and o[4] == t[4] and o[7:] == t[7:]
        np.testing.assert_allclose([o[3], o[5], o[6]], [t[3], t[5], t[6]],
                                   rtol=1e-12)
    if tuner == "pipetune":
        hits = [o[7] for o in ours]
        assert hits[-1] > hits[0]          # the store learns across jobs
        probes = [r[3] for o in ours for r in o[1].values()]
        assert max(probes) > 0


def test_registry_resolves_the_tuning_loop_names():
    be = SysStub("port")
    space = tjob.SystemSpace(remat=("none",), microbatches=(1, 2),
                             precision=("fp32",))
    assert type(tapi.make_tuner("v2", be, sys_space=space)).__name__ == \
        "TuneV2"
    pt = tapi.make_tuner("pipetune", be, sys_space=space, max_probes=3)
    assert type(pt).__name__ == "PipeTune" and pt.max_probes == 3
    assert isinstance(pt.groundtruth, tgt.GroundTruth)
    for name in ("v2", "pipetune"):
        with pytest.raises(ValueError, match="sys_space"):
            tapi.make_tuner(name, be)
    assert set(tapi.available_tuners()) == set(japi.available_tuners())
    assert tapi.default_sys_space("kernel-tune") is None
