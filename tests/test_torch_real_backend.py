"""``TorchRealBackend`` (registered as "real") against the reference's
``RealBackend``, on the CPU.

One epoch of each Table-3 workload runs in both packages from the same
weights and SGD momentum (carried over by ``weights.state_from_jax``) on the
same batches, at fp32 and dropout 0, under three system configs: per-step
losses agree to 1e-4 (rtol and atol; tests/test_kernels.py's gradient
tolerance), per-step training accuracy to one sample of the batch, the
epoch's eval accuracy to one sample of the eval set, and the parameters
after the epoch to 1e-4. The rest checks the port's own rules: the
``compile_s`` strip on planted step times, ``clone_trial`` sharing no
tensor, the registry's "real" sys space, a PipeTune experiment and the
tuning launcher on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.core import backends as jbackends
from repro_torch import weights
from repro_torch.api import Experiment, registry
from repro_torch.core import backends as tbackends
from repro_torch.core.backends import TorchRealBackend
from repro_torch.core.job import HPTJob, Param, SearchSpace, SystemSpace
from repro_torch.core.pipetune import TuneV1
from repro_torch.launch import tune as tune_launch

TOL = dict(rtol=1e-4, atol=1e-4)
SIZES = dict(n_train=48, n_eval=24, steps_per_epoch=3)
HPARAMS = {"batch_size": 8, "learning_rate": 0.05, "dropout": 0.0,
           "embed_dim": 64}
SYS = [{"remat": "none", "microbatches": 1, "precision": "fp32"},
       {"remat": "block", "microbatches": 2, "precision": "fp32"},
       {"remat": "none", "microbatches": 4, "precision": "fp32"}]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_steps(be, ts, sys_cfg):
    """Wrap the backend's cached train step so each step's (loss, accuracy)
    is logged as ``run_epoch`` calls it."""
    (step, ev), _ = be.get_step(ts, sys_cfg)
    log = []

    def recorded(*args):
        out = step(*args)
        log.append((float(out[2]), float(out[3])))
        return out
    be._step_cache[be._step_key(ts, be._effective_sys(ts, sys_cfg))] = \
        (recorded, ev)
    return log


@pytest.mark.parametrize("sys_cfg", SYS, ids=lambda c: f"{c['remat']}-"
                         f"{c['microbatches']}")
@pytest.mark.parametrize("name", ["lenet-mnist", "lenet-fashion",
                                  "cnn-news20", "lstm-news20"])
def test_epoch_matches_reference(name, sys_cfg):
    jbe = jbackends.RealBackend(**SIZES)
    tbe = TorchRealBackend(**SIZES, device="cpu")
    jts = jbe.init_trial(name, HPARAMS, seed=1)
    tts = tbe.init_trial(name, HPARAMS, seed=1)
    state = weights.state_from_jax(
        {"params": jax.tree.map(np.asarray, jts.params),
         "opt": jax.tree.map(np.asarray, jts.opt_state), "step": 0},
        tts.cfg, "cpu")
    tts.params, tts.opt_state = state["params"], state["opt"]
    jlog, tlog = _record_steps(jbe, jts, sys_cfg), _record_steps(tbe, tts,
                                                                 sys_cfg)
    jts, jres = jbe.run_epoch(jts, sys_cfg)
    tts, tres = tbe.run_epoch(tts, sys_cfg)

    assert len(tlog) == len(jlog) == SIZES["steps_per_epoch"]
    np.testing.assert_allclose([l for l, _ in tlog], [l for l, _ in jlog],
                               **TOL)
    np.testing.assert_allclose([a for _, a in tlog], [a for _, a in jlog],
                               atol=1.0 / HPARAMS["batch_size"] + 1e-6)
    assert tres.loss == tlog[-1][0]
    assert abs(tres.accuracy - jres.accuracy) <= 1.0 / SIZES["n_eval"] + 1e-6
    assert tres.sys_config == jres.sys_config == sys_cfg
    assert len(tres.step_times) == SIZES["steps_per_epoch"]
    assert tts.step == jts.step and tts.epoch == jts.epoch == 1
    want = weights.flatten(weights.from_jax(
        jax.tree.map(np.asarray, jts.params), tts.cfg, "cpu"))
    for path, p in weights.flatten(tts.params).items():
        np.testing.assert_allclose(p.numpy(), want[path].numpy(),
                                   err_msg=path, **TOL)
    np.testing.assert_array_equal(tres.profile.vector().shape, (58,))


@pytest.mark.parametrize("times,compile_s,want_times,want_compile", [
    ([10.0, 1.0, 2.0, 1.0], 0.5, [1.0, 1.0, 2.0, 1.0], 9.5),
    ([3.0, 1.0, 1.0], 0.0, [3.0, 1.0, 1.0], 0.0),        # not > 3x median
    ([9.0, 1.0], 0.0, [9.0, 1.0], 0.0),                  # fewer than 3 steps
    ([0.5, 1.0, 1.0], 0.2, [0.5, 1.0, 1.0], 0.2),
])
def test_compile_strip_rule(times, compile_s, want_times, want_compile):
    got = tbackends._strip_first_step(times, compile_s)
    assert times == want_times and got == pytest.approx(want_compile)


def test_clone_trial_shares_no_tensor():
    backend = TorchRealBackend(n_train=64, n_eval=32, steps_per_epoch=2,
                               device="cpu")
    runner = TuneV1(backend)
    runner.run_trial("lenet-mnist", "src", {"learning_rate": 0.01}, 1)
    runner.clone_trial("dst", "src")
    src, dst = runner.states["src"], runner.states["dst"]
    pairs = list(zip(weights.flatten(src.params).values(),
                     weights.flatten(dst.params).values()))
    pairs += list(zip(weights.flatten(src.opt_state).values(),
                      weights.flatten(dst.opt_state).values()))
    assert len(pairs) == 20
    for a, b in pairs:
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    before = [a.clone() for a, _ in pairs]
    # both trials keep training independently (updates are in place)
    runner.run_trial("lenet-mnist", "dst", {"learning_rate": 0.02}, 2)
    assert all(torch.equal(a, b) for (a, _), b in zip(pairs, before))
    runner.run_trial("lenet-mnist", "src", {"learning_rate": 0.01}, 2)
    assert runner.states["src"].epoch == runner.states["dst"].epoch == 2


def test_step_cache_honours_the_learning_rate():
    """Two trials that differ only in learning rate train at their own
    rates on one backend (the reference's step cache would hand the second
    trial the first one's step)."""
    shared = TorchRealBackend(**SIZES, device="cpu")
    losses = {}
    for lr in (0.01, 0.2):
        hp = dict(HPARAMS, learning_rate=lr)
        fresh = TorchRealBackend(**SIZES, device="cpu")
        for be in (shared, fresh):
            ts = be.init_trial("lenet-mnist", hp, seed=1)
            _, res = be.run_epoch(ts, SYS[0])
            losses.setdefault(lr, []).append(res.loss)
    assert losses[0.2][0] == losses[0.2][1] != losses[0.01][0]


def test_real_backend_registry_and_capabilities():
    be = registry.make_backend("real", device="cpu", n_train=32)
    assert isinstance(be, TorchRealBackend) and be.n_train == 32
    caps = be.capabilities()
    assert not (caps.async_precompile or caps.simulated or caps.deterministic)
    space = registry.default_sys_space("real", device="cpu")
    assert [c["precision"] for c in space.configs()] == ["fp32"] * 6
    assert {(c["remat"], c["microbatches"]) for c in space.configs()} == {
        (r, m) for r in ("none", "block") for m in (1, 2, 4)}


def _job(epochs=3):
    space = SearchSpace([Param("batch_size", "choice", choices=(8, 16)),
                         Param("learning_rate", "log", 0.01, 0.1)])
    return HPTJob(workload="lenet-mnist", space=space, max_epochs=epochs)


def test_pipetune_experiment_on_cpu():
    res = (Experiment(_job()).with_tuner("pipetune", max_probes=2)
           .with_backend("real", device="cpu", n_train=64, n_eval=32,
                         steps_per_epoch=2)
           .with_sys_space(SystemSpace(remat=("none", "block"),
                                       microbatches=(1, 2),
                                       precision=("fp32",)))
           .with_scheduler("random", n_trials=3).run())
    assert res.gt_hits + res.gt_misses > 0
    assert len(res.records) == 3
    for rec in res.records.values():
        assert len(rec.epochs) == 3 and len(rec.sys_history) == 3
        assert rec.sys_history[0] == tbackends.SYS_DEFAULT
        assert all(np.isfinite(e.loss) for e in rec.epochs)
    assert 0.0 <= res.best_accuracy <= 1.0 and res.tuning_time_s > 0


def test_tune_launcher_on_cpu(monkeypatch, capsys, tmp_path):
    tiny = {"factory": lambda **kw: TorchRealBackend(
        n_train=64, n_eval=32, steps_per_epoch=2, **kw),
        "sys_space": registry._real_sys_space}
    monkeypatch.setitem(registry._BACKENDS, "tiny-real", tiny)
    out = tmp_path / "res.json"
    res = tune_launch.main(["--workload", "lenet-mnist", "--backend",
                            "tiny-real", "--device", "cpu", "--epochs", "2",
                            "--out", str(out)])
    text = capsys.readouterr().out
    assert "workload=lenet-mnist system=pipetune scheduler=hyperband" in text
    assert "executor=SerialTrialExecutor" in text
    assert f"ground truth  : {res.gt_hits} hits / {res.gt_misses} " in text
    assert res.gt_hits + res.gt_misses > 0 and out.exists()


def test_tune_launcher_needs_a_gpu_or_device_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune_launch.main(["--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune_launch.main(["--epochs", "1", "--parallelism", "2"])
    # the parallel executor now runs a real PipeTune job on the CPU
    tiny = {"factory": lambda **kw: TorchRealBackend(
        n_train=64, n_eval=32, steps_per_epoch=2, **kw),
        "sys_space": registry._real_sys_space}
    monkeypatch.setitem(registry._BACKENDS, "tiny-real", tiny)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)        # two lanes; keep their teams small
    try:
        for flags in (["--parallelism", "2"], ["--executor", "parallel"]):
            res = tune_launch.main(["--backend", "tiny-real", "--device",
                                    "cpu", "--epochs", "2", *flags])
            assert "executor=ParallelTrialExecutor" in \
                capsys.readouterr().out
            assert res.gt_hits + res.gt_misses == len(res.records) > 0
            assert all(len(r.epochs) >= 1 and np.isfinite(r.epochs[-1].loss)
                       for r in res.records.values())
    finally:
        torch.set_num_threads(n_threads)
