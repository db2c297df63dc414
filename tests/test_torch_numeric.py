"""The Type-III numeric workloads (``repro_torch.models.numeric``,
``TorchNumericBackend``, registered as "numeric") against the reference's
``repro.models.numeric`` and ``NumericBackend``, on the CPU.

Both packages draw the same data from ``np.random.RandomState(seed)``. Over
4 fp32 epochs: jacobi's ``x`` and every epoch's accuracy agree to 1e-5
(rtol and atol), spkmeans' centroids to 1e-5 relative with identical
assignments, and bfs's ``visited`` exactly. In bf16 each workload's accuracy
stays within 2e-2 of the reference's bf16 run and of the port's fp32 run.
The reference's own tests (tests/test_numeric.py) are mirrored on the
port's backend.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.core.numeric_backend import NumericBackend
from repro.models import numeric as jnumeric
from repro_torch.api import registry
from repro_torch.core import GroundTruth, PipeTune, SystemSpace
from repro_torch.core.numeric_backend import TorchNumericBackend
from repro_torch.models import numeric

WORKLOADS = ["jacobi-rodinia", "spkmeans-rodinia", "bfs-rodinia"]
FP32 = {"precision": "fp32", "microbatches": 1}
BF16 = {"precision": "bf16", "microbatches": 1}
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ACC_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _epochs(be, wl, sys_cfg, n=4):
    ts = be.init_trial(wl, {}, seed=0)
    accs = []
    for _ in range(n):
        ts, res = be.run_epoch(ts, sys_cfg)
        accs.append(res.accuracy)
    return ts, accs


@pytest.mark.parametrize("wl", WORKLOADS)
def test_fp32_epochs_match_the_reference(wl):
    cfg = numeric.CONFIGS[wl]
    jcfg = jnumeric.CONFIGS[wl]
    want = jnumeric.init_state(jcfg, 3)
    got = numeric.init_state(cfg, 3, "cpu")
    jfn = jax.jit(jnumeric._epoch_fn(jcfg, jnp.float32))
    tfn = numeric._epoch_fn(cfg, torch.float32)
    for _ in range(4):
        want, jaux = jfn(want)
        got, taux = tfn(got)
        if cfg.kind == "jacobi":
            np.testing.assert_allclose(got["x"].numpy(),
                                       np.asarray(want["x"]), **TOL)
        elif cfg.kind == "spkmeans":
            np.testing.assert_allclose(got["cents"].numpy(),
                                       np.asarray(want["cents"]), rtol=1e-5,
                                       atol=1e-5 * float(
                                           np.abs(want["cents"]).max()))
            np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
        else:
            np.testing.assert_array_equal(got["visited"].numpy(),
                                          np.asarray(want["visited"]))
            assert int(taux) == int(jaux)
        np.testing.assert_allclose(numeric.accuracy(cfg, got, taux),
                                   jnumeric.accuracy(jcfg, want, jaux), **TOL)


@pytest.mark.parametrize("wl", WORKLOADS)
def test_backend_accuracy_matches_the_reference(wl):
    _, want = _epochs(NumericBackend(), wl, FP32)
    ts, got = _epochs(TorchNumericBackend(device="cpu"), wl, FP32)
    np.testing.assert_allclose(got, want, **TOL)
    assert ts.epoch == 4 and ts.params is not None


@pytest.mark.parametrize("wl", WORKLOADS)
def test_bf16_accuracy_within_tolerance(wl):
    _, want = _epochs(NumericBackend(), wl, BF16)
    _, fp32 = _epochs(TorchNumericBackend(device="cpu"), wl, FP32)
    ts, got = _epochs(TorchNumericBackend(device="cpu"), wl, BF16)
    assert np.abs(np.subtract(got, want)).max() <= BF16_ACC_TOL
    assert np.abs(np.subtract(got, fp32)).max() <= BF16_ACC_TOL
    state = ts.params
    assert all(t.dtype != torch.bfloat16 for t in state.values()
               if isinstance(t, torch.Tensor))      # fp32 between epochs


def test_microbatches_repeat_the_epoch():
    be = TorchNumericBackend(device="cpu")
    ts2, res2 = be.run_epoch(be.init_trial("jacobi-rodinia", {}),
                             {"precision": "fp32", "microbatches": 2})
    ts1 = be.init_trial("jacobi-rodinia", {})
    for _ in range(2):
        ts1, res1 = be.run_epoch(ts1, FP32)
    assert len(res2.step_times) == 2 and len(res1.step_times) == 1
    assert ts2.epoch == 1 and ts1.epoch == 2
    assert torch.equal(ts2.params["x"], ts1.params["x"])
    assert res2.accuracy == res1.accuracy
    assert res2.sys_config == {"precision": "fp32", "microbatches": 2}


def test_first_run_strip_and_energy():
    """Three runs of an epoch: a first run slower than 3x the median of the
    rest is booked at that median, as in the reference; the energy is the
    port's power model at utilization 0.6 over the booked times."""
    from repro_torch.core import energy
    be = TorchNumericBackend(device="cpu")
    fn = be._epoch_fn(numeric.CONFIGS["bfs-rodinia"], FP32)
    slow = iter([True, False, False])

    def epoch(state):
        if next(slow):
            import time
            time.sleep(0.2)
        return fn(state)
    be._cache[("bfs-rodinia", str(torch.float32))] = epoch
    _, res = be.run_epoch(be.init_trial("bfs-rodinia", {}),
                          {"precision": "fp32", "microbatches": 3})
    assert res.step_times[0] == pytest.approx(np.median(res.step_times[1:]))
    assert res.energy_j == pytest.approx(
        energy.power_w(0.6, 1) * sum(res.step_times))
    assert res.compile_s == 0.0


# the reference's tests/test_numeric.py on the port's backend
@pytest.mark.parametrize("wl", WORKLOADS)
def test_numeric_workloads_converge(wl):
    _, accs = _epochs(TorchNumericBackend(device="cpu"), wl, FP32)
    assert accs[-1] >= accs[0] - 1e-6       # monotone-ish progress
    assert accs[-1] > 0.3                   # genuinely converging


def test_pipetune_runs_on_numeric_backend():
    sspace = SystemSpace(remat=("none",), microbatches=(1, 2),
                         precision=("fp32",))
    pt = PipeTune(TorchNumericBackend(device="cpu"), sspace,
                  groundtruth=GroundTruth(), max_probes=2)
    rec = pt.run_trial("jacobi-rodinia", "t0", {}, 5)
    assert len(rec.epochs) == 5
    assert rec.epochs[-1].accuracy > 0.3
    assert rec.probe_epochs == 2            # probing happened on short epochs


def test_numeric_profiles_differ_from_classifiers():
    be = TorchNumericBackend(device="cpu")
    ts = be.init_trial("jacobi-rodinia", {}, seed=0)
    _, res = be.run_epoch(ts, {"precision": "fp32"})
    v = res.profile.vector()
    assert v.shape == (58,)
    assert np.isfinite(v).all()


def test_registry_numeric_backend_and_device_rule(monkeypatch):
    be = registry.make_backend("numeric", device="cpu")
    assert isinstance(be, TorchNumericBackend)
    assert not be.capabilities().async_precompile
    space = registry.default_sys_space("numeric", device="cpu")
    assert space.configs() == [
        {"remat": "none", "microbatches": m, "precision": "fp32"}
        for m in (1, 2)]
    # no GPU and no device="cpu": the backend raises, it does not fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.make_backend("numeric")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchNumericBackend()


def test_tuning_launcher_runs_numeric_on_the_cpu(capsys):
    from repro_torch.launch import tune as tune_launch
    res = tune_launch.main(["--backend", "numeric", "--workload",
                            "jacobi-rodinia", "--scheduler", "random",
                            "--epochs", "2", "--device", "cpu"])
    assert len(res.records) == 6 and res.best_accuracy > 0.3
    assert res.gt_hits + res.gt_misses == len(res.records)
    assert "workload=jacobi-rodinia system=pipetune" in capsys.readouterr().out
