"""The port's LM tuning example (``examples/torch_tune_llm_sysparams.py``)
against the reference's (``examples/tune_llm_sysparams.py``), on the CPU.

Both ``LMBackend``s start a trial from the reference's initial train state
(the port's carried over by ``weights.state_from_jax``) and train one epoch
of the same token batches at fp32; the per-step losses agree to 1e-4 (rtol
and atol, tests/test_kernels.py's gradient tolerance) under remat none and
block. On the CPU the port's attention wrappers run the plain versions of
B1, B2 and B3 and launch nothing.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import weights
from repro_torch.api import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fa_bwd
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
HPARAMS = {"learning_rate": 2e-3}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return _example("tune_llm_sysparams"), _example("torch_tune_llm_sysparams")


def _logged(step, log):
    def logged(state, batch):
        state, m = step(state, batch)
        log.append(float(m["loss"]))
        return state, m
    return logged


@pytest.mark.parametrize("remat", ["none", "block"])
def test_lm_backend_epoch_matches_reference(examples, remat):
    jex, tex = examples
    sys_cfg = {"remat": remat, "microbatches": 1, "precision": "fp32"}
    key = ("step", str(sys_cfg), HPARAMS["learning_rate"])

    jbe = jex.LMBackend()
    jts = jbe.init_trial("tune-lm", HPARAMS, seed=0)
    jstate, jopt = jts.params
    jlog = []
    jsys = JT.SystemConfig(remat=remat, precision="fp32")
    jbe._cache[key] = _logged(jax.jit(jsteps.make_train_step(
        jts.cfg, jsys, jopt)), jlog)

    tbe = tex.LMBackend(device="cpu")
    tts = tbe.init_trial("tune-lm", HPARAMS, seed=0)
    _, topt = tts.params
    state = weights.state_from_jax(jax.tree.map(np.asarray, jstate),
                                   tts.cfg, "cpu")
    tts.params = (state, topt)
    tlog = []
    tsys = TT.SystemConfig(remat=remat, precision="fp32")
    tbe._cache[key] = _logged(tsteps.make_train_step(tts.cfg, tsys, topt),
                              tlog)
    np.testing.assert_array_equal(tts.data, jts.data)     # the same tokens

    launched = (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv)
    jts, jres = jbe.run_epoch(jts, sys_cfg)
    tts, tres = tbe.run_epoch(tts, sys_cfg)
    assert len(tlog) == len(jlog) == tbe.steps_per_epoch == 6
    np.testing.assert_allclose(tlog, jlog, **TOL)
    assert tres.loss == tlog[-1] and tres.accuracy == -tlog[-1]
    assert tres.sys_config == sys_cfg and len(tres.step_times) == 6
    assert tts.step == jts.step == 6 and tts.epoch == 1
    assert (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv) == launched


def test_lm_backend_registration_energy_and_device_rule(examples,
                                                        monkeypatch):
    from repro_torch.core import energy
    _, tex = examples
    space = registry.default_sys_space("lm", device="cpu")
    assert len(space.configs()) == 6
    assert {c["precision"] for c in space.configs()} == {"fp32"}
    be = registry.make_backend("lm", device="cpu", steps_per_epoch=2)
    assert isinstance(be, tex.LMBackend)
    ts = be.init_trial("tune-lm", HPARAMS, seed=1)
    ts, res = be.run_epoch(ts, {"remat": "none", "microbatches": 2,
                                "precision": "fp32"})
    assert np.isfinite(res.loss) and len(res.step_times) == 2
    assert res.energy_j == pytest.approx(
        energy.power_w(tex.UTIL, 1) * res.duration_s)
    # the cache is keyed on the sys config and the learning rate
    be.run_epoch(be.init_trial("tune-lm", {"learning_rate": 1e-3}),
                 {"remat": "none", "microbatches": 2, "precision": "fp32"})
    assert len(be._cache) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.LMBackend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.main([])
