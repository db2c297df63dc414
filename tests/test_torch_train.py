"""The port's training path against the JAX reference, reduced qwen3-0.6b on
the CPU.

Weights come from the reference's ``init`` and are carried over with
``weights.from_jax`` (a whole train state with ``weights.state_from_jax``);
tokens and labels come from numpy. Both packages run at
``precision="fp32"`` with ``q_chunk=kv_chunk=16``; with ``use_pallas`` the
JAX side runs the Pallas forward in interpret mode and the port the plain
versions of B1, B2 and B3. Tolerance 1e-4 (tests/test_kernels.py's gradient
tests), as for the serve path.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fa_bwd
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch import tree
from repro_torch.optim import optimizers as topt

B, S = 4, 20
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_np():
    cfg = jconfigs.get_reduced("qwen3-0.6b")
    params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(np.asarray, params)


def _batch(vocab, seed=1, ignore=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, S - ignore:] = -1
    return tokens, labels


def _jbatch(tokens, labels):
    return {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}


def _tbatch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens).long(),
            "labels": torch.from_numpy(labels).long()}


def _cfgs(window=None):
    return (dataclasses.replace(jconfigs.get_reduced("qwen3-0.6b"),
                                window=window),
            dataclasses.replace(tconfigs.get_reduced("qwen3-0.6b"),
                                window=window))


def _systems(**kw):
    kw = dict(precision="fp32", q_chunk=16, kv_chunk=16, **kw)
    return JT.SystemConfig(**kw), TT.SystemConfig(**kw)


def _grads(tparams, batch, cfg, sys):
    flat = {p: a.detach().requires_grad_()
            for p, a in weights.flatten(tparams).items()}
    loss, metrics = TT.loss_fn(weights.unflatten(flat), batch, cfg, sys)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


def _assert_tree_close(t_flat, j_tree, **tol):
    j_flat = weights.flatten(jax.tree.map(np.asarray, j_tree))
    assert set(t_flat) == set(j_flat)
    for path, t in t_flat.items():
        np.testing.assert_allclose(t.detach().float().numpy(), j_flat[path],
                                   err_msg=path, **(tol or TOL))


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_loss_and_grads_match_reference(params_np, use_pallas, window):
    jcfg, tcfg = _cfgs(window)
    jsys, tsys = _systems(use_pallas=use_pallas)
    tokens, labels = _batch(jcfg.vocab, ignore=3)
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(JT.loss_fn, has_aux=True), static_argnums=(2, 3))(
        params_np, _jbatch(tokens, labels), jcfg, jsys)
    tl, tm, tg = _grads(weights.from_jax(params_np, tcfg, "cpu"),
                        _tbatch(tokens, labels), tcfg, tsys)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for name in ("loss", "accuracy", "tokens", "aux_loss"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **TOL)
    _assert_tree_close(tg, jg)


def test_remat_modes_give_the_same_gradients(params_np):
    _, tcfg = _cfgs()
    tparams = weights.from_jax(params_np, tcfg, "cpu")
    batch = _tbatch(*_batch(tcfg.vocab))
    results = {remat: _grads(tparams, batch, tcfg,
                             _systems(remat=remat)[1])
               for remat in ("none", "block", "dots")}
    loss0, _, g0 = results["none"]
    for remat in ("block", "dots"):
        loss, _, g = results[remat]
        assert float(loss.detach()) == pytest.approx(float(loss0.detach()),
                                                     rel=1e-6)
        for path in g0:
            torch.testing.assert_close(g[path], g0[path], rtol=1e-6,
                                       atol=1e-6, msg=path)


def _optimizer(o):
    return o.adamw(o.warmup_cosine(1e-2, 2, 10), weight_decay=0.01)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(params_np, microbatches):
    jcfg, tcfg = _cfgs()
    jsys, tsys = _systems(microbatches=microbatches)
    jo, to = _optimizer(jopt), _optimizer(topt)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsys, jo, mesh=None))
    tstep = tsteps.make_train_step(tcfg, tsys, to)
    jstate = {"params": jax.tree.map(jnp.asarray, params_np),
              "opt": jo.init(params_np), "step": jnp.zeros((), jnp.int32)}
    tparams = weights.from_jax(params_np, tcfg, "cpu")
    tstate = {"params": tparams, "opt": to.init(tparams), "step": 0}
    for i in range(3):
        tokens, labels = _batch(jcfg.vocab, seed=10 + i)
        jstate, jm = jstep(jstate, _jbatch(tokens, labels))
        tstate, tm = tstep(tstate, _tbatch(tokens, labels))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), **TOL)
    assert tstate["params"] is tparams and tstate["step"] == 3
    _assert_tree_close(weights.flatten(tstate["params"]), jstate["params"])


def test_state_from_jax_continues_a_reference_run(params_np):
    jcfg, tcfg = _cfgs()
    jsys, tsys = _systems()
    jo, to = _optimizer(jopt), _optimizer(topt)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsys, jo, mesh=None))
    jstate = {"params": jax.tree.map(jnp.asarray, params_np),
              "opt": jo.init(params_np), "step": jnp.zeros((), jnp.int32)}
    for i in range(2):
        jstate, _ = jstep(jstate, _jbatch(*_batch(jcfg.vocab, seed=20 + i)))
    tstate = weights.state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                    "cpu")
    assert tstate["step"] == 2
    assert all(t.dtype == torch.float32 for t in
               tree.tree_leaves(tstate["opt"]))
    _assert_tree_close(weights.flatten(tstate["opt"]["m"]), jstate["opt"]["m"],
                       rtol=0, atol=0)
    batch = _batch(jcfg.vocab, seed=22)
    jstate, jm = jstep(jstate, _jbatch(*batch))
    tstate, tm = tsteps.make_train_step(tcfg, tsys, to)(tstate,
                                                        _tbatch(*batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    _assert_tree_close(weights.flatten(tstate["params"]), jstate["params"])
    _assert_tree_close(weights.flatten(tstate["opt"]["v"]),
                       jstate["opt"]["v"])


def test_make_lm_dataset_equals_reference():
    for seed, n, vocab in [(0, 4096, 256), (3, 1000, 151936)]:
        np.testing.assert_array_equal(
            tsynthetic.make_lm_dataset(seed, n, vocab),
            jsynthetic.make_lm_dataset(seed, n, vocab))


def test_train_main_on_cpu():
    before = (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv)
    res = train.main(["--arch", "qwen3-0.6b-reduced", "--steps", "3",
                      "--batch", "4", "--seq", "16", "--microbatches", "2",
                      "--remat", "block", "--device", "cpu"])
    assert (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv) == \
        before == (0, 0, 0)                  # CPU: the plain versions
    assert len(res.losses) == len(res.step_ms) == 3
    assert all(np.isfinite(res.losses)) and res.device_name == "cpu"
    assert res.peak_memory_bytes is None and res.tokens_per_step == 64
    assert res.sys.precision == "fp32" and res.sys.remat == "block"
    assert res.cfg.name == "qwen3-0.6b-reduced"


def test_train_main_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-0.6b-reduced", "--steps", "1"])
