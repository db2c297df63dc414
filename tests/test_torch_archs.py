"""The dense and moe archs of the port against the JAX reference on the CPU:
qwen2-1.5b, yi-34b, deepseek-coder-33b (dense), mixtral-8x22b and
qwen2-moe-a2.7b (moe), at their reduced configs.

Weights are drawn by the reference's ``init`` and carried over with
``weights.from_jax``; tokens and labels come from numpy. Both packages run at
``precision="fp32"`` with ``q_chunk=kv_chunk=16``; with ``use_pallas`` the
JAX side runs the Pallas forward in interpret mode and the port the plain
versions of B1 (and B2/B3 for gradients). Tolerances: logits, loss, aux and
gradients 1e-4 (tests/test_kernels.py's gradient tests). Decode is held
against the reference's decode at 1e-4 and, as tests/test_models.py holds
the reference, against the parallel forward (0.15, and 0.2 after a
prefill). mixtral's reduced window is 8, so the 12-token prompts pass it and
the ring cache rolls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt

ARCHS = ["qwen2-1.5b", "yi-34b", "deepseek-coder-33b", "mixtral-8x22b",
         "qwen2-moe-a2.7b"]
MOE = ["mixtral-8x22b", "qwen2-moe-a2.7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _setup(arch, **change):
    """(jcfg, tcfg, reference params as numpy, port params)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **change)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), **change)
    if arch not in _PARAMS:
        params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                    jcfg)
        _PARAMS[arch] = jax.tree.map(np.asarray, params)
    params_np = _PARAMS[arch]
    return jcfg, tcfg, params_np, weights.from_jax(params_np, tcfg, "cpu")


def _systems(**kw):
    kw = dict(precision="fp32", q_chunk=16, kv_chunk=16, **kw)
    return JT.SystemConfig(**kw), TT.SystemConfig(**kw)


def _tokens(vocab, shape, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else a, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_the_reference(arch):
    for get in ("get_config", "get_reduced"):
        j = dataclasses.asdict(getattr(jconfigs, get)(arch))
        t = dataclasses.asdict(getattr(tconfigs, get)(arch))
        assert j.pop("dtype") == np.float32 and t.pop("dtype") == torch.float32
        assert j == t
    assert tconfigs.get(f"{arch}-reduced").name == f"{arch}-reduced"


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_shapes_match_reference(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    jcfg = getattr(jconfigs, get)(arch)
    abstract = jax.eval_shape(lambda k: JT.init(k, jcfg),
                              jax.random.PRNGKey(0))
    ref = {p: tuple(a.shape) for p, a in weights.flatten(abstract).items()}
    assert weights.leaf_shapes(getattr(tconfigs, get)(arch)) == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_dtypes(arch):
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                               dtype=torch.bfloat16)
    own = weights.flatten(TT.init(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    assert {p: tuple(a.shape) for p, a in own.items()} == \
        weights.leaf_shapes(tcfg)
    for path, leaf in own.items():
        want = torch.float32 if path.endswith("moe/router") else torch.bfloat16
        assert leaf.dtype == want, path
    _, _, params_np, _ = _setup(arch)
    carried = weights.flatten(weights.from_jax(params_np, tcfg, "cpu"))
    assert {p: a.dtype for p, a in carried.items()} == \
        {p: a.dtype for p, a in own.items()}


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, use_pallas):
    jcfg, tcfg, params_np, tparams = _setup(arch)
    jsys, tsys = _systems(use_pallas=use_pallas)
    toks = _tokens(jcfg.vocab, (B, S))
    jl, ja = jax.jit(JT.forward, static_argnums=(2, 3))(
        params_np, {"tokens": jnp.asarray(toks)}, jcfg, jsys)
    before = fa.launches
    tl, ta = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                        tcfg, tsys)
    assert fa.launches == before              # CPU: the plain version
    assert tuple(tl.shape) == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-6)
    assert (float(ta) > 0) == (arch in MOE)


def _grads(tparams, batch, cfg, sys):
    flat = {p: a.detach().requires_grad_()
            for p, a in weights.flatten(tparams).items()}
    loss, metrics = TT.loss_fn(weights.unflatten(flat), batch, cfg, sys)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, use_pallas):
    jcfg, tcfg, params_np, tparams = _setup(arch)
    jsys, tsys = _systems(use_pallas=use_pallas)
    tokens = _tokens(jcfg.vocab, (B, S), seed=3)
    labels = _tokens(jcfg.vocab, (B, S), seed=4)
    labels[:, -2:] = -1
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(JT.loss_fn, has_aux=True), static_argnums=(2, 3))(
        params_np, {"tokens": jnp.asarray(tokens),
                    "labels": jnp.asarray(labels)}, jcfg, jsys)
    tl, tm, tg = _grads(tparams, {"tokens": torch.from_numpy(tokens).long(),
                                  "labels": torch.from_numpy(labels).long()},
                        tcfg, tsys)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for name in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **TOL)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-6, atol=1e-6)
    j_flat = weights.flatten(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(j_flat)
    for path, g in tg.items():
        np.testing.assert_allclose(_np(g), j_flat[path], err_msg=path, **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_reference(arch):
    """Two steps of 2 microbatches (the reference with mesh=None) under
    SGD with momentum. Not adamw: its update divides by sqrt(v) + 1e-8, so a
    gradient element near 1e-8 that the two packages sum in another order
    (the MoE combine) moves its parameter by a different share of the
    learning rate, though the gradients agree at 1e-4."""
    jcfg, tcfg, params_np, tparams = _setup(arch)
    jsys, tsys = _systems(microbatches=2)
    jo, to = jopt.sgd(0.1, momentum=0.9), topt.sgd(0.1, momentum=0.9)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsys, jo, mesh=None))
    tstep = tsteps.make_train_step(tcfg, tsys, to)
    jstate = {"params": jax.tree.map(jnp.asarray, params_np),
              "opt": jo.init(params_np), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tparams, "opt": to.init(tparams), "step": 0}
    for i in range(2):
        tokens = _tokens(jcfg.vocab, (4, S), seed=10 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens).long(),
                                    "labels": torch.from_numpy(tokens).long()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    j_flat = weights.flatten(jax.tree.map(np.asarray, jstate["params"]))
    for path, t in weights.flatten(tstate["params"]).items():
        np.testing.assert_allclose(_np(t), j_flat[path], err_msg=path, **TOL)


def _moe_decode_cfg(arch):
    # as tests/test_models.py: no capacity drops in the parallel path
    return {"capacity_factor": 8.0} if arch in MOE else {}


def _decode_all(jcfg, tcfg, params_np, tparams, toks, jcache, tcache,
                jsys, tsys):
    """Decode ``toks`` one by one from position 0 in both packages: the
    per-step logits (B, V) of each, and the final caches."""
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    tdecode = tsteps.make_decode_step(tcfg, tsys)
    jls, tls = [], []
    for t in range(toks.shape[1]):
        jl, jcache = jdecode(params_np, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        tl, tcache = tdecode(tparams, tcache,
                             torch.from_numpy(toks[:, t:t + 1]).long(), t)
        jls.append(_np(jl)[:, 0])
        tls.append(_np(tl)[:, 0])
    return np.stack(jls, 1), np.stack(tls, 1), jcache, tcache


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_forward(arch, cache):
    """Decode from position 0 at fp32 compute. With an fp32 cache the two
    packages agree at 1e-4 and decode tracks the forward (0.15, the bound
    of tests/test_models.py). A bf16 cache rounds k/v in both, where an fp32
    last-place difference can round one value to the neighbouring bf16: the
    logits are held at bf16's 2e-2, and the port's drift from its forward
    must be the reference's drift from its own."""
    jcfg, tcfg, params_np, tparams = _setup(arch, **_moe_decode_cfg(arch))
    jsys, tsys = _systems()
    toks = _tokens(jcfg.vocab, (B, S))
    jfull, _ = JT.forward(params_np, {"tokens": jnp.asarray(toks)}, jcfg,
                          jsys)
    tfull, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, tsys)
    jl, tl, _, _ = _decode_all(
        jcfg, tcfg, params_np, tparams, toks,
        JT.init_cache(jcfg, B, S, dtype=getattr(jnp, cache)),
        TT.init_cache(tcfg, B, S, dtype=getattr(torch, cache), device="cpu"),
        jsys, tsys)
    t_drift = float(np.abs(tl - _np(tfull)).max())
    j_drift = float(np.abs(jl - _np(jfull)).max())
    if cache == "float32":
        np.testing.assert_allclose(tl, jl, **TOL)
        assert t_drift < 0.15, f"decode drift {t_drift}"
    else:
        np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
        assert abs(t_drift - j_drift) < 2e-2, (t_drift, j_drift)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill 12 tokens, decode 4 more (mixtral: the ring of 8 slots is
    rolled by the prefill and wraps in decode)."""
    jcfg, tcfg, params_np, tparams = _setup(arch, **_moe_decode_cfg(arch))
    jsys, tsys = _systems()
    EXTRA = 4
    toks = _tokens(jcfg.vocab, (1, S + EXTRA), seed=5)
    jl, jcache = jax.jit(jsteps.make_prefill_step(jcfg, jsys,
                                                  max_len=S + EXTRA))(
        params_np, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tcache = tsteps.make_prefill_step(tcfg, tsys, max_len=S + EXTRA)(
        tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=2 ** -7, atol=1e-6)
    full, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                         tcfg, tsys)
    assert float((tl[:, 0] - full[:, S - 1]).abs().max()) < 0.15
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    tdecode = tsteps.make_decode_step(tcfg, tsys)
    for t in range(S, S + EXTRA):
        jl, jcache = jdecode(params_np, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        tl, tcache = tdecode(tparams, tcache,
                             torch.from_numpy(toks[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert float((tl[:, 0] - full[:, t]).abs().max()) < 0.2


@pytest.mark.parametrize("arch", ["yi-34b", "mixtral-8x22b",
                                  "qwen2-moe-a2.7b"])
def test_int8_kv_cache_decode_matches_reference(arch):
    """int8 cache decode. At fp32 compute the port matches the reference's
    int8 decode step by step at 1e-4, with the same int8 values and bf16
    scales in the cache. At bf16 compute, for yi-34b, the reference's
    test_int8_kv_cache_decode_close on the port: decode tracks the parallel
    forward (max 0.5, argmax agreeing at all but one step). Not for the moe
    archs at bf16: there a router near-tie flips with bf16 rounding (on
    these inputs mixtral's second and third expert of token (1, 10) differ
    by 2.9e-5 in probability at layer 0), which moves that token's logits
    by about 0.5 whichever package runs it."""
    jcfg, tcfg, params_np, tparams = _setup(arch, **_moe_decode_cfg(arch))
    jsys, tsys = _systems()
    toks = _tokens(jcfg.vocab, (B, S))
    tcache = TT.init_cache(tcfg, B, S, quant=True, device="cpu")
    assert {k: str(v.dtype) for k, v in tcache.items()} == {
        "k": "torch.int8", "v": "torch.int8", "k_scale": "torch.bfloat16",
        "v_scale": "torch.bfloat16"}
    jl, tl, jcache, tcache = _decode_all(
        jcfg, tcfg, params_np, tparams, toks,
        JT.init_cache(jcfg, B, S, quant=True), tcache, jsys, tsys)
    np.testing.assert_allclose(tl, jl, **TOL)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(tcache[name]), _np(jcache[name]),
                                      err_msg=name)

    if arch != "yi-34b":
        return
    bf16 = TT.SystemConfig()
    full, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                         tcfg, bf16)
    cache = TT.init_cache(tcfg, B, S, quant=True, device="cpu")
    decode = tsteps.make_decode_step(tcfg, bf16)
    agree, errs = 0, []
    for t in range(S):
        lg, cache = decode(tparams, cache,
                           torch.from_numpy(toks[:, t:t + 1]).long(), t)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
        agree += int(bool((lg[:, 0].argmax(-1)
                           == full[:, t].argmax(-1)).all()))
    assert max(errs) < 0.5
    assert agree >= S - 1


@pytest.mark.parametrize("arch", MOE)
def test_serve_and_train_launchers_take_moe_on_cpu(arch):
    res = serve.main(["--arch", f"{arch}-reduced", "--requests", "2",
                      "--prompt-len", "12", "--gen", "3", "--device", "cpu"])
    assert res.cfg.family == "moe" and tuple(res.tokens.shape) == (2, 3)
    assert bool(torch.isfinite(res.prefill_logits).all())
    tres = train.main(["--arch", f"{arch}-reduced", "--steps", "2", "--batch",
                       "2", "--seq", "8", "--device", "cpu"])
    assert all(np.isfinite(loss) for loss in tres.losses)
