"""The hybrid (Griffin) family of the port against the JAX reference on the
CPU: ``models/recurrent.py`` part by part, then reduced recurrentgemma-9b
(1 group of 2 recurrent blocks and a window-8 attention block, plus 1 tail
block) whole.

Parameters are drawn by the reference's ``init``/``init_recurrent`` and
carried over with ``weights.from_jax``; inputs, tokens and labels come from
numpy. The recurrent parts are held at fp32 1e-5 (the port's scan is the
reference's combine in another tree, ``kernels.rglru.rglru_reference``, and
it takes exp in float64 on the CPU). The model runs at ``precision="fp32"``
with ``q_chunk=kv_chunk=16``, with ``use_pallas`` on (JAX: the Pallas
kernels in interpret mode; port: the plain versions of B1, and of B2/B3 for
gradients) and off; logits, loss, gradients, train steps, prefill and
decode at 1e-4 (tests/test_kernels.py's gradient tests). S = 12 passes the
window of 8, so the window mask and the ring cache act. Decode runs token
by token from ``init_cache`` with fp32, bf16 and int8 caches, as the
reference decodes a hybrid (tests/test_models.py): its prefill returns only
the attention caches, so ``serve`` refuses a hybrid.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import recurrent as jrec
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-4, atol=1e-4)
REC_TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# models/recurrent.py
# ---------------------------------------------------------------------------

D_MODEL, D_RNN = 16, 24


def _rec_params(seed=0):
    cfg = jrec.RecurrentConfig(d_model=D_MODEL, d_rnn=D_RNN)
    p = jax.tree.map(np.asarray, jrec.init_recurrent(jax.random.PRNGKey(seed),
                                                     cfg))
    return p, {k: _t(v) for k, v in p.items()}


def _rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_recurrent_config_and_init_layout():
    jp, _ = _rec_params()
    tcfg = trec.RecurrentConfig(d_model=D_MODEL, d_rnn=D_RNN)
    tp = trec.init_recurrent(torch.Generator().manual_seed(0), tcfg,
                             torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    for k, v in tp.items():
        assert v.dtype == (torch.float32 if k == "Lambda"
                           else torch.bfloat16), k
    assert bool(((tp["Lambda"] >= 2.0) & (tp["Lambda"] <= 6.0)).all())
    state = trec.init_recurrent_state(tcfg, 3, torch.bfloat16)
    ref = jrec.init_recurrent_state(jrec.RecurrentConfig(D_MODEL, D_RNN), 3)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in state.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in ref.items()}


def test_gates_match_reference():
    jp, tp = _rec_params()
    x = _rng_array((2, 7, D_RNN), 1)
    jl, jb = jrec._gates(jp, jnp.asarray(x))
    tl, tb = trec._gates(tp, _t(x))
    assert tl.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **REC_TOL)
    np.testing.assert_allclose(_np(tb), _np(jb), **REC_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(with_h0):
    jp, tp = _rec_params()
    x = _rng_array((2, 19, D_RNN), 2)
    h0 = _rng_array((2, D_RNN), 3) if with_h0 else None
    jh, jlast = jrec.rglru_scan(jp, jnp.asarray(x),
                                None if h0 is None else jnp.asarray(h0))
    th, tlast = trec.rglru_scan(tp, _t(x), None if h0 is None else _t(h0))
    assert th.dtype == torch.float32 and tlast.dtype == torch.float32
    np.testing.assert_allclose(_np(th), _np(jh), **REC_TOL)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **REC_TOL)


def test_rglru_step_matches_reference():
    jp, tp = _rec_params()
    x = _rng_array((3, D_RNN), 4)
    h = _rng_array((3, D_RNN), 5)
    jy, jh = jrec.rglru_step(jp, jnp.asarray(x), jnp.asarray(h))
    ty, th = trec.rglru_step(tp, _t(x), _t(h))
    np.testing.assert_allclose(_np(ty), _np(jy), **REC_TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **REC_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    jp, tp = _rec_params()
    x = _rng_array((2, 9, D_RNN), 6)
    st = (_rng_array((2, trec.CONV_WIDTH - 1, D_RNN), 7) if with_state
          else None)
    jo, js = jrec._causal_conv(jp, jnp.asarray(x),
                               None if st is None else jnp.asarray(st))
    to, ts = trec._causal_conv(tp, _t(x), None if st is None else _t(st))
    assert ts.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **REC_TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **REC_TOL)


def test_apply_recurrent_and_decode_match_reference():
    jp, tp = _rec_params()
    jcfg = jrec.RecurrentConfig(D_MODEL, D_RNN)
    tcfg = trec.RecurrentConfig(D_MODEL, D_RNN)
    x = _rng_array((2, 11, D_MODEL), 8)
    np.testing.assert_allclose(
        _np(trec.apply_recurrent(tp, _t(x), tcfg)),
        _np(jrec.apply_recurrent(jp, jnp.asarray(x), jcfg)), **REC_TOL)
    state = {"h": _rng_array((2, D_RNN), 9),
             "conv": _rng_array((2, trec.CONV_WIDTH - 1, D_RNN), 10)}
    jo, jst = jrec.apply_recurrent_decode(
        jp, jnp.asarray(x[:, :1]), jcfg,
        {k: jnp.asarray(v) for k, v in state.items()})
    to, tst = trec.apply_recurrent_decode(
        tp, _t(x[:, :1]), tcfg, {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(_np(to), _np(jo), **REC_TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k,
                                   **REC_TOL)


# ---------------------------------------------------------------------------
# reduced recurrentgemma-9b
# ---------------------------------------------------------------------------

_PARAMS = {}


def _setup():
    """(jcfg, tcfg, reference params as numpy, port params)."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    if ARCH not in _PARAMS:
        params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(1),
                                                    jcfg)
        _PARAMS[ARCH] = jax.tree.map(np.asarray, params)
    params_np = _PARAMS[ARCH]
    return jcfg, tcfg, params_np, weights.from_jax(params_np, tcfg, "cpu")


def _systems(**kw):
    kw = dict(precision="fp32", q_chunk=16, kv_chunk=16, **kw)
    return JT.SystemConfig(**kw), TT.SystemConfig(**kw)


def _tokens(vocab, shape, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_configs_are_copies_and_resolve():
    for get in ("get_config", "get_reduced"):
        j = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        t = dataclasses.asdict(getattr(tconfigs, get)(ARCH))
        assert j.pop("dtype") == np.float32 and t.pop("dtype") == torch.float32
        assert j == t
    cfg = tconfigs.get(ARCH)
    assert (cfg.family, cfg.hybrid_groups, cfg.hybrid_tail,
            cfg.resolved_head_dim, cfg.window) == ("hybrid", 12, 2, 256, 2048)
    red = tconfigs.get(f"{ARCH}-reduced")
    assert (red.hybrid_groups, red.hybrid_tail, red.window) == (1, 1, 8)


@pytest.mark.parametrize("reduced", [False, True])
def test_leaf_shapes_match_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    jcfg = getattr(jconfigs, get)(ARCH)
    abstract = jax.eval_shape(lambda k: JT.init(k, jcfg),
                              jax.random.PRNGKey(0))
    ref = {p: tuple(a.shape) for p, a in weights.flatten(abstract).items()}
    assert weights.leaf_shapes(getattr(tconfigs, get)(ARCH)) == ref


def test_init_layout_and_dtypes():
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH),
                               dtype=torch.bfloat16)
    own = weights.flatten(TT.init(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    assert {p: tuple(a.shape) for p, a in own.items()} == \
        weights.leaf_shapes(tcfg)
    for path, leaf in own.items():
        want = torch.float32 if path.endswith("Lambda") else torch.bfloat16
        assert leaf.dtype == want, path
    _, _, params_np, _ = _setup()
    carried = weights.flatten(weights.from_jax(params_np, tcfg, "cpu"))
    assert {p: a.dtype for p, a in carried.items()} == \
        {p: a.dtype for p, a in own.items()}


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_matches_reference(use_pallas):
    jcfg, tcfg, params_np, tparams = _setup()
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
    assert float(ta) == float(ja) == 0.0


def _grads(tparams, batch, cfg, sys):
    flat = {p: a.detach().requires_grad_()
            for p, a in weights.flatten(tparams).items()}
    loss, metrics = TT.loss_fn(weights.unflatten(flat), batch, cfg, sys)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_loss_and_grads_match_reference(use_pallas, remat):
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(use_pallas=use_pallas, remat=remat)
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
    j_flat = weights.flatten(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(j_flat)
    for path, g in tg.items():
        np.testing.assert_allclose(_np(g), j_flat[path], err_msg=path, **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, use_pallas):
    """Two steps under SGD with momentum (the reference with mesh=None);
    adamw would divide gradient elements near 1e-8 by sqrt(v), where an fp32
    difference in the last place moves a parameter by a share of the
    learning rate (tests/test_torch_archs.py)."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(microbatches=microbatches, use_pallas=use_pallas)
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


@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_matches_reference(use_pallas):
    """Last-token logits and the attention caches (stacked over groups, ring
    layout: S = 12 passes the window of 8, so the ring is rolled). The
    caches hold bf16 in both packages: one bf16 step apart at most."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(use_pallas=use_pallas)
    toks = _tokens(jcfg.vocab, (B, S), seed=5)
    jl, jcache = jax.jit(jsteps.make_prefill_step(jcfg, jsys))(
        params_np, {"tokens": jnp.asarray(toks)})
    tl, tcache = tsteps.make_prefill_step(tcfg, tsys)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tcache) == set(jcache) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape == \
            (tcfg.hybrid_groups, B, tcfg.window, 1, tcfg.resolved_head_dim)
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   rtol=2 ** -7, atol=1e-6)


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


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_from_init_cache_matches_reference(cache):
    """Token by token from ``init_cache`` at fp32 compute. fp32 cache:
    logits and every cache leaf at 1e-4, and decode tracks the parallel
    forward (0.15, tests/test_models.py's bound). bf16 cache: the attention
    k/v and the conv states round to bf16 in both, where an fp32 difference
    in the last place can round one value to the neighbouring bf16: logits
    at 2e-2, and the port's drift from its forward within 2e-2 of the
    reference's drift from its own. int8 cache (bf16 conv states): logits
    at 1e-4 and the same int8 values and scales."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    toks = _tokens(jcfg.vocab, (B, S))
    quant = cache == "int8"
    dt = "bfloat16" if quant else cache
    tc = TT.init_cache(tcfg, B, S, dtype=getattr(torch, dt), quant=quant,
                       device="cpu")
    jc = JT.init_cache(jcfg, B, S, dtype=getattr(jnp, dt), quant=quant)
    assert set(tc) == set(jc) == {"recs", "attn", "tail"}
    for part in tc:
        assert {k: tuple(v.shape) for k, v in tc[part].items()} == \
            {k: v.shape for k, v in jc[part].items()}, part
    jl, tl, jcache, tcache = _decode_all(jcfg, tcfg, params_np, tparams,
                                         toks, jc, tc, jsys, tsys)
    jfull, _ = JT.forward(params_np, {"tokens": jnp.asarray(toks)}, jcfg,
                          jsys)
    tfull, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, tsys)
    t_drift = float(np.abs(tl - _np(tfull)).max())
    j_drift = float(np.abs(jl - _np(jfull)).max())
    if cache == "bfloat16":
        np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
        assert abs(t_drift - j_drift) < 2e-2, (t_drift, j_drift)
        return
    np.testing.assert_allclose(tl, jl, **TOL)
    for part in tcache:
        for name, leaf in tcache[part].items():
            ref = _np(jcache[part][name])
            if quant and part == "attn":
                np.testing.assert_array_equal(_np(leaf), ref,
                                              err_msg=f"{part}/{name}")
            elif quant and name == "conv":        # bf16 states
                np.testing.assert_allclose(_np(leaf), ref, rtol=2 ** -7,
                                           atol=1e-6, err_msg=part)
            else:
                np.testing.assert_allclose(_np(leaf), ref,
                                           err_msg=f"{part}/{name}", **TOL)
    if cache == "float32":
        assert t_drift < 0.15, f"decode drift {t_drift}"


def test_serve_refuses_a_hybrid():
    with pytest.raises(NotImplementedError, match="recurrent states"):
        serve.main(["--arch", f"{ARCH}-reduced", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2", "--device", "cpu"])
    _, tcfg, _, tparams = _setup()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve.serve(tparams, torch.zeros((1, 4), dtype=torch.long), tcfg,
                    TT.SystemConfig(), 2)


def test_train_launcher_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", f"{ARCH}-reduced", "--steps", "1"])


def test_train_launcher_trains_a_hybrid_on_cpu():
    before = fa.launches
    res = train.main(["--arch", f"{ARCH}-reduced", "--steps", "3", "--batch",
                      "2", "--seq", "12", "--device", "cpu"])
    assert fa.launches == before
    assert res.cfg.family == "hybrid" and len(res.losses) == 3
    assert all(np.isfinite(loss) for loss in res.losses)
    remat = train.main(["--arch", f"{ARCH}-reduced", "--steps", "1",
                        "--batch", "2", "--seq", "12", "--device", "cpu",
                        "--remat", "block", "--microbatches", "2"])
    np.testing.assert_allclose(remat.losses[0], res.losses[0], rtol=1e-4)
