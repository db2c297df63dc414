"""The xLSTM (ssm) family of the port against the JAX reference on the CPU:
``models/xlstm.py`` part by part, then reduced xlstm-350m (1 group of 2
mLSTM blocks and 1 sLSTM block) whole.

Parameters are drawn by the reference's ``init``/``init_mlstm``/
``init_slstm`` and carried over with ``weights.from_jax``; inputs, tokens
and labels come from numpy. The parts are held at fp32 2e-5; the model
runs at ``precision="fp32"`` and its logits, loss, gradients, train steps
and decode at 1e-4. The reference's xLSTM runs its jnp chunkwise mLSTM,
never the Pallas mLSTM kernel (B4), and the port its plain version
(``kernels.mlstm.mlstm_chunkwise_reference``), so ``use_pallas`` changes
nothing here and B4 never launches. As in the reference, an ssm's prefill
returns no cache: decode runs token by token from ``init_cache``
(tests/test_models.py), with fp32 and bf16 conv states.
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
from repro.models import xlstm as jx
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.kernels import mlstm as ml
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as tx
from repro_torch.optim import optimizers as topt

ARCH = "xlstm-350m"
TOL = dict(rtol=1e-4, atol=1e-4)
PART_TOL = dict(rtol=2e-5, atol=2e-5)
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


def _rng_array(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


# ---------------------------------------------------------------------------
# models/xlstm.py
# ---------------------------------------------------------------------------

D_MODEL, N_HEADS = 16, 2
JCFG = jx.MLSTMConfig(d_model=D_MODEL, n_heads=N_HEADS)
TCFG = tx.MLSTMConfig(d_model=D_MODEL, n_heads=N_HEADS)


def _cell_params(init_j, seed=0):
    p = jax.tree.map(np.asarray, init_j(jax.random.PRNGKey(seed), JCFG))
    return p, jax.tree.map(_t, p)


def _qkv_gates(Bq, Sq, H, D, seed):
    """q, k, v (B, S, H, D) and the gates (B, S, H); the forget gate
    shifted up, as a trained one leans open."""
    q, k, v = (_rng_array((Bq, Sq, H, D), seed + i) for i in range(3))
    ig = _rng_array((Bq, Sq, H), seed + 3)
    fg = _rng_array((Bq, Sq, H), seed + 4, shift=2.0)
    return q, k, v, ig, fg


def _state(Bq, H, D, seed):
    return (_rng_array((Bq, H, D, D), seed, 0.1),
            _rng_array((Bq, H, D), seed + 1, 0.1),
            _rng_array((Bq, H), seed + 2))


def _close_tree(got, want, tol=PART_TOL):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=str(i), **tol)


def test_mlstm_config_and_init_layout():
    jp, _ = _cell_params(jx.init_mlstm)
    tp = tx.init_mlstm(torch.Generator().manual_seed(0), TCFG,
                       torch.bfloat16)
    flat_t, flat_j = weights.flatten(tp), weights.flatten(jp)
    assert {k: tuple(v.shape) for k, v in flat_t.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    for k, v in flat_t.items():
        want = (torch.float32 if k in ("w_if", "b_if") else torch.bfloat16)
        assert v.dtype == want, k
    np.testing.assert_array_equal(_np(tp["b_if"]), jp["b_if"])
    assert (TCFG.d_inner, TCFG.head_dim) == (JCFG.d_inner, JCFG.head_dim)
    js = jx.init_slstm(jax.random.PRNGKey(0), JCFG)
    ts = tx.init_slstm(torch.Generator().manual_seed(0), TCFG)
    assert {k: tuple(v.shape) for k, v in weights.flatten(ts).items()} == \
        {k: v.shape for k, v in weights.flatten(js).items()}
    for t_state, j_state in (
            (tx.init_mlstm_state(TCFG, 3, torch.bfloat16),
             jx.init_mlstm_state(JCFG, 3)),
            (tx.init_slstm_state(TCFG, 3), jx.init_slstm_state(JCFG, 3))):
        assert set(t_state) == set(j_state)
        for k, v in t_state.items():
            assert tuple(v.shape) == j_state[k].shape, k
            assert str(v.dtype)[6:] == str(j_state[k].dtype), k
            np.testing.assert_array_equal(_np(v), _np(j_state[k]))


def test_mlstm_parallel_matches_reference():
    arrs = _qkv_gates(2, 9, 2, 8, 1)
    jh, jst = jx.mlstm_parallel(*map(jnp.asarray, arrs))
    th, tst = tx.mlstm_parallel(*map(_t, arrs))
    np.testing.assert_allclose(_np(th), _np(jh), **PART_TOL)
    _close_tree(tst, jst)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunkwise_matches_reference(with_state):
    """Three chunks of 8, so the carried state acts between them; with a
    state, the first chunk reads it too."""
    arrs = _qkv_gates(2, 24, 2, 8, 2)
    st = _state(2, 2, 8, 7) if with_state else None
    jh, jst = jx.mlstm_chunkwise(*map(jnp.asarray, arrs), chunk=8,
                                 state=None if st is None
                                 else tuple(map(jnp.asarray, st)))
    th, tst = tx.mlstm_chunkwise(*map(_t, arrs), chunk=8,
                                 state=None if st is None
                                 else tuple(map(_t, st)))
    np.testing.assert_allclose(_np(th), _np(jh), **PART_TOL)
    _close_tree(tst, jst)
    # one chunk's parallel form is the chunkwise form's first chunk
    ph, _ = tx.mlstm_parallel(*(_t(a)[:, :8] for a in arrs))
    if not with_state:
        np.testing.assert_allclose(_np(ph), _np(th[:, :8]), **PART_TOL)


def test_mlstm_decode_step_matches_reference():
    q, k, v, ig, fg = (a[:, 0] for a in _qkv_gates(3, 1, 2, 8, 3))
    st = _state(3, 2, 8, 9)
    jh, jst = jx.mlstm_decode_step(*map(jnp.asarray, (q, k, v, ig, fg)),
                                   tuple(map(jnp.asarray, st)))
    th, tst = tx.mlstm_decode_step(*map(_t, (q, k, v, ig, fg)),
                                   tuple(map(_t, st)))
    np.testing.assert_allclose(_np(th), _np(jh), **PART_TOL)
    _close_tree(tst, jst)


def test_apply_mlstm_and_decode_match_reference():
    jp, tp = _cell_params(jx.init_mlstm, seed=1)
    x = _rng_array((2, 11, D_MODEL), 4)
    np.testing.assert_allclose(
        _np(tx.apply_mlstm(tp, _t(x), TCFG)),
        _np(jx.apply_mlstm(jp, jnp.asarray(x), JCFG)), **PART_TOL)
    H, D = JCFG.n_heads, JCFG.head_dim
    C, n, m = _state(2, H, D, 5)
    state = {"C": C, "n": n, "m": m,
             "conv": _rng_array((2, JCFG.conv_width - 1, JCFG.d_inner), 6)}
    jo, jst = jx.apply_mlstm_decode(
        jp, jnp.asarray(x[:, :1]), JCFG,
        {k: jnp.asarray(v) for k, v in state.items()})
    to, tst = tx.apply_mlstm_decode(
        tp, _t(x[:, :1]), TCFG, {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(_np(to), _np(jo), **PART_TOL)
    for k in ("C", "n", "m", "conv"):
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k,
                                   **PART_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_reference(with_state):
    jp, tp = _cell_params(jx.init_mlstm, seed=2)
    u = _rng_array((2, 7, JCFG.d_inner), 10)
    st = (_rng_array((2, JCFG.conv_width - 1, JCFG.d_inner), 11)
          if with_state else None)
    jo, js = jx._conv(jp, jnp.asarray(u), JCFG,
                      None if st is None else jnp.asarray(st))
    to, ts = tx._conv(tp, _t(u), TCFG, None if st is None else _t(st))
    assert ts.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **PART_TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **PART_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_slstm_matches_reference(with_state):
    jp, tp = _cell_params(jx.init_slstm, seed=3)
    x = _rng_array((2, 10, D_MODEL), 12)
    di = JCFG.d_inner
    st = None
    if with_state:
        st = {"c": _rng_array((2, di), 13), "n": _rng_array((2, di), 14,
                                                            0.1, 1.0),
              "h": _rng_array((2, di), 15, 0.5), "m": _rng_array((2, di), 16)}
    jo, jst = jx.apply_slstm(jp, jnp.asarray(x), JCFG,
                             None if st is None
                             else {k: jnp.asarray(v) for k, v in st.items()})
    to, tst = tx.apply_slstm(tp, _t(x), TCFG,
                             None if st is None
                             else {k: _t(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(to), _np(jo), **PART_TOL)
    assert set(tst) == set(jst) == {"c", "n", "h", "m"}
    for k in tst:
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), err_msg=k,
                                   **PART_TOL)


# ---------------------------------------------------------------------------
# reduced xlstm-350m
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
    kw = dict(precision="fp32", **kw)
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
    mcfg = cfg.mlstm_cfg()
    assert (cfg.family, cfg.ssm_groups, mcfg.d_inner, mcfg.head_dim,
            mcfg.chunk) == ("ssm", 3, 2048, 512, 256)
    assert tconfigs.get(f"{ARCH}-reduced").ssm_groups == 1


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
    fp32 = {"layers/mlstms/cell/w_if", "layers/mlstms/cell/b_if"}
    for path, leaf in own.items():
        want = torch.float32 if path in fp32 else torch.bfloat16
        assert leaf.dtype == want, path
    _, _, params_np, _ = _setup()
    carried = weights.flatten(weights.from_jax(params_np, tcfg, "cpu"))
    assert {p: a.dtype for p, a in carried.items()} == \
        {p: a.dtype for p, a in own.items()}


def test_forward_matches_reference():
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    toks = _tokens(jcfg.vocab, (B, S))
    jl, ja = jax.jit(JT.forward, static_argnums=(2, 3))(
        params_np, {"tokens": jnp.asarray(toks)}, jcfg, jsys)
    before = ml.launches
    tl, ta = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                        tcfg, tsys)
    assert ml.launches == before == 0          # the plain chunkwise form
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
def test_loss_and_grads_match_reference(remat):
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(remat=remat)
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


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Two steps under SGD with momentum (the reference with mesh=None)."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(microbatches=microbatches)
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


def test_prefill_returns_no_cache_as_the_reference():
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    toks = _tokens(jcfg.vocab, (B, S), seed=5)
    jl, jcache = jax.jit(jsteps.make_prefill_step(jcfg, jsys))(
        params_np, {"tokens": jnp.asarray(toks)})
    tl, tcache = tsteps.make_prefill_step(tcfg, tsys)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    assert jcache is None and tcache is None
    assert tuple(tl.shape) == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_decode_from_init_cache_matches_reference(cache):
    """Token by token from ``init_cache`` at fp32 compute: logits and every
    state leaf at 1e-4 with fp32 conv states, and decode tracks the
    parallel forward (0.15, tests/test_models.py's bound). With bf16 conv
    states the conv inputs round to bf16 in both, where an fp32 difference
    in the last place can round one value to the neighbouring bf16: logits
    at 2e-2, the conv states one bf16 step apart, the rest at 2e-2."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    toks = _tokens(jcfg.vocab, (B, S))
    dt = cache
    tc = TT.init_cache(tcfg, B, S, dtype=getattr(torch, dt), device="cpu")
    jc = JT.init_cache(jcfg, B, S, dtype=getattr(jnp, dt))
    assert set(tc) == set(jc) == {"mlstms", "slstm"}
    for part in tc:
        assert {k: (tuple(v.shape), str(v.dtype)[6:])
                for k, v in tc[part].items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jc[part].items()}, part
        for k, v in tc[part].items():
            np.testing.assert_array_equal(_np(v), _np(jc[part][k]))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    tdecode = tsteps.make_decode_step(tcfg, tsys)
    jls, tls = [], []
    for t in range(S):
        jl, jc = jdecode(params_np, jc, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        tl, tc = tdecode(tparams, tc, torch.from_numpy(toks[:, t:t + 1]
                                                       ).long(), t)
        jls.append(_np(jl)[:, 0])
        tls.append(_np(tl)[:, 0])
    jl, tl = np.stack(jls, 1), np.stack(tls, 1)
    if cache == "bfloat16":
        np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
        for part in tc:
            for name, leaf in tc[part].items():
                tol = (dict(rtol=2 ** -7, atol=1e-6) if name == "conv"
                       else dict(rtol=2e-2, atol=2e-2))
                np.testing.assert_allclose(_np(leaf), _np(jc[part][name]),
                                           err_msg=f"{part}/{name}", **tol)
        return
    np.testing.assert_allclose(tl, jl, **TOL)
    for part in tc:
        for name, leaf in tc[part].items():
            np.testing.assert_allclose(_np(leaf), _np(jc[part][name]),
                                       err_msg=f"{part}/{name}", **TOL)
    tfull, _ = TT.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                          tcfg, tsys)
    drift = float(np.abs(tl - _np(tfull)).max())
    assert drift < 0.15, f"decode drift {drift}"


def test_serve_refuses_an_ssm():
    with pytest.raises(NotImplementedError, match="returns None"):
        serve.main(["--arch", f"{ARCH}-reduced", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2", "--device", "cpu"])


def test_train_launcher_trains_an_ssm_on_cpu():
    before = ml.launches
    res = train.main(["--arch", f"{ARCH}-reduced", "--steps", "3", "--batch",
                      "2", "--seq", "12", "--device", "cpu"])
    assert ml.launches == before
    assert res.cfg.family == "ssm" and len(res.losses) == 3
    assert all(np.isfinite(loss) for loss in res.losses)
    remat = train.main(["--arch", f"{ARCH}-reduced", "--steps", "1",
                        "--batch", "2", "--seq", "12", "--device", "cpu",
                        "--remat", "block", "--microbatches", "2"])
    np.testing.assert_allclose(remat.losses[0], res.losses[0], rtol=1e-4)
