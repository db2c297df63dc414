"""The encoder-decoder (audio) family of the port against the JAX reference
on the CPU: ``layers.layernorm``, the GELU MLP and ``models/encdec.py`` part
by part, then reduced whisper-small (2 + 2 layers, d 64, 4 heads, 32
frames) whole.

Parameters are drawn by the reference's ``init`` (and ``init_mlp``,
``_init_mha``) and carried over with ``weights.from_jax``; frames, tokens
and labels come from numpy. The parts are held at fp32 2e-5; the model
runs at ``precision="fp32"`` and its logits, loss, gradients, train steps
and decode at 1e-4. No TPU kernel is on this path: the reference's
``_mha`` calls ``layers.attention`` or ``layers.chunked_attention``, and so
does the port's. Decode runs two ways, as in the reference:
teacher-forced from ``init_cache`` with ``build_cross_cache``
(tests/test_models.py; also against the forward, within its 0.1), and
after ``make_prefill_step``, whose self cache is prompt-long whatever
``max_len`` says: decoding past the prompt wraps the ring and the position
embedding in both packages (ROADMAP.md §C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import encdec as JE
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import encdec as TE
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-4)
PART_TOL = dict(rtol=2e-5, atol=2e-5)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-6)
B, S = 2, 10


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


def _rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------


def test_layernorm_matches_reference():
    x = _rng_array((2, 5, 24), 0, 3.0) + 1.5
    scale, bias = _rng_array((24,), 1), _rng_array((24,), 2)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": _t(scale), "bias": _t(bias)}
    np.testing.assert_allclose(_np(tlayers.layernorm(tp, _t(x))),
                               _np(jlayers.layernorm(jp, jnp.asarray(x))),
                               **PART_TOL)
    init = tlayers.init_layernorm(24, torch.bfloat16)
    ref = jlayers.init_layernorm(24, jnp.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == \
        {k: (v.shape, torch.bfloat16) for k, v in ref.items()}
    xb = _t(x).to(torch.bfloat16)
    assert tlayers.layernorm(tp, xb).dtype == torch.bfloat16


def test_gelu_mlp_matches_reference():
    jp = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(0),
                                                   16, 40))
    jp["b_up"] = _rng_array((40,), 3)
    jp["b_down"] = _rng_array((16,), 4)
    tp = {k: _t(v) for k, v in jp.items()}
    x = _rng_array((2, 7, 16), 5, 2.0)
    np.testing.assert_allclose(
        _np(tlayers.apply_mlp(tp, _t(x))),
        _np(jlayers.apply_mlp(jax.tree.map(jnp.asarray, jp),
                              jnp.asarray(x))), **PART_TOL)
    own = tlayers.init_mlp(torch.Generator().manual_seed(0), 16, 40)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("length,dim", [(1500, 768), (37, 64)])
def test_sinusoid_matches_reference(length, dim):
    """2e-5, plus at whisper-small's 1500 frames what one fp32 step in a
    frequency moves the angle at the last position: XLA's and PyTorch's
    fp32 exp differ by one step in 43 of the 384 frequencies at d 768
    (both then multiply and take sin alike), and position p carries that
    step times p into the angle, up to 1499 * 2**-23 = 1.8e-4."""
    atol = PART_TOL["atol"] + (length - 1) * 2.0 ** -23
    np.testing.assert_allclose(_np(TE.sinusoid(length, dim)),
                               _np(JE.sinusoid(length, dim)),
                               rtol=PART_TOL["rtol"], atol=atol)


@pytest.mark.parametrize("kind", ["causal", "cross", "cross_chunked"])
def test_mha_matches_reference(kind):
    d, H, D = 32, 4, 8
    jp = jax.tree.map(np.asarray, JE._init_mha(jax.random.PRNGKey(1), d, H,
                                               D, jnp.float32))
    tp = {k: _t(v) for k, v in jp.items()}
    xq = _rng_array((2, 9, d), 6)
    xkv = xq if kind == "causal" else _rng_array((2, 21, d), 7)
    kw = dict(causal=kind == "causal")
    if kind == "cross_chunked":
        kw.update(chunked=True, q_chunk=4, kv_chunk=8)
    np.testing.assert_allclose(
        _np(TE._mha(tp, _t(xq), _t(xkv), **kw)),
        _np(JE._mha(jax.tree.map(jnp.asarray, jp), jnp.asarray(xq),
                    jnp.asarray(xkv), **kw)), **PART_TOL)


# ---------------------------------------------------------------------------
# reduced whisper-small
# ---------------------------------------------------------------------------

_PARAMS = {}


def _setup():
    """(jcfg, tcfg, reference params as numpy, port params)."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    if ARCH not in _PARAMS:
        params = jax.jit(JE.init, static_argnums=1)(jax.random.PRNGKey(1),
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


def _batches(cfg, rows, seq, seed, labels=True):
    frames = _rng_array((rows, cfg.n_enc_frames, cfg.d_model), seed)
    tokens = _tokens(cfg.vocab, (rows, seq), seed + 1)
    j = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    t = {"frames": torch.from_numpy(frames),
         "tokens": torch.from_numpy(tokens).long()}
    if labels:
        lab = _tokens(cfg.vocab, (rows, seq), seed + 2)
        lab[:, -2:] = -1
        j["labels"], t["labels"] = jnp.asarray(lab), torch.from_numpy(
            lab).long()
    return j, t


def test_configs_are_copies_and_resolve():
    for get in ("get_config", "get_reduced"):
        j = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        t = dataclasses.asdict(getattr(tconfigs, get)(ARCH))
        assert j.pop("dtype") == np.float32 and t.pop("dtype") == torch.float32
        assert j == t
    cfg = tconfigs.get(ARCH)
    assert (cfg.family, cfg.head_dim, cfg.n_enc_frames, cfg.takes_embeddings,
            cfg.sub_quadratic, tsteps.is_encdec(cfg)) == \
        ("audio", 64, 1500, True, False, True)


@pytest.mark.parametrize("reduced", [False, True])
def test_leaf_shapes_match_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    jcfg = getattr(jconfigs, get)(ARCH)
    abstract = jax.eval_shape(lambda k: JE.init(k, jcfg),
                              jax.random.PRNGKey(0))
    ref = {p: tuple(a.shape) for p, a in weights.flatten(abstract).items()}
    assert weights.leaf_shapes(getattr(tconfigs, get)(ARCH)) == ref


def test_init_layout_and_state_from_jax():
    jcfg, tcfg, params_np, _ = _setup()
    own = weights.flatten(tsteps.model_init(torch.Generator().manual_seed(0),
                                            tcfg, "cpu"))
    assert {p: tuple(a.shape) for p, a in own.items()} == \
        weights.leaf_shapes(tcfg)
    jo = jopt.adamw(1e-3)
    jstate = jax.tree.map(np.asarray, jsteps.make_train_state(
        jax.random.PRNGKey(0), jcfg, jo))
    tstate = weights.state_from_jax(jstate, tcfg, "cpu")
    assert set(tstate["opt"]) == set(jstate["opt"]) and tstate["step"] == 0
    for name, tree in tstate["opt"].items():
        assert {p: tuple(a.shape) for p, a in weights.flatten(tree).items()} \
            == weights.leaf_shapes(tcfg), name


def test_forward_matches_reference():
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    jb, tb = _batches(jcfg, B, S, 3, labels=False)
    jl, ja = jax.jit(JE.forward, static_argnums=(2, 3))(params_np, jb, jcfg,
                                                        jsys)
    before = fa.launches
    tl, ta = TE.forward(tparams, tb, tcfg, tsys)
    assert fa.launches == before == 0
    assert tuple(tl.shape) == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert float(ta) == float(ja) == 0.0


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(remat):
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(remat=remat)
    jb, tb = _batches(jcfg, B, S, 4)
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(JE.loss_fn, has_aux=True), static_argnums=(2, 3))(
        params_np, jb, jcfg, jsys)
    flat = {p: a.detach().requires_grad_()
            for p, a in weights.flatten(tparams).items()}
    tl, tm = tsteps.model_loss(weights.unflatten(flat), tb, tcfg, tsys)
    tg = dict(zip(flat, torch.autograd.grad(tl, list(flat.values()))))
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
        jb, tb = _batches(jcfg, 4, S, 10 + i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    j_flat = weights.flatten(jax.tree.map(np.asarray, jstate["params"]))
    for path, t in weights.flatten(tstate["params"]).items():
        np.testing.assert_allclose(_np(t), j_flat[path], err_msg=path, **TOL)


def test_prefill_and_handover_past_the_prompt_match_reference():
    """Prefill S tokens (``max_len`` given, and ignored as in the
    reference: the self cache is S long), then decode 6 tokens at
    positions S..S+5: slots 0..5 of the ring are overwritten and the
    position embedding restarts at 0, in both packages. The caches hold
    bf16, where an fp32 difference in the last place can round a value to
    the neighbouring bf16 (a few of the cross cache's do), and decode's
    bf16 probabilities carry such a flip into the logits beyond 1e-4; so
    both decoders continue from the reference's cache, and the logits and
    the ring are held at 1e-4 from there."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    jb, tb = _batches(jcfg, B, S, 5, labels=False)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg, jsys, max_len=S + 6))(
        params_np, jb)
    tl, tc = tsteps.make_prefill_step(tcfg, tsys, max_len=S + 6)(
        tparams, tb)
    assert tuple(tl.shape) == jl.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert set(tc) == set(jc) == {"self_k", "self_v", "cross_k", "cross_v"}
    L, H, D = tcfg.n_layers, tcfg.n_heads, tcfg.head_dim
    assert tuple(tc["self_k"].shape) == jc["self_k"].shape == (L, B, S, H, D)
    assert tuple(tc["cross_k"].shape) == (L, B, tcfg.n_enc_frames, H, D)
    for name in tc:
        assert tc[name].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), err_msg=name,
                                   **CACHE_TOL)
    tc = {k: _t(v).to(torch.bfloat16) for k, v in jc.items()}
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    tdecode = tsteps.make_decode_step(tcfg, tsys)
    feed = _tokens(jcfg.vocab, (6, B, 1), 6)
    for i in range(6):
        jl, jc = jdecode(params_np, jc, jnp.asarray(feed[i]),
                         jnp.int32(S + i))
        tl, tc = tdecode(tparams, tc, torch.from_numpy(feed[i]).long(),
                         S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=str(i), **TOL)
    for name in tc:
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), err_msg=name,
                                   **CACHE_TOL)


def test_teacher_forced_decode_from_init_cache_matches_reference():
    """tests/test_models.py's whisper decode: fp32 caches from
    ``init_cache``, the cross cache from ``build_cross_cache``, the tokens
    fed one by one; logits against the reference's at 1e-4 and against the
    port's own forward within 0.1."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    jb, tb = _batches(jcfg, B, S, 7, labels=False)
    jenc = JE.encode(params_np, jb["frames"], jcfg, jsys)
    tenc = TE.encode(tparams, tb["frames"], tcfg, tsys)
    np.testing.assert_allclose(_np(tenc), _np(jenc), **TOL)
    jc = JE.init_cache(jcfg, B, S, dtype=jnp.float32)
    jc["cross_k"], jc["cross_v"] = JE.build_cross_cache(
        params_np, jenc, jcfg, dtype=jnp.float32)
    tc = TE.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    tc["cross_k"], tc["cross_v"] = TE.build_cross_cache(
        tparams, tenc, tcfg, dtype=torch.float32)
    np.testing.assert_allclose(_np(tc["cross_k"]), _np(jc["cross_k"]), **TOL)
    tfull, _ = TE.forward(tparams, tb, tcfg, tsys)
    errs = []
    jdecode = jax.jit(JE.decode_step, static_argnums=(4, 5))
    for t in range(S):
        jl, jc = jdecode(params_np, jc, jb["tokens"][:, t:t + 1],
                         jnp.int32(t), jcfg, jsys)
        tl, tc = TE.decode_step(tparams, tc, tb["tokens"][:, t:t + 1], t,
                                tcfg, tsys)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=str(t), **TOL)
        errs.append(float((tl[:, 0] - tfull[:, t]).abs().max()))
    assert max(errs) < 0.1, f"decode drift {max(errs)}"


def test_serve_and_train_refuse_an_encdec():
    with pytest.raises(NotImplementedError, match="frames plus tokens"):
        serve.main(["--arch", f"{ARCH}-reduced", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="frames.*make_train_step"):
        train.main(["--arch", f"{ARCH}-reduced", "--steps", "1",
                    "--device", "cpu"])
