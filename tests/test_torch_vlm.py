"""The vlm family of the port against the JAX reference on the CPU: reduced
internvl2-26b (2 attention blocks, K 2, G 2, head_dim 16) whole.

The vlm is the dense path behind one linear ``adapter`` on precomputed
patch embeddings (the reference's stub frontend); its decode takes tokens,
``embed[tokens] @ adapter`` (transformer.py:475-477), so the reference
never compares a vlm's decode with its forward, and neither do these
tests: decode is held against the reference's decode. Parameters are drawn
by the reference's ``init`` and carried over with ``weights.from_jax``;
embeddings, tokens and labels come from numpy. Both run at
``precision="fp32"`` with ``q_chunk=kv_chunk=16``, with ``use_pallas`` on
(JAX: the Pallas kernels in interpret mode; port: the plain versions of
B1, and of B2/B3 for gradients) and off; logits, loss, gradients, train
steps, prefill and decode at 1e-4. ``embed`` is a leaf the loss does not
use: its gradient is zero in both, and adamw still decays it.
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

ARCH = "internvl2-26b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-6)
B, S, GEN = 2, 12, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else a, np.float32)


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


def _embeddings(d, shape, seed=2):
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


def _tokens(vocab, shape, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _batches(cfg, rows, seed):
    emb = _embeddings(cfg.d_model, (rows, S), seed)
    labels = _tokens(cfg.vocab, (rows, S), seed + 100)
    return ({"embeddings": jnp.asarray(emb), "labels": jnp.asarray(labels)},
            {"embeddings": torch.from_numpy(emb),
             "labels": torch.from_numpy(labels).long()})


def test_configs_are_copies_and_resolve():
    for get in ("get_config", "get_reduced"):
        j = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        t = dataclasses.asdict(getattr(tconfigs, get)(ARCH))
        assert j.pop("dtype") == np.float32 and t.pop("dtype") == torch.float32
        assert j == t
    cfg = tconfigs.get(ARCH)
    assert (cfg.family, cfg.takes_embeddings, cfg.n_kv_heads,
            cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim) == \
        ("vlm", True, 8, 6, 128)


@pytest.mark.parametrize("reduced", [False, True])
def test_leaf_shapes_match_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    jcfg = getattr(jconfigs, get)(ARCH)
    abstract = jax.eval_shape(lambda k: JT.init(k, jcfg),
                              jax.random.PRNGKey(0))
    ref = {p: tuple(a.shape) for p, a in weights.flatten(abstract).items()}
    assert weights.leaf_shapes(getattr(tconfigs, get)(ARCH)) == ref
    assert ref["adapter"] == (jcfg.d_model, jcfg.d_model)


def test_init_layout():
    tcfg = tconfigs.get_reduced(ARCH)
    own = weights.flatten(TT.init(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    assert {p: tuple(a.shape) for p, a in own.items()} == \
        weights.leaf_shapes(tcfg)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_matches_reference(use_pallas):
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(use_pallas=use_pallas)
    jb, tb = _batches(jcfg, B, 4)
    jl, ja = jax.jit(JT.forward, static_argnums=(2, 3))(
        params_np, {"embeddings": jb["embeddings"]}, jcfg, jsys)
    before = fa.launches
    tl, ta = TT.forward(tparams, {"embeddings": tb["embeddings"]}, tcfg,
                        tsys)
    assert fa.launches == before              # CPU: the plain version
    assert tuple(tl.shape) == (B, S, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert float(ta) == float(ja) == 0.0


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_loss_and_grads_match_reference(use_pallas, remat):
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(use_pallas=use_pallas, remat=remat)
    jb, tb = _batches(jcfg, B, 5)
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(JT.loss_fn, has_aux=True), static_argnums=(2, 3))(
        params_np, jb, jcfg, jsys)
    flat = {p: a.detach().requires_grad_()
            for p, a in weights.flatten(tparams).items()}
    tl, tm = TT.loss_fn(weights.unflatten(flat), tb, tcfg, tsys)
    grads = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    tg = dict(zip(flat, grads))
    assert tg["embed"] is None                 # forward starts at the adapter
    tg["embed"] = torch.zeros_like(flat["embed"])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for name in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **TOL)
    j_flat = weights.flatten(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(j_flat)
    assert not np.any(j_flat["embed"])
    for path, g in tg.items():
        np.testing.assert_allclose(_np(g), j_flat[path], err_msg=path, **TOL)


def _train(jcfg, tcfg, params_np, tparams, jsys, tsys, jo, to, steps):
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsys, jo, mesh=None))
    tstep = tsteps.make_train_step(tcfg, tsys, to)
    jstate = {"params": jax.tree.map(jnp.asarray, params_np),
              "opt": jo.init(params_np), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tparams, "opt": to.init(tparams), "step": 0}
    for i in range(steps):
        jb, tb = _batches(jcfg, 4, 10 + i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    return (weights.flatten(jax.tree.map(np.asarray, jstate["params"])),
            weights.flatten(tstate["params"]))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, use_pallas):
    """Two steps under SGD with momentum (the reference with mesh=None);
    the unused ``embed`` stays put under SGD."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(microbatches=microbatches, use_pallas=use_pallas)
    j_flat, t_flat = _train(jcfg, tcfg, params_np, tparams, jsys, tsys,
                            jopt.sgd(0.1, momentum=0.9),
                            topt.sgd(0.1, momentum=0.9), 2)
    for path, t in t_flat.items():
        np.testing.assert_allclose(_np(t), j_flat[path], err_msg=path, **TOL)
    np.testing.assert_array_equal(_np(t_flat["embed"]), params_np["embed"])


def test_adamw_decays_the_unused_embedding():
    """One adamw step with weight decay: ``embed``'s zero gradient leaves
    only the decay, p (1 - lr wd), in both packages."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems()
    lr, wd = 1e-2, 0.1
    j_flat, t_flat = _train(jcfg, tcfg, params_np, tparams, jsys, tsys,
                            jopt.adamw(lr, weight_decay=wd),
                            topt.adamw(lr, weight_decay=wd), 1)
    np.testing.assert_allclose(_np(t_flat["embed"]), j_flat["embed"],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(_np(t_flat["embed"]),
                               params_np["embed"] * (1 - lr * wd),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(_np(t_flat["adapter"]), j_flat["adapter"],
                               **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_then_decode_match_reference(use_pallas):
    """Prefill patch embeddings (the prompt length from
    ``batch["embeddings"]``), then decode GEN tokens through
    ``embed[tokens] @ adapter`` from the prefill's caches. The caches hold
    bf16 in both packages: one bf16 step apart at most."""
    jcfg, tcfg, params_np, tparams = _setup()
    jsys, tsys = _systems(use_pallas=use_pallas)
    emb = _embeddings(jcfg.d_model, (B, S), 6)
    feed = _tokens(jcfg.vocab, (GEN, B, 1), 7)
    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg, jsys, max_len=S + GEN))(
        params_np, {"embeddings": jnp.asarray(emb)})
    tl, tc = tsteps.make_prefill_step(tcfg, tsys, max_len=S + GEN)(
        tparams, {"embeddings": torch.from_numpy(emb)})
    assert tuple(tl.shape) == jl.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **CACHE_TOL)
    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    tdecode = tsteps.make_decode_step(tcfg, tsys)
    for i in range(GEN):
        jl, jc = jdecode(params_np, jc, jnp.asarray(feed[i]),
                         jnp.int32(S + i))
        tl, tc = tdecode(tparams, tc, torch.from_numpy(feed[i]).long(),
                         S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **CACHE_TOL)


def test_serve_and_train_refuse_a_vlm():
    with pytest.raises(NotImplementedError, match="patch embeddings"):
        serve.main(["--arch", f"{ARCH}-reduced", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="embeddings.*"
                       "make_train_step"):
        train.main(["--arch", f"{ARCH}-reduced", "--steps", "1",
                    "--device", "cpu"])
