"""The paper's small workloads (Table 3) in the port against the JAX
reference: datasets, ``stable_hash``, the three models, dropout, the weight
map and the configs.

Datasets must be byte-equal (both are numpy from the same seed). The models
run at fp32 on the same numpy inputs with weights carried over by
``weights.from_jax``: logits and loss within 2e-5, gradients within 1e-4
(rtol and atol each; tests/test_kernels.py's fp32 and gradient tolerances);
accuracy equal. Dropout masks cannot be bit-equal to ``jax.random``'s, so
dropout is checked for its own properties: the eval path untouched, the
keep rate within 0.01 of 1 - p over 64k draws, kept values scaled by
1 / (1 - p), and the mask a function of (rng, salt).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import seeding as jseeding
from repro.data import synthetic as jsynthetic
from repro.models import small as J
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.core import seeding as tseeding
from repro_torch.data import synthetic as tsynthetic
from repro_torch.models import small as T

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B = 4
WORKLOADS = ["lenet-mnist", "lenet-fashion", "cnn-news20", "lstm-news20"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- datasets

def _assert_same_arrays(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed,n,classes", [(0, 37, 10), (123, 64, 3)])
def test_image_dataset_is_byte_equal(seed, n, classes):
    _assert_same_arrays(tsynthetic.make_image_dataset(seed, n, classes),
                        jsynthetic.make_image_dataset(seed, n, classes))


@pytest.mark.parametrize("seed,n,vocab,seq", [(0, 19, 4096, 128),
                                              (7, 40, 300, 33)])
def test_text_dataset_is_byte_equal(seed, n, vocab, seq):
    _assert_same_arrays(
        tsynthetic.make_text_dataset(seed, n, vocab=vocab, seq_len=seq),
        jsynthetic.make_text_dataset(seed, n, vocab=vocab, seq_len=seq))


def test_batches_and_split_are_byte_equal():
    data = jsynthetic.make_image_dataset(3, 50)
    ttr, tte = tsynthetic.train_test_split(data, test_frac=0.3, seed=5)
    jtr, jte = jsynthetic.train_test_split(data, test_frac=0.3, seed=5)
    _assert_same_arrays(ttr, jtr)
    _assert_same_arrays(tte, jte)
    tb = tsynthetic.Batches(ttr, 8, seed=2)
    jb = jsynthetic.Batches(jtr, 8, seed=2)
    assert tb.batches_per_epoch == jb.batches_per_epoch == 4
    for epoch, start in [(0, 0), (1, 0), (3, 2)]:
        ours = list(tb.epoch(epoch, start))
        theirs = list(jb.epoch(epoch, start))
        assert len(ours) == len(theirs) == 4 - start
        for a, b in zip(ours, theirs):
            _assert_same_arrays(a, b)


def test_stable_hash_is_equal():
    for s in ("", "lenet-mnist", "lstm-news20", "épreuve"):
        assert tseeding.stable_hash(s) == jseeding.stable_hash(s)


def test_configs_match_reference():
    assert tconfigs.PAPER_WORKLOADS == jconfigs.PAPER_WORKLOADS == WORKLOADS
    for name in WORKLOADS:
        for get in ("get_config", "get_reduced"):
            j = dataclasses.asdict(getattr(jconfigs, get)(name))
            t = dataclasses.asdict(getattr(tconfigs, get)(name))
            assert j.pop("dtype") == jnp.float32
            assert t.pop("dtype") == torch.float32
            assert j == t
    assert isinstance(tconfigs.get_config("lstm-news20"), T.SmallConfig)


# --------------------------------------------------------------- models

def _cfgs(name, embed_dim=None):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    if embed_dim is not None:
        j = dataclasses.replace(j, embed_dim=embed_dim)
        t = dataclasses.replace(t, embed_dim=embed_dim)
    return j, t


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.n_classes, B).astype(np.int32)
    if cfg.kind == "lenet":
        return {"images": rng.randn(B, 28, 28, 1).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.randint(0, cfg.vocab, (B, cfg.seq_len))
            .astype(np.int32), "labels": labels}


def _port_loss_and_grads(tparams, batch, tcfg):
    leaves = {p: t.detach().requires_grad_()
              for p, t in weights.flatten(tparams).items()}
    loss, m = T.loss_fn(weights.unflatten(leaves),
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, m, dict(zip(leaves, grads))


CASES = [(name, None) for name in WORKLOADS] + [
    ("cnn-news20", 50), ("cnn-news20", 300),
    ("lstm-news20", 50), ("lstm-news20", 300)]


@pytest.mark.parametrize("name,embed_dim", CASES)
def test_model_matches_reference(name, embed_dim):
    jcfg, tcfg = _cfgs(name, embed_dim)
    params = jax.tree.map(np.asarray, J.init(jax.random.PRNGKey(1), jcfg))
    tparams = weights.from_jax(params, tcfg, "cpu")
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    logits = np.asarray(J.forward(params, jb, jcfg))
    tlogits = T.forward(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(tlogits.detach().numpy(), logits, **OUT_TOL)

    (jloss, jm), jgrads = jax.value_and_grad(J.loss_fn, has_aux=True)(
        params, jb, jcfg)
    tloss, tm, tgrads = _port_loss_and_grads(tparams, batch, tcfg)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **OUT_TOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    want = weights.flatten(weights.from_jax(jax.tree.map(np.asarray, jgrads),
                                            tcfg, "cpu"))
    assert set(tgrads) == set(want)
    for path, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                   err_msg=path, **GRAD_TOL)


def test_lstm_recurrence_backward_is_the_gradient():
    """The LSTM loop's own backward through time against finite
    differences, in float64 (``torch.autograd.gradcheck``'s defaults)."""
    gen = torch.Generator().manual_seed(0)
    xw = torch.randn(2, 6, 12, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    w_hh = torch.randn(3, 12, generator=gen, dtype=torch.float64,
                       requires_grad=True)
    assert torch.autograd.gradcheck(T._LSTMRecurrence.apply, (xw, w_hh))


@pytest.mark.parametrize("name", ["lenet-mnist", "cnn-news20", "lstm-news20"])
def test_init_layout_and_device(name):
    tcfg = tconfigs.get_config(name)
    params = T.init(torch.Generator().manual_seed(0), tcfg)
    shapes = {p: tuple(a.shape) for p, a in weights.flatten(params).items()}
    assert shapes == weights.leaf_shapes(tcfg)
    again = T.init(torch.Generator().manual_seed(0), tcfg)
    for a, b in zip(weights.flatten(params).values(),
                    weights.flatten(again).values()):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_from_jax_small_rejects_unknown_missing_and_misshapen():
    jcfg, tcfg = _cfgs("cnn-news20")
    params = weights.flatten(jax.tree.map(
        np.asarray, J.init(jax.random.PRNGKey(0), jcfg)))
    with pytest.raises(KeyError, match="convs/3/w"):
        weights.from_jax({**params, "convs/3/w": np.zeros((1,))}, tcfg, "cpu")
    with pytest.raises(KeyError, match="embed"):
        weights.from_jax({p: a for p, a in params.items() if p != "embed"},
                         tcfg, "cpu")
    bad = dict(params)
    bad["convs/1/w"] = np.zeros((3, 100, 128), np.float32)   # width 4 wanted
    with pytest.raises(ValueError, match="convs/1/w"):
        weights.from_jax(bad, tcfg, "cpu")


def test_state_from_jax_carries_momentum():
    jcfg, tcfg = _cfgs("lenet-mnist")
    params = jax.tree.map(np.asarray, J.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    mu = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
    state = weights.state_from_jax({"params": params, "opt": {"mu": mu},
                                    "step": np.int32(5)}, tcfg, "cpu")
    assert state["step"] == 5
    got = state["opt"]["mu"]["c2"]["w"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (16, 6, 5, 5)
    np.testing.assert_array_equal(got.numpy(),
                                  mu["c2"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["opt"]["mu"]["f1"]["w"].numpy(),
                                  mu["f1"]["w"])


# -------------------------------------------------------------- dropout

def test_dropout_eval_path_untouched():
    jcfg, tcfg = _cfgs("lstm-news20")
    tcfg = dataclasses.replace(tcfg, dropout=0.5)
    params = T.init(torch.Generator().manual_seed(0), tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    plain = T.forward(params, batch, dataclasses.replace(tcfg, dropout=0.0))
    for kw in ({}, {"rng": 3}, {"train": True}):   # no rng: no mask either
        assert torch.equal(T.forward(params, batch, tcfg, **kw), plain)
    assert not torch.equal(T.forward(params, batch, tcfg, train=True, rng=3),
                           plain)


@pytest.mark.parametrize("rate", [0.1, 0.45])
def test_dropout_keep_rate_and_scaling(rate):
    x = torch.full((256, 256), 2.0)
    y = T._dropout(x, rate, True, 11, 0)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1.0 - rate)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        2.0 / (1.0 - rate)))


def test_dropout_mask_is_deterministic_given_the_seed():
    x = torch.ones(64, 32)
    a = T._dropout(x, 0.3, True, 5, 1)
    assert torch.equal(a, T._dropout(x, 0.3, True, 5, 1))
    assert not torch.equal(a, T._dropout(x, 0.3, True, 6, 1))
    assert not torch.equal(a, T._dropout(x, 0.3, True, 5, 2))
