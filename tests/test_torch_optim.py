"""The port's optimizers and schedules against the reference's, fp32 at 1e-6.

Parameters and per-step gradients are seeded numpy arrays handed to both
packages; each optimizer takes several steps in each and the parameters and
states are compared after every step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.optim import optimizers as jopt
from repro_torch import tree
from repro_torch.optim import optimizers as topt

STEPS = 6
TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((4, 3))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal((5,))).astype(
                np.float32)}}


def _to_torch(arrays):
    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), arrays)


def _assert_close(t_tree, j_tree):
    for t, j in zip(tree.tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _run_both(make):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt_, topt_ = make(jopt), make(topt)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt_.init(jp), topt_.init(tp)
    for step in range(STEPS):
        grads = _tree(rng, scale=3.0)     # large enough to be clipped
        ju, js = jopt_.update(jax.tree.map(jnp.asarray, grads), js, jp,
                              jnp.int32(step))
        tu, ts = topt_.update(_to_torch(grads), ts, tp, step)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _assert_close(tu, ju)
        _assert_close(tp, jp)
        _assert_close(ts, js)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1},
                                {"clip_norm": None, "b2": 0.999}])
def test_adamw_matches_reference(kw):
    _run_both(lambda o: o.adamw(o.warmup_cosine(1e-2, 2, STEPS), **kw))


@pytest.mark.parametrize("kw", [{}, {"nesterov": True},
                                {"momentum": 0.5, "clip_norm": 1.0}])
def test_sgd_matches_reference(kw):
    _run_both(lambda o: o.sgd(o.cosine_schedule(5e-2, STEPS), **kw))


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("cosine_schedule", (3e-4, 40)),
    ("cosine_schedule", (1e-3, 0, 0.2)),
    ("warmup_cosine", (3e-4, 10, 100)),
    ("warmup_cosine", (1e-3, 0, 5)),
])
def test_schedules_match_reference(name, args):
    j, t = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(0, 120, 3):
        assert t(step) == pytest.approx(float(j(jnp.int32(step))), rel=1e-6,
                                        abs=1e-12)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(np.random.default_rng(1), scale=4.0)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                      max_norm)
    tc, tn = topt.clip_by_global_norm(_to_torch(grads), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _assert_close(tc, jc)
