"""The port's MoE layer and int8 KV quantisation against the JAX reference.

Parameters come from the reference's ``init_moe`` (carried over leaf by
leaf), inputs from numpy seeds. Tolerances: the routing (top-k indices) is
held exactly and its weights at fp32 1e-6; MoE outputs at fp32 1e-4 (the
port gathers each expert's rows and scatter-adds them in fp32, where the
reference sums one-hot einsums: the same terms in another order); the aux
loss at 1e-6. ``quantize_kv`` must give the same int8 values and the same
bf16 scales (both round half to even); ``dequantize_kv`` 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import weights
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _params(jcfg, seed=0, dtype=jnp.float32):
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg,
                                               dtype))
    flat = {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in weights.flatten(p).items()}
    return p, weights.unflatten(flat)


def _x(B, S, d, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


# name -> (MoEConfig fields, B, S)
CASES = {
    "dropless": (dict(d_model=16, d_ff=32, n_experts=4, top_k=2,
                      dropless=True), 2, 12),
    # the reference's test_moe_capacity_drops_tokens
    "capacity_drops": (dict(d_model=8, d_ff=16, n_experts=2, top_k=1,
                            capacity_factor=0.25), 1, 16),
    # per-row capacity: each of 3 rows drops on its own
    "capacity_per_row": (dict(d_model=16, d_ff=24, n_experts=4, top_k=2,
                              capacity_factor=0.5), 3, 16),
    "high_capacity": (dict(d_model=16, d_ff=32, n_experts=4, top_k=2,
                           capacity_factor=16.0), 2, 6),
    "shared": (dict(d_model=16, d_ff=16, n_experts=8, top_k=4, n_shared=2,
                    dropless=True), 2, 10),
    "shared_capacity": (dict(d_model=8, d_ff=16, n_experts=4, top_k=1,
                             n_shared=2, capacity_factor=0.01), 1, 8),
    "shared_d_ff": (dict(d_model=16, d_ff=16, n_experts=4, top_k=2,
                         n_shared=1, shared_d_ff=40), 2, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gating_matches_reference(name):
    fields, B, S = CASES[name]
    jcfg, tcfg = _cfgs(**fields)
    logits = _x(B, S, jcfg.n_experts, seed=5)
    jw, ji, ja = jax.vmap(lambda l: jmoe._top_k_gating(l, jcfg))(
        jnp.asarray(logits))
    tw, ti, ta = tmoe._top_k_gating(torch.from_numpy(logits), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_moe_matches_reference(name):
    fields, B, S = CASES[name]
    jcfg, tcfg = _cfgs(**fields)
    jp, tp = _params(jcfg)
    x = _x(B, S, jcfg.d_model)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (B, S,
                                                            jcfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)


def test_capacity_drops_tokens_per_row():
    """Rows drop on their own: a row routed like another drops the same
    tokens, whatever the other rows hold."""
    fields, B, S = CASES["capacity_drops"]
    _, tcfg = _cfgs(**fields)
    _, tp = _params(_cfgs(**fields)[0])
    x = torch.from_numpy(_x(3, S, tcfg.d_model))
    y, _ = tmoe.apply_moe(tp, x, tcfg)
    alone, _ = tmoe.apply_moe(tp, x[1:2], tcfg)
    norms = y.norm(dim=-1)
    assert float(norms.min()) == 0.0 and float(norms.max()) > 0.0
    torch.testing.assert_close(y[1:2], alone, rtol=0, atol=0)


@pytest.mark.parametrize("dropless", [False, True])
def test_token_chunk_segments_match_reference(dropless):
    """S = 2 x 8192 at a tiny width: routed in two segments, each with its
    own capacity, and the aux loss averaged over them. Dropless is held at
    S = 2 x 64 with ``token_chunk=64`` (the reference's dropless buffers at
    C = 8192 would need gigabytes)."""
    fields = dict(d_model=4, d_ff=8, n_experts=4, top_k=1,
                  capacity_factor=0.5, dropless=dropless)
    S, chunk = (128, 64) if dropless else (2 * 8192, 8192)
    jcfg, tcfg = _cfgs(**fields)
    jp, tp = _params(jcfg)
    x = _x(1, S, 4)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, token_chunk=chunk)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg,
                              token_chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-6)
    # the segments route apart: not the same as one segment of S tokens
    whole, _ = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, token_chunk=S)
    assert dropless == bool(torch.allclose(whole, ty, rtol=1e-5, atol=1e-6))


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


@pytest.mark.parametrize("name", ["dropless", "shared", "capacity_per_row"])
def test_bf16_routing_matches_reference(name):
    """bf16 compute: the router rounded to bf16 (as ``_cast`` does in both
    packages), fp32 logits, the same top-k experts for every token; the
    output within bf16's 2e-2."""
    fields, B, S = CASES[name]
    jcfg, tcfg = _cfgs(**fields)
    jp, tp = _params(jcfg, dtype=jnp.bfloat16)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tp = _bf16(tp)
    x = _x(B, S, jcfg.d_model, seed=7)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jlogits = jnp.einsum("btd,de->bte", jx.astype(jnp.float32), jp["router"])
    _, ji, _ = jax.vmap(lambda l: jmoe._top_k_gating(l, jcfg))(jlogits)
    tlogits = tx.float() @ tp["router"].float()
    _, ti, _ = tmoe._top_k_gating(tlogits, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jy, _ = jmoe.apply_moe(jp, jx, jcfg)
    ty, _ = tmoe.apply_moe(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_init_moe_layout_and_router_dtype():
    jcfg, tcfg = _cfgs(d_model=16, d_ff=8, n_experts=4, top_k=2, n_shared=3)
    ref = weights.flatten(jax.eval_shape(
        lambda k: jmoe.init_moe(k, jcfg, jnp.bfloat16),
        jax.random.PRNGKey(0)))
    own = weights.flatten(tmoe.init_moe(torch.Generator().manual_seed(0),
                                        tcfg, torch.bfloat16))
    assert {p: tuple(a.shape) for p, a in own.items()} == \
        {p: tuple(a.shape) for p, a in ref.items()}
    assert own["router"].dtype == torch.float32 == \
        getattr(torch, str(ref["router"].dtype))
    assert own["w_gate"].dtype == torch.bfloat16
    assert tuple(own["shared/w_up"].shape) == (16, 24)


# --------------------------------------------------------------- int8 KV


def _kv(seed=3):
    x = np.random.default_rng(seed).standard_normal((2, 5, 3, 16)).astype(
        np.float32) * 4.0
    # rows whose quotients land on .5: the scale is 1.0 in fp32 (1 + 1e-8
    # rounds to 1), so these round half to even
    x[0, 0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[0, 0, 0, 6:] = 0.0
    x[1, 1, 1] = 0.0                      # an all-zero row: scale 1e-8
    return x


def test_quantize_kv_matches_reference():
    x = _kv()
    jq, js = jlayers.quantize_kv(jnp.asarray(x))
    tq, ts = tlayers.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))
    assert tq[0, 0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_quantize_kv_bf16_input_matches_reference():
    x = _kv(seed=4)
    jq, js = jlayers.quantize_kv(jnp.asarray(x, jnp.bfloat16))
    tq, ts = tlayers.quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))


def test_dequantize_kv_matches_reference():
    x = _kv()
    jq, js = jlayers.quantize_kv(jnp.asarray(x))
    tq, ts = tlayers.quantize_kv(torch.from_numpy(x))
    jd = jlayers.dequantize_kv(jq, js)
    td = tlayers.dequantize_kv(tq, ts)
    assert td.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), x, rtol=0,
                               atol=float(np.abs(x).max()) / 127)


def test_init_kv_cache_quant_layout():
    jcfg = jlayers.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2,
                              head_dim=8, window=6)
    tcfg = tlayers.AttnConfig(**dataclasses.asdict(jcfg))
    jc = jlayers.init_kv_cache(jcfg, 3, 10, quant=True)
    tc = tlayers.init_kv_cache(tcfg, 3, 10, quant=True)
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale"}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
