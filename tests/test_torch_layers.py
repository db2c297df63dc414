"""repro_torch.models.layers against repro.models.layers, fp32 on the CPU.

Inputs come from numpy with a fixed seed and go to both packages. The
tolerance is 1e-5 (fp32; the two frameworks sum in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _acfg(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True,
                rope_theta=1e6)
    base.update(kw)
    return jl.AttnConfig(**base), tl.AttnConfig(**base)


def _attn_params(rng, cfg):
    K, G, D, d = cfg.n_kv_heads, cfg.groups, cfg.head_dim, cfg.d_model
    p = {"wq": _rand(rng, d, K, G, D) / np.sqrt(d),
         "wk": _rand(rng, d, K, D) / np.sqrt(d),
         "wv": _rand(rng, d, K, D) / np.sqrt(d),
         "wo": _rand(rng, K, G, D, d) / np.sqrt(K * G * D),
         "q_norm": {"scale": 1 + 0.1 * _rand(rng, D)},
         "k_norm": {"scale": 1 + 0.1 * _rand(rng, D)}}
    p = {k: (v if isinstance(v, dict) else v.astype(np.float32))
         for k, v in p.items()}
    to_j = lambda t: ({k: to_j(v) for k, v in t.items()}
                      if isinstance(t, dict) else jnp.asarray(t))
    to_t = lambda t: ({k: to_t(v) for k, v in t.items()}
                      if isinstance(t, dict) else torch.from_numpy(t))
    return to_j(p), to_t(p)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 2, 5, 32), 1 + 0.1 * _rand(rng, 32)
    _close(tl.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x)),
           jl.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_adjacent_pairs(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 2, 3, 16)
    pos = rng.integers(0, 64, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_attention_qkv_qk_norm():
    rng = np.random.default_rng(2)
    jc, tc = _acfg()
    pj, pt = _attn_params(rng, jc)
    x = _rand(rng, 2, 9, jc.d_model)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0)
    outs_t = tl.attention_qkv(pt, torch.from_numpy(x), tc,
                              torch.from_numpy(pos))
    outs_j = jl.attention_qkv(pj, jnp.asarray(x), jc, jnp.asarray(pos))
    for t, j in zip(outs_t, outs_j):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
@pytest.mark.parametrize("fn", ["attention", "chunked_attention"])
def test_attention_paths(fn, causal, window):
    rng = np.random.default_rng(3)
    q = _rand(rng, 2, 40, 2, 2, 8)
    k, v = _rand(rng, 2, 40, 2, 8), _rand(rng, 2, 40, 2, 8)
    kw = dict(causal=causal, window=window)
    if fn == "chunked_attention":
        kw.update(q_chunk=16, kv_chunk=16)           # ragged: 40 = 2.5 chunks
    t = getattr(tl, fn)(*map(torch.from_numpy, (q, k, v)), **kw)
    j = getattr(jl, fn)(*map(jnp.asarray, (q, k, v)), **kw)
    _close(t, j)


def test_apply_swiglu():
    rng = np.random.default_rng(4)
    p = {"w_gate": _rand(rng, 32, 48) / 6, "w_up": _rand(rng, 32, 48) / 6,
         "w_down": _rand(rng, 48, 32) / 7}
    x = _rand(rng, 2, 5, 32)
    _close(tl.apply_swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x)),
           jl.apply_swiglu({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x)))


@pytest.mark.parametrize("window", [None, 6])
def test_apply_attention_decode_ring(window):
    """Ten decode steps into a bf16 cache; with window 6 the ring wraps.

    Both packages round the new k/v row to bf16 for the cache. An fp32
    difference in the last place could round a cached value to the
    neighbouring bf16, so the caches are compared at one bf16 step (2**-7
    relative); the outputs at the fp32 tolerance.
    """
    rng = np.random.default_rng(5)
    jc, tc = _acfg(window=window)
    pj, pt = _attn_params(rng, jc)
    cj = jl.init_kv_cache(jc, 2, 10)
    ct = tl.init_kv_cache(tc, 2, 10)
    assert tuple(ct["k"].shape) == cj["k"].shape
    for pos in range(10):
        x = _rand(rng, 2, 1, jc.d_model)
        oj, cj = jl.apply_attention_decode(pj, jnp.asarray(x), jc, cj, pos)
        ot, ct = tl.apply_attention_decode(pt, torch.from_numpy(x), tc, ct,
                                           pos)
        _close(ot, oj)
        for name in ("k", "v"):
            assert ct[name].dtype == torch.bfloat16
            _close(ct[name], cj[name], rtol=2 ** -7, atol=1e-6)
