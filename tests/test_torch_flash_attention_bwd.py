"""The port's flash-attention backward (B2, B3) and its autograd op on the CPU.

``flash_attention_bwd_reference`` is held against the JAX Pallas backward
kernels in interpret mode on one set of inputs (q, k, v, dO and the forward's
out and LSE, from the JAX forward kernel), sweeping causal, window,
non-causal, ragged S, S != T, G in {1, 3, 8, 16, 80} and D = 40 (G = 8 and
G = 80 are chip_smoke.py's edge cases of the Hopper tiles, scaled down) and
D = 256 at K = 1, G = 16 (recurrentgemma-9b's attention, with and without
its window, scaled down).
Tolerances: fp32 1e-4 (tests/test_kernels.py's fused-backward test), bf16
2e-2. The port's differentiable ``ops.flash_attention`` is held against
``jax.grad`` of the reference's ``ops.flash_attention`` (backward through the
jnp oracle) and ``ops.flash_attention_fused`` (backward through the Pallas
kernels) in fp32 at 1e-4. Every pair of the backward's plan sets runs
through the wrapper with explicit ``q_block``/``kv_block`` against the Pallas
backward at the same blocks (fp32 1e-4, bf16 2e-2), and through ``ops``
with the same pair given to the forward and the backward. The CUDA kernels
run only on the card
(``chip_smoke.py`` holds them against the plain version there); CPU tensors
take the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.flash_attention_bwd import flash_attention_bwd as pallas_bwd
from repro_torch.kernels import findb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fa_bwd
from repro_torch.kernels import ops

SWEEP = [  # B, S, T, K, G, D, causal, window
    (1, 64, 64, 2, 2, 32, True, None),
    (1, 64, 64, 2, 1, 32, True, 16),       # window, G = 1
    (1, 48, 48, 1, 3, 40, False, None),    # non-causal, G = 3, D = 40
    (2, 50, 50, 2, 2, 16, True, None),     # ragged against the 32 block
    (1, 40, 72, 1, 3, 40, True, 24),       # S != T, window, G = 3, D = 40
    (1, 50, 50, 2, 8, 64, True, None),     # G = 8, ragged (chip_smoke g8)
    (1, 32, 32, 1, 80, 32, True, None),    # G > 64: B3 walks head blocks
    (1, 48, 48, 1, 16, 256, True, None),   # D = 256, MQA G = 16
    (1, 40, 40, 1, 16, 256, True, 16),     # recurrentgemma-9b, window
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, T, K, G, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, G, D)).astype(np.float32))


def _np(a):
    return np.array(a.float() if isinstance(a, torch.Tensor) else a,
                    np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,K,G,D,causal,window", SWEEP)
def test_reference_matches_pallas_interpret(B, S, T, K, G, D, causal,
                                            window, dtype):
    jq, jk, jv, jdo = (jnp.asarray(a).astype(getattr(jnp, dtype))
                       for a in _inputs(B, S, T, K, G, D))
    j_out, j_lse = pallas_fa(jq, jk, jv, causal=causal, window=window,
                             q_block=32, kv_block=32, interpret=True,
                             return_lse=True)
    j_grads = pallas_bwd(jq, jk, jv, j_out, j_lse, jdo, causal=causal,
                         window=window, q_block=32, kv_block=32,
                         interpret=True)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo, t_out = (torch.from_numpy(_np(a)).to(tdt)
                              for a in (jq, jk, jv, jdo, j_out))
    t_grads = fa_bwd.flash_attention_bwd_reference(
        tq, tk, tv, t_out, torch.from_numpy(_np(j_lse)), tdo, causal=causal,
        window=window, q_chunk=32, kv_chunk=32)
    for t, j in zip(t_grads, j_grads):
        assert t.dtype == tdt and tuple(t.shape) == j.shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("jax_op", ["flash_attention",
                                    "flash_attention_fused"])
@pytest.mark.parametrize("B,S,T,K,G,D,causal,window", SWEEP[1:3])
def test_op_grad_matches_jax(B, S, T, K, G, D, causal, window, jax_op):
    q, k, v, co = _inputs(B, S, T, K, G, D, seed=1)
    fn = getattr(jops, jax_op)
    j_grads = jax.grad(
        lambda q, k, v: (fn(q, k, v, causal, window, 32, 32, True)
                         * co).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss = (ops.flash_attention(tq, tk, tv, causal, window)
            * torch.from_numpy(co)).sum()
    t_grads = torch.autograd.grad(loss, (tq, tk, tv))
    for t, j in zip(t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_cpu_backward_counts_no_launch_and_matches_reference():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 30, 30, 2, 3, 16))
    out, lse = fa.flash_attention(q, k, v, causal=True, window=9,
                                  return_lse=True)
    before = (fa_bwd.launches_dq, fa_bwd.launches_dkv)
    got = fa_bwd.flash_attention_bwd(q, k, v, out, lse,
                                     do.transpose(0, 1).contiguous()
                                     .transpose(0, 1), causal=True, window=9)
    ref = fa_bwd.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                               causal=True, window=9)
    assert (fa_bwd.launches_dq, fa_bwd.launches_dkv) == before == (0, 0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_backward_rejects_bad_inputs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 2, 16))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        fa_bwd.flash_attention_bwd(q, k[:, :, :1], v[:, :, :1], out, lse, do)
    with pytest.raises(ValueError):
        fa_bwd.flash_attention_bwd(q, k, v, out[:, :4], lse, do)
    with pytest.raises(ValueError):
        fa_bwd.flash_attention_bwd(q, k, v, out, lse, do, window=0)
    with pytest.raises(ValueError):
        fa_bwd.flash_attention_bwd(q, k, v, out, lse, do.to("meta"))


# every pair of the backward's plan sets: (dtype, head_dim, q_block, kv_block)
PLANS = [(dt, D, qb, kb)
         for dt, D in (("float32", 64), ("float32", 256), ("bfloat16", 64),
                       ("bfloat16", 256))
         for qb, kb in findb.flash_attention_bwd_plans(getattr(torch, dt), D)]


@pytest.mark.parametrize("dtype,D,q_block,kv_block", PLANS)
def test_every_plan_matches_pallas_at_its_blocks(dtype, D, q_block,
                                                 kv_block):
    """B2 and B3 at an explicit pair against the Pallas backward at the
    same blocks: ragged S, T != S, a window and G = 3 (MQA, G = 4 at
    D = 256)."""
    B, S, T, K, G, window = 1, 70, 90, 2, 3, 40
    if D == 256:
        S, T, K, G = 40, 40, 1, 4
    jq, jk, jv, jdo = (jnp.asarray(a).astype(getattr(jnp, dtype))
                       for a in _inputs(B, S, T, K, G, D, seed=5))
    j_out, j_lse = pallas_fa(jq, jk, jv, causal=True, window=window,
                             q_block=32, kv_block=32, interpret=True,
                             return_lse=True)
    j_grads = pallas_bwd(jq, jk, jv, j_out, j_lse, jdo, causal=True,
                         window=window, q_block=q_block, kv_block=kv_block,
                         interpret=True)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo, t_out = (torch.from_numpy(_np(a)).to(tdt)
                              for a in (jq, jk, jv, jdo, j_out))
    t_grads = fa_bwd.flash_attention_bwd(
        tq, tk, tv, t_out, torch.from_numpy(_np(j_lse)), tdo, causal=True,
        window=window, q_block=q_block, kv_block=kv_block)
    for t, j in zip(t_grads, j_grads):
        assert t.dtype == tdt and tuple(t.shape) == j.shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("q_block,kv_block", [(32, 32)])
def test_op_grad_at_explicit_tiles_matches_jax(q_block, kv_block):
    """ops hands explicit tiles to B1 and to B2/B3, as the reference's op
    does: fp32 gradients against jax.grad of the fused op at 1e-4."""
    B, S, T, K, G, D, causal, window = SWEEP[1]
    q, k, v, co = _inputs(B, S, T, K, G, D, seed=2)
    j_grads = jax.grad(
        lambda q, k, v: (jops.flash_attention_fused(
            q, k, v, causal, window, q_block, kv_block, True) * co).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    loss = (ops.flash_attention(tq, tk, tv, causal, window, q_block,
                                kv_block) * torch.from_numpy(co)).sum()
    t_grads = torch.autograd.grad(loss, (tq, tk, tv))
    for t, j in zip(t_grads, j_grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
