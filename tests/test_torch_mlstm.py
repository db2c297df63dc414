"""The port's chunkwise mLSTM (B4) on the CPU.

The plain version ``mlstm_chunkwise_reference`` is held against the JAX
Pallas kernel in interpret mode (as tests/test_kernels.py runs it) and
against ``repro.kernels.ref.mlstm_ref`` with and without a carried state,
at fp32 1e-4 and bf16 2e-2 of the output's largest value. ``ops.mlstm``'s
gradients are held against ``jax.grad`` through the reference's
``ops.mlstm`` at 1e-4. The CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against the plain version; on CPU tensors the
wrapper runs the plain version and launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mlstm as pallas_mlstm
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core.groundtruth import KernelConfigDB
from repro_torch.kernels import findb
from repro_torch.kernels import mlstm
from repro_torch.kernels import ops

SWEEP = [  # tests/test_kernels.py: B, S, H, D, chunk
    (2, 256, 2, 64, 64),
    (1, 128, 4, 32, 32),
    (2, 512, 1, 128, 128),
]


def _inputs(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,H,D,chunk", SWEEP)
def test_reference_matches_pallas_interpret(B, S, H, D, chunk, dtype, tol):
    arrs = _inputs(B, S, H, D)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in arrs[:3])
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs[:3])
    want = pallas_mlstm.mlstm_chunkwise(jq, jk, jv, *map(jnp.asarray,
                                                         arrs[3:]),
                                        chunk=chunk, interpret=True)
    got = mlstm.mlstm_chunkwise_reference(
        tq, tk, tv, *map(torch.from_numpy, arrs[3:]), chunk=chunk)[0]
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_reference_matches_oracle_and_state(with_state):
    B, S, H, D, chunk = 2, 128, 2, 32, 32
    arrs = _inputs(B, S, H, D, seed=1)
    state = None
    if with_state:
        rng = np.random.default_rng(2)
        state = (rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.1,
                 rng.standard_normal((B, H, D)).astype(np.float32) * 0.1,
                 rng.standard_normal((B, H)).astype(np.float32))
    jh, (jC, jn, jm) = ref.mlstm_ref(
        *map(jnp.asarray, arrs), chunk=chunk,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    th, (tC, tn, tm) = mlstm.mlstm_chunkwise_reference(
        *map(torch.from_numpy, arrs), chunk=chunk,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    for got, want in ((th, jh), (tC, jC), (tn, jn), (tm, jm)):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got.numpy(), np.asarray(want), 1e-4)


def test_chunk_invariance():
    """Output must not depend on the chunk size (tests/test_kernels.py)."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 256, 2, 64, seed=3)]
    h64 = mlstm.mlstm_chunkwise(*arrs, chunk=64)
    h128 = mlstm.mlstm_chunkwise(*arrs, chunk=128)
    np.testing.assert_allclose(h64.numpy(), h128.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_seq_not_divisible_by_chunk_raises():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 96, 1, 16)]
    with pytest.raises(ValueError, match="divisible"):
        mlstm.mlstm_chunkwise(*arrs, chunk=64)
    with pytest.raises(ValueError, match="divisible"):
        ops.mlstm(*arrs, chunk=64)
    with pytest.raises(AssertionError):            # the reference asserts
        pallas_mlstm.mlstm_chunkwise(*map(jnp.asarray, _inputs(1, 96, 1, 16)),
                                     chunk=64, interpret=True)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 4), (torch.float16, 12),
                                     (torch.float32, 2)])
def test_kernel_launch_rejects_rows_tma_cannot_load(dtype, D):
    """The kernel's TMA loads need head rows of a multiple of 16 bytes: the
    launch raises before it builds or launches anything."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 64, 2, D)]
    q, k, v = (x.to(dtype) for x in arrs[:3])
    before = mlstm.launches
    with pytest.raises(ValueError, match="16 bytes"):
        mlstm._launch(q, k, v, arrs[3], arrs[4], 32)
    assert mlstm.launches == before


def test_cpu_wrapper_runs_plain_version_and_reads_find_db(monkeypatch):
    arrs = [torch.from_numpy(a) for a in _inputs(1, 128, 2, 16)]
    seen = []
    plain = mlstm.mlstm_chunkwise_reference

    def spy(*args, chunk, **kw):
        seen.append(chunk)
        return plain(*args, chunk=chunk, **kw)

    monkeypatch.setattr(mlstm, "mlstm_chunkwise_reference", spy)
    db = KernelConfigDB()
    db.put("mlstm", findb.mlstm_shape_key(B=1, S=128, H=2, D=16),
           {"chunk": 32}, hardware="cpu/cpu")
    prev = findb.set_find_db(db)
    before = mlstm.launches
    try:
        mlstm.mlstm_chunkwise(*arrs)
        ops.mlstm(*arrs)
        mlstm.mlstm_chunkwise(*arrs, chunk=64)      # explicit wins
    finally:
        findb.set_find_db(prev)
    ops.mlstm(*arrs)                                # miss: the default
    assert seen == [32, 32, 64, 128]
    assert mlstm.launches == before


def test_ops_gradients_match_jax():
    B, S, H, D, chunk = 1, 64, 2, 16, 32
    arrs = _inputs(B, S, H, D, seed=4)
    g = np.random.default_rng(5).standard_normal((B, S, H, D)).astype(
        np.float32)

    def jloss(q, k, v, ig, fg):
        h = jops.mlstm(q, k, v, ig, fg, chunk=chunk, interpret=True)
        return jnp.sum(h * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    h = ops.mlstm(*leaves, chunk=chunk)
    got = torch.autograd.grad(h, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a.numpy(), np.asarray(b), 1e-4)
