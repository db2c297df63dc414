"""The port's flash attention (B1) on the CPU.

The plain version ``flash_attention_reference`` is held against the JAX
Pallas kernel in interpret mode on the sweep of tests/test_kernels.py, two
group sizes of the Hopper kernel's tiles (G = 8 and G = 64, scaled down
from chip_smoke.py's shapes) and recurrentgemma-9b's head_dim 256 with MQA
(K = 1, G = 16, with and without a window), at that file's tolerances:
fp32 2e-5, bf16 2e-2, for out and LSE. The kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there); on CPU
tensors the wrapper runs the plain version.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

SWEEP = [  # tests/test_kernels.py: B, S, K, G, D, causal, window
    (2, 256, 2, 2, 64, True, None),
    (1, 128, 4, 1, 32, True, 48),
    (2, 192, 2, 3, 64, True, None),        # ragged vs block size
    (1, 256, 1, 4, 128, False, None),
    (1, 64, 8, 1, 128, True, 16),
    (1, 100, 2, 8, 128, True, None),       # G = 8, ragged (chip_smoke g8)
    (1, 64, 1, 64, 64, True, None),        # G = 64, B1's widest group
    (1, 64, 1, 16, 256, True, None),       # D = 256, MQA G = 16
    (1, 80, 1, 16, 256, True, 24),         # recurrentgemma-9b, window, ragged
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, K, G, D, T=None, seed=0):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, S, K, G, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,D,causal,window", SWEEP)
def test_reference_matches_pallas_interpret(B, S, K, G, D, causal, window,
                                            dtype):
    q, k, v = _inputs(B, S, K, G, D)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype))
                  for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    j_out, j_lse = pallas_fa(jq, jk, jv, causal=causal, window=window,
                             q_block=64, kv_block=64, interpret=True,
                             return_lse=True)
    t_out, t_lse = fa.flash_attention_reference(tq, tk, tv, causal=causal,
                                                window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert t_out.dtype == tq.dtype and t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               rtol=tol, atol=tol)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 70, 2, 3, 16, T=90))
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, causal=True, window=9,
                                  return_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True,
                                                    window=9)
    assert fa.launches == before == 0
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert torch.equal(fa.flash_attention(q, k, v, causal=True, window=9),
                       out)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, window=0)


def test_ops_refuses_grad_and_runs_without():
    """Under no_grad the op records no graph and saves nothing; with grad it
    differentiates (through B2/B3's plain version on CPU tensors)."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(1, 16, 2, 2, 8))
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and not out.requires_grad
    assert out.grad_fn is None
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(g.shape == t.shape and bool(torch.isfinite(g).all())
               for g, t in zip(grads, (q, k, v)))


def test_build_imports_without_nvcc():
    from repro_torch.kernels import build
    assert "flash_attention" in build.sources()
    lib = build.library_path("flash_attention")
    assert lib.parent == build.BUILD_DIR and lib.name.endswith(".so")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.nvcc()
