"""The port's flash attention (B1) on the CPU.

The plain version ``flash_attention_reference`` is held against the JAX
Pallas kernel in interpret mode on the sweep of tests/test_kernels.py, two
group sizes of the Hopper kernel's tiles (G = 8 and G = 64, scaled down
from chip_smoke.py's shapes) and recurrentgemma-9b's head_dim 256 with MQA
(K = 1, G = 16, with and without a window), at that file's tolerances:
fp32 2e-5, bf16 2e-2, for out and LSE. The kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there); on CPU
tensors the wrapper runs the plain version, with the resolved tiles as its
chunks. The tiles: every plan of each set (fp32 and bf16, head dim up to
128 and 256) through the wrapper with explicit ``q_block``/``kv_block``
against the Pallas kernel at the same blocks (fp32 2e-5, bf16 2e-2); a
pair outside the set raises on the CPU and on meta tensors; a find-db row
under ``cpu/cpu`` reaches the plain version's chunks through the wrapper
and through ``ops``, the forward's and the backward's rows separately; the
fp32 shape key is the reference's and the bf16 key is not.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels import findb as jfindb
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.core.groundtruth import KernelConfigDB
from repro_torch.kernels import findb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fa_bwd
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
    # no find-db row: the fp32 kernel's default plan, as the plain
    # version's chunks
    tiles = findb.flash_attention_defaults("B1", torch.float32, 16)
    assert tiles == {"q_block": 32, "kv_block": 32}
    ref_out, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=True, window=9, q_chunk=32, kv_chunk=32)
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


# every plan of each set: (dtype, head_dim, q_block, kv_block)
PLANS = [(dt, D, qb, kb)
         for dt, D in (("float32", 64), ("float32", 256), ("bfloat16", 64),
                       ("bfloat16", 256))
         for qb, kb in findb.flash_attention_plans(getattr(torch, dt), D)]


@pytest.mark.parametrize("dtype,D,q_block,kv_block", PLANS)
def test_every_plan_matches_pallas_at_its_blocks(dtype, D, q_block,
                                                 kv_block):
    """The wrapper at an explicit plan against the Pallas kernel at the
    same blocks: ragged S, T != S, a window and G = 3."""
    B, S, T, K, G, window = 1, 70, 90, 2, 3, 40
    if D == 256:
        S, T, K, G = 50, 50, 1, 4
    q, k, v = _inputs(B, S, K, G, D, T=T, seed=3)
    j_out, j_lse = pallas_fa(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                               for a in (q, k, v)), causal=True,
                             window=window, q_block=q_block,
                             kv_block=kv_block, interpret=True,
                             return_lse=True)
    t_out, t_lse = fa.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=True, window=window, q_block=q_block, kv_block=kv_block,
        return_lse=True)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype,D,q_block,kv_block", [
    ("float32", 64, 64, 32), ("float32", 64, 32, 64),
    ("float32", 256, 32, 32), ("bfloat16", 128, 128, 32),
    ("bfloat16", 128, 256, 128), ("bfloat16", 256, 128, 64)])
def test_a_pair_outside_the_plans_raises(dtype, D, q_block, kv_block,
                                         device):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).to(device)
               for a in _inputs(1, 8, 2, 2, D))
    with pytest.raises(ValueError, match="plans there"):
        fa.flash_attention(q, k, v, q_block=q_block, kv_block=kv_block)
    do = q.clone()
    out, lse = torch.zeros_like(q), torch.zeros(q.shape[:4], device=device)
    with pytest.raises(ValueError, match="plans there"):
        fa_bwd.flash_attention_bwd(q, k, v, out, lse, do, q_block=q_block,
                                   kv_block=kv_block)


def test_meta_tensors_validate_and_report_the_same_work():
    from repro_torch.analysis import cost
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in ((2, 64, 2, 2, 128), (2, 64, 2, 128),
                         (2, 64, 2, 128)))
    works = []
    for qb, kb in findb.flash_attention_plans(torch.bfloat16, 128):
        with cost.CostMode() as cm:
            out = fa.flash_attention(q, k, v, q_block=qb, kv_block=kb)
        assert out.device.type == "meta" and out.shape == q.shape
        works.append(cm.cost.kernels["B1"])
    assert works[0]["calls"] == 1 and works[0]["flops"] > 0
    assert all(w == works[0] for w in works)


@pytest.fixture
def cpu_row_db():
    """A fresh find-db, swapped in for one test."""
    db = KernelConfigDB()
    prev = findb.set_find_db(db)
    yield db
    findb.set_find_db(prev)


def test_find_db_rows_reach_the_plain_chunks(cpu_row_db, monkeypatch):
    """A ``cpu/cpu`` row picks the plain version's chunks, through the
    wrapper and through ops (forward and backward); the forward's row and
    the backward's resolve separately, and an explicit value wins."""
    B, S, K, G, D = 1, 40, 2, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, K, G, D))
    key = findb.attention_shape_key(B=B, S=S, K=K, G=G, D=D, T=S,
                                    causal=True, window=None,
                                    dtype=q.dtype)
    cpu_row_db.put("flash_attention", key, {"q_block": 32, "kv_block": 16},
                   hardware="cpu/cpu")
    cpu_row_db.put("flash_attention", key, {"q_block": 32, "kv_block": 32},
                   hardware="cuda/nvidia_h100_80gb_hbm3")
    seen = []
    plain = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference", lambda *a, **kw: (
        seen.append(("B1", kw["q_chunk"], kw["kv_chunk"])) or
        plain(*a, **kw)))
    for name in ("dq_reference", "dkv_reference"):
        ref = getattr(fa_bwd, name)
        monkeypatch.setattr(fa_bwd, name, lambda *a, _n=name, _r=ref, **kw: (
            seen.append((_n, kw["q_chunk"], kw["kv_chunk"])) or
            _r(*a, **kw)))
    fa.flash_attention(q, k, v)
    fa.flash_attention(q, k, v, kv_block=32)
    assert seen == [("B1", 32, 16), ("B1", 32, 32)]
    # ops: the forward's row, then no backward row: the kernels' defaults
    seen.clear()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(ops.flash_attention(*leaves).sum(), leaves)
    assert seen == [("B1", 32, 16), ("dq_reference", 32, 32),
                    ("dkv_reference", 32, 32)]
    # the backward's own row (the port's fp32 backward has one plan)
    cpu_row_db.put("flash_attention_bwd", key,
                   {"q_block": 32, "kv_block": 32}, hardware="cpu/cpu")
    assert fa_bwd.resolve_tiles(q, k) == {"dq": (32, 32), "dkv": (32, 32)}
    # bf16: the keys differ, so the fp32 rows are not read
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    seen.clear()
    fa.flash_attention(qb, kb, vb)
    assert seen == [("B1", 128, 128)]
    bkey = findb.attention_shape_key(B=B, S=S, K=K, G=G, D=D, T=S,
                                     causal=True, window=None,
                                     dtype=qb.dtype)
    cpu_row_db.put("flash_attention_bwd", bkey,
                   {"q_block": 64, "kv_block": 64}, hardware="cpu/cpu")
    assert fa_bwd.resolve_tiles(qb, kb) == {"dq": (64, 64), "dkv": (64, 64)}
    cpu_row_db.put("flash_attention_bwd", bkey, {}, hardware="cpu/cpu")
    assert fa_bwd.resolve_tiles(qb, kb) == {"dq": (128, 64),
                                            "dkv": (64, 64)}
    assert fa_bwd.resolve_tiles(qb, kb, q_block=128) == {
        "dq": (128, 64), "dkv": (128, 64)}


def test_fp32_shape_key_is_the_references_and_bf16_differs():
    dims = dict(B=2, S=64, K=2, G=3, D=32, T=80, causal=True, window=16)
    ref = jfindb.attention_shape_key(**dims)
    assert findb.attention_shape_key(**dims) == ref
    assert findb.attention_shape_key(**dims, dtype=torch.float32) == ref
    bf16 = findb.attention_shape_key(**dims, dtype=torch.bfloat16)
    assert bf16 != ref and bf16 == findb.attention_shape_key(
        **dims, dtype="bf16")
    assert "dtype=bf16" in bf16.split(",")
