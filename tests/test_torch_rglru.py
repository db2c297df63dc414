"""The port's RG-LRU recurrence (B5) on the CPU.

The plain version ``rglru_reference`` is held against
``repro.kernels.ref.rglru_ref`` and a numpy sequential loop, with and
without h0 and with ragged S and R, at 1e-5; ``ops.rglru``'s gradients
against ``jax.vjp`` of ``ref.rglru_ref``, which is the reference op's own
backward. The Pallas B5 is not a comparison here: it does not trace on
jax 0.9 (ROADMAP, faults on the reference side). The CUDA kernel runs only
on the card (``chip_smoke.py``); on CPU tensors the wrapper runs the plain
version and launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.core.groundtruth import KernelConfigDB
from repro_torch.kernels import findb
from repro_torch.kernels import ops
from repro_torch.kernels import rglru

SHAPES = [  # B, S, R: aligned, ragged S and R, one step, odd
    (2, 256, 128),
    (1, 100, 96),
    (3, 1, 33),
    (2, 77, 5),
    # ragged shapes for the plain version: R = 2, 3 (mod 4), S shorter
    # than the chunk, S not a multiple of it, and S = 2047 (the kernel at
    # such shapes is checked on the card, by chip_smoke.py)
    (2, 130, 94),
    (1, 45, 99),
    (2, 20, 7),
    (2, 2047, 6),
]


def _inputs(B, S, R, seed=0):
    rng = np.random.default_rng(seed)
    la = (-np.abs(rng.standard_normal((B, S, R))) * 0.1).astype(np.float32)
    b = rng.standard_normal((B, S, R)).astype(np.float32)
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    return la, b, h0


def _sequential(la, b, h0):
    h = np.zeros(la[:, 0].shape, np.float64) if h0 is None else \
        h0.astype(np.float64)
    out = []
    for t in range(la.shape[1]):
        h = np.exp(la[:, t].astype(np.float64)) * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,R", SHAPES)
def test_reference_matches_oracle_and_loop(B, S, R, with_h0):
    la, b, h0 = _inputs(B, S, R)
    h0 = h0 if with_h0 else None
    want_h, want_last = ref.rglru_ref(
        jnp.asarray(la), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0))
    got_h, got_last = rglru.rglru_scan(
        torch.from_numpy(la), torch.from_numpy(b),
        None if h0 is None else torch.from_numpy(h0), chunk=32, r_block=32)
    assert got_h.dtype == torch.float32 and tuple(got_h.shape) == (B, S, R)
    assert tuple(got_last.shape) == (B, R)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), _sequential(la, b, h0),
                               rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_reads_find_db_and_launches_nothing(monkeypatch):
    la, b, _ = (torch.from_numpy(a) for a in _inputs(1, 64, 16))
    seen = []
    monkeypatch.setattr(rglru, "rglru_reference",
                        lambda *a: seen.append(a) or (a[1], a[1][:, -1]))
    before = rglru.launches
    assert rglru.rglru_scan(la, b)[0] is b
    assert len(seen) == 1 and rglru.launches == before
    # ops.rglru passes chunk/r_block to rglru_scan, which resolves them
    # through the find-db under cpu/cpu
    db = KernelConfigDB()
    db.put("rglru", findb.rglru_shape_key(B=1, S=64, R=16),
           {"chunk": 32, "r_block": 64}, hardware="cpu/cpu")
    resolved = []
    resolve = rglru.resolve_blocks
    monkeypatch.setattr(rglru, "resolve_blocks",
                        lambda *args: resolved.append(resolve(*args))
                        or resolved[-1])
    prev = findb.set_find_db(db)
    try:
        ops.rglru(la, b, None)
        ops.rglru(la, b, None, chunk=8)
    finally:
        findb.set_find_db(prev)
    ops.rglru(la, b, None)
    assert resolved == [(32, 64), (8, 64), (128, 128)]


@pytest.mark.parametrize("with_h0", [False, True])
def test_ops_gradients_match_jax_vjp(with_h0):
    B, S, R = 2, 50, 24
    la, b, h0 = _inputs(B, S, R, seed=1)
    rng = np.random.default_rng(2)
    g_h = rng.standard_normal((B, S, R)).astype(np.float32)
    g_last = rng.standard_normal((B, R)).astype(np.float32)
    primals = [jnp.asarray(la), jnp.asarray(b)] + \
        ([jnp.asarray(h0)] if with_h0 else [])
    _, vjp = jax.vjp(lambda *xs: ref.rglru_ref(*xs), *primals)
    want = vjp((jnp.asarray(g_h), jnp.asarray(g_last)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (la, b, h0)[:len(primals)]]
    h, last = ops.rglru(*leaves, *([] if with_h0 else [None]))
    got = torch.autograd.grad((h, last), leaves,
                              (torch.from_numpy(g_h), torch.from_numpy(g_last)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _launch_rejects(case):
    """(tensors, kwargs of _launch, message) for each shape, config or
    device the kernel's launch refuses before it builds anything."""
    la, b, h0 = (torch.from_numpy(a) for a in _inputs(2, 40, 8))
    meta = torch.empty_like(b, device="meta")
    odd = torch.from_numpy(np.zeros((2, 40, 9), np.float32))
    flat = torch.zeros(2 * 40 * 8 + 1)
    shifted = flat[1:].view(2, 40, 8)           # 4 bytes off 16-byte aligned
    return {
        "devices": ((la, meta, None), dict(chunk=32, r_block=8),
                    "one device"),
        "h0_device": ((la, b, h0.to("meta")), dict(chunk=32, r_block=8),
                      "one device"),
        "r_block_0": ((la, b, None), dict(chunk=32, r_block=0), "1..1024"),
        "r_block_1025": ((la, b, None), dict(chunk=32, r_block=1025),
                         "1..1024"),
        "cpu": ((la, b, h0), dict(chunk=32, r_block=8), "CUDA tensors"),
        "cpu_ragged_R": ((odd, odd, None), dict(chunk=32, r_block=9),
                         "CUDA tensors"),
        "cpu_unaligned": ((shifted, b, None), dict(chunk=32, r_block=8),
                          "CUDA tensors"),
    }[case]


@pytest.mark.parametrize("case", [
    "devices", "h0_device", "r_block_0", "r_block_1025", "cpu",
    "cpu_ragged_R", "cpu_unaligned"])
def test_kernel_launch_rejects_before_building(case, monkeypatch):
    """What the kernel cannot take raises before the library is built or
    anything is launched: mixed devices, r_block outside 1..1024, and
    tensors that are not on the card, whatever their R or alignment."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"built {name} for a launch that must be refused"))
    tensors, kw, msg = _launch_rejects(case)
    before = rglru.launches
    with pytest.raises(ValueError, match=msg):
        rglru._launch(*tensors, **kw)
    assert rglru.launches == before


@pytest.mark.parametrize("r_block", [0, 1025])
def test_plan_refuses_r_block_outside_a_block(r_block, monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"built {name} for a plan that must be refused"))
    with pytest.raises(ValueError, match="1..1024"):
        rglru.plan(64, 4096, 32, r_block)
