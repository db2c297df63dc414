"""The port's checkpoint manager against the reference's, on the CPU.

The port's mirrors of ``tests/test_checkpoint.py`` (round trip, digest
fault, keep-N, async, empty restore, resume equivalence), then the two
packages side by side on reduced qwen3-0.6b, whose train state comes from
the reference's ``make_train_state`` through ``weights.state_from_jax``:
the same state saved by both gives equal manifests (``treedef`` apart) and
byte-identical leaf files, a checkpoint of either restores in the other, and
a JAX run resumed in the port matches JAX's straight run at fp32 1e-4 (the
tolerance of ``tests/test_torch_train.py``). A bf16 leaf round-trips in the
port; the reference's own ``load_pytree`` cannot read one (ROADMAP.md §C),
which a test records without touching the reference.
"""
import filecmp
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 4, 20


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.zeros(4)},
            "opt": {"m": {"w": torch.ones(8, 4), "b": torch.zeros(4)}},
            "step": 7}


def _meta(tree):
    return tree_map(lambda x: x.to("meta") if torch.is_tensor(x) else x,
                    tree)


def _assert_trees_equal(a, b):
    assert weights.flatten(a).keys() == weights.flatten(b).keys()
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        else:
            assert type(x) is type(y) and x == y


# ------------------------------------------------ mirrors of the reference

def test_roundtrip(tmp_path):
    s = _state()
    d = str(tmp_path / "ck")
    tckpt.save_pytree(s, d)
    s2 = tckpt.load_pytree(d, _meta(s), device="cpu")
    _assert_trees_equal(s, s2)
    assert list(s2) == list(s)          # the target's own key order


def test_digest_detects_corruption(tmp_path):
    s = _state()
    d = str(tmp_path / "ck")
    tckpt.save_pytree(s, d)
    victim = os.path.join(d, "leaf_00000.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="digest mismatch"):
        tckpt.load_pytree(d, _meta(s), device="cpu")


@pytest.mark.parametrize("fault", ["count", "shape", "path"])
def test_structure_mismatch_raises(tmp_path, fault):
    s = _state()
    d = str(tmp_path / "ck")
    tckpt.save_pytree(s, d)
    like = _meta(s)
    if fault == "count":
        del like["opt"]
    elif fault == "shape":
        like["params"]["w"] = torch.empty(4, 8, device="meta")
    else:
        like["params"]["c"] = like["params"].pop("b")
    with pytest.raises(ValueError):
        tckpt.load_pytree(d, like, device="cpu")


def test_manager_keep_n_and_latest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2, async_writes=False)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step), metadata={"epoch": step})
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    tree, meta = mgr.restore(_meta(_state()), device="cpu")
    assert meta["epoch"] == 4
    _assert_trees_equal(tree, _state(4))


def test_manager_async(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=3, async_writes=True)
    for step in (1, 2, 3):
        mgr.save(step, _state(step))
    mgr.wait()
    assert mgr.steps() == [1, 2, 3]


def test_async_writer_error_is_raised_on_wait(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), async_writes=True)
    mgr.save(1, {"x": 1.5})             # a float leaf is not in the format
    with pytest.raises(TypeError, match="tensor or an int"):
        mgr.wait()


def test_save_snapshots_before_in_place_updates(tmp_path):
    """The train step updates tensors in place: what is written is the
    tree as it was when save() returned."""
    mgr = tckpt.CheckpointManager(str(tmp_path), async_writes=True)
    s = _state()
    want = tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, s)
    mgr.save(1, s)
    with torch.no_grad():
        for t in tree_leaves(s["params"]) + tree_leaves(s["opt"]):
            t.add_(1.0)
    mgr.wait()
    tree, _ = mgr.restore(_meta(s), device="cpu")
    _assert_trees_equal(tree, want)


def test_restore_none_when_empty(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), async_writes=False)
    assert mgr.restore(_meta(_state()), device="cpu") == (None, None)


def test_restore_needs_a_device_or_the_card(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    tckpt.save_pytree(_state(), d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.load_pytree(d, _meta(_state()))


def test_resume_training_equivalence(tmp_path):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2."""
    cfg = tconfigs.get_reduced("qwen3-0.6b")
    opt = topt.adamw(1e-3)
    step = tsteps.make_train_step(cfg, TT.SystemConfig(), opt)
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab, (2, 16)))
    batch = {"tokens": toks, "labels": toks}

    def fresh():
        return tsteps.make_train_state(torch.Generator().manual_seed(0), cfg,
                                       opt, "cpu")
    s_a = fresh()
    for _ in range(4):
        s_a, _ = step(s_a, batch)
    s_b = fresh()
    for _ in range(2):
        s_b, _ = step(s_b, batch)
    d = str(tmp_path / "ck")
    tckpt.save_pytree(s_b, d)
    s_c = tckpt.load_pytree(d, _meta(s_b), device="cpu")
    assert s_c["step"] == 2
    for _ in range(2):
        s_c, _ = step(s_c, batch)
    _assert_trees_equal(s_a, s_c)


# ------------------------------------------------------ across the packages

def _systems():
    kw = dict(precision="fp32", q_chunk=16, kv_chunk=16)
    return JT.SystemConfig(**kw), TT.SystemConfig(**kw)


def _optimizers():
    return (jopt.adamw(jopt.warmup_cosine(1e-2, 2, 10), weight_decay=0.01),
            topt.adamw(topt.warmup_cosine(1e-2, 2, 10), weight_decay=0.01))


def _batches(vocab, n):
    rng = np.random.default_rng(30)
    return [(rng.integers(0, vocab, (B, S)).astype(np.int32),
             rng.integers(0, vocab, (B, S)).astype(np.int32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def reduced():
    """(JAX cfg, port cfg, JAX step fn, port step fn, JAX state after one
    step, the batches)."""
    jcfg = jconfigs.get_reduced("qwen3-0.6b")
    tcfg = tconfigs.get_reduced("qwen3-0.6b")
    jsys, tsys = _systems()
    jo, to = _optimizers()
    jstep = jax.jit(jsteps.make_train_step(jcfg, jsys, jo, mesh=None))
    tstep = tsteps.make_train_step(tcfg, tsys, to)
    batches = _batches(jcfg.vocab, 4)
    state = jsteps.make_train_state(jax.random.PRNGKey(0), jcfg, jo)
    state, _ = jstep(state, _jbatch(batches[0]))
    return jcfg, tcfg, jstep, tstep, state, batches


def _jbatch(b):
    return {"tokens": jnp.asarray(b[0]), "labels": jnp.asarray(b[1])}


def _tbatch(b):
    return {"tokens": torch.from_numpy(b[0]).long(),
            "labels": torch.from_numpy(b[1]).long()}


def _port_state(jstate, tcfg):
    return weights.state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                  "cpu")


def _assert_close_to_jax(tstate, jstate, **tol):
    jflat = weights.flatten(jax.tree.map(np.asarray, jstate))
    tflat = weights.flatten(tstate)
    assert jflat.keys() == tflat.keys()
    for path, t in tflat.items():
        np.testing.assert_allclose(np.asarray(t), jflat[path],
                                   err_msg=path, **(tol or TOL))


def test_both_packages_write_the_same_files(tmp_path, reduced):
    _, tcfg, _, _, jstate, _ = reduced
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_pytree(jstate, jd)
    tckpt.save_pytree(_port_state(jstate, tcfg), td)
    jm = json.load(open(os.path.join(jd, "manifest.json")))
    tm = json.load(open(os.path.join(td, "manifest.json")))
    assert jm.pop("treedef") != tm.pop("treedef")
    assert jm == tm
    assert len(jm["leaves"]) == 40 and jm["leaves"][-1]["path"] == "step"
    assert jm["leaves"][-1]["dtype"] == "int32"
    names = [rec["file"] for rec in jm["leaves"]]
    match, mismatch, errors = filecmp.cmpfiles(jd, td, names, shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == 40


def test_jax_checkpoint_restores_in_port(tmp_path, reduced):
    _, tcfg, _, _, jstate, _ = reduced
    d = str(tmp_path / "ck")
    jckpt.save_pytree(jstate, d)
    like = _meta(tsteps.make_train_state(
        torch.Generator().manual_seed(0), tcfg, _optimizers()[1], "cpu"))
    tstate = tckpt.load_pytree(d, like, device="cpu")
    assert tstate["step"] == 1 and isinstance(tstate["step"], int)
    _assert_close_to_jax(tstate, jstate, rtol=0, atol=0)


def test_port_checkpoint_restores_in_jax(tmp_path, reduced):
    _, tcfg, _, _, jstate, _ = reduced
    d = str(tmp_path / "ck")
    tckpt.save_pytree(_port_state(jstate, tcfg), d)
    back = jckpt.load_pytree(d, jax.eval_shape(lambda: jstate))
    assert back["step"].dtype == jnp.int32 and int(back["step"]) == 1
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_run_resumed_in_port_matches_straight_run(tmp_path, reduced):
    """JAX trains 2 steps and saves; the port restores and trains 2 more;
    JAX's 4 straight steps agree at fp32 1e-4."""
    _, tcfg, jstep, tstep, jstate1, batches = reduced
    j2, _ = jstep(jstate1, _jbatch(batches[1]))
    d = str(tmp_path / "ck")
    jckpt.save_pytree(j2, d)
    like = _meta(_port_state(jstate1, tcfg))
    tstate = tckpt.load_pytree(d, like, device="cpu")
    assert tstate["step"] == 2
    jstraight = j2
    for b in batches[2:]:
        jstraight, jm = jstep(jstraight, _jbatch(b))
        tstate, tm = tstep(tstate, _tbatch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **TOL)
    assert tstate["step"] == 4
    _assert_close_to_jax(tstate, jstraight)


def test_bf16_leaf_round_trips_in_port(tmp_path):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    d = str(tmp_path / "ck")
    tckpt.save_pytree({"a": x, "b": torch.ones(2)}, d)
    rec = json.load(open(os.path.join(d, "manifest.json")))["leaves"][0]
    assert rec["dtype"] == "bfloat16" and rec["shape"] == [3, 5]
    back = tckpt.load_pytree(d, {"a": x.to("meta"), "b": torch.ones(2)},
                             device="cpu")
    assert back["a"].dtype == torch.bfloat16
    torch.testing.assert_close(back["a"], x, rtol=0, atol=0)
    # cast to the target's dtype on load, as the reference's astype
    up = tckpt.load_pytree(d, {"a": torch.empty(3, 5), "b": torch.ones(2)},
                           device="cpu")
    torch.testing.assert_close(up["a"], x.float(), rtol=0, atol=0)


def test_bf16_leaf_matches_the_reference_file(tmp_path):
    """A bf16 leaf: the same bytes as the reference writes (ml_dtypes'
    '<V2' records), and the port reads the reference's file."""
    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_pytree({"a": jnp.asarray(vals, jnp.bfloat16)}, jd)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    tckpt.save_pytree({"a": t}, td)
    assert filecmp.cmp(os.path.join(jd, "leaf_00000.npy"),
                       os.path.join(td, "leaf_00000.npy"), shallow=False)
    back = tckpt.load_pytree(jd, {"a": t.to("meta")}, device="cpu")
    torch.testing.assert_close(back["a"], t, rtol=0, atol=0)


def test_reference_cannot_restore_a_bf16_leaf(tmp_path):
    """The reference's fault, recorded: np.save writes an ml_dtypes bf16
    array as raw '<V2' and load_pytree's astype (manager.py:87) has no cast
    from it."""
    d = str(tmp_path / "ck")
    tree = {"a": jnp.arange(4, dtype=jnp.bfloat16)}
    jckpt.save_pytree(tree, d)
    with pytest.raises(ValueError):
        jckpt.load_pytree(d, jax.eval_shape(lambda: tree))


def test_train_main_resumes_at_the_saved_step(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b-reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-every", "2"]
    straight = train.main(argv + ["--steps", "4", "--ckpt",
                                  str(tmp_path / "a")])
    first = train.main(argv + ["--steps", "2", "--ckpt",
                               str(tmp_path / "b")])
    assert first.start_step == 0
    resumed = train.main(argv + ["--steps", "4", "--ckpt",
                                 str(tmp_path / "b"), "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.start_step == 2 and len(resumed.losses) == 2
    assert first.losses + resumed.losses == straight.losses
    mgr_a = tckpt.CheckpointManager(str(tmp_path / "a"), async_writes=False)
    mgr_b = tckpt.CheckpointManager(str(tmp_path / "b"), async_writes=False)
    assert mgr_a.steps() == mgr_b.steps() == [2, 4]
    like = _meta(tsteps.make_train_state(
        torch.Generator().manual_seed(0), tconfigs.get_reduced("qwen3-0.6b"),
        topt.adamw(1e-3), "cpu"))
    a, meta_a = mgr_a.restore(like, device="cpu")
    b, meta_b = mgr_b.restore(like, device="cpu")
    assert meta_a == meta_b == {"step": 4}
    _assert_trees_equal(a, b)


def test_train_lm_example_resumes_on_cpu(tmp_path, capsys):
    """``examples/torch_train_lm.py`` at a tiny width: 4 steps with a
    checkpoint every 2, then --resume to 6 from step 4, equal to 6
    straight steps."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--d-model", "64", "--layers", "2", "--seq", "16", "--batch",
            "4", "--vocab", "256", "--ckpt-every", "2", "--device", "cpu"]
    straight = example.main(argv + ["--steps", "6", "--ckpt-dir",
                                    str(tmp_path / "a")])
    first = example.main(argv + ["--steps", "4", "--ckpt-dir",
                                 str(tmp_path / "b")])
    resumed = example.main(argv + ["--steps", "6", "--ckpt-dir",
                                   str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "final loss" in out
    assert first + resumed == straight
