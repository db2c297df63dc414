"""The dense family's sharded step (``launch.steps`` with a ``DeviceMesh``)
on the CPU over gloo, against the port's unsharded step and the JAX
reference's.

A module fixture starts three gloo groups at once
(``tests/torch_shard_worker.py``, one process a rank, a ``FileStore`` in
the test's tmp dir): 4 ranks for the (2, 2) mesh, 4 for (1, 4), 8 for
(2, 2, 2) with pods. Beside them
a JAX subprocess on 8 XLA host devices runs the reference's dry-run on an
Auto-axes 2 x 2 mesh. Meanwhile this process runs the port's and the
reference's unsharded steps on the same parameters (the reference's init)
and tokens. Reduced qwen3-0.6b (K = 2) and reduced qwen2-1.5b (K = 2 over
a model dim of 4: two ranks hold no kv head), ``use_pallas`` on and off,
1 and 2 microbatches.

Tolerances: the sharded step against the port's unsharded one at fp32
1e-5 (the shards' partial sums add in another order); against the
reference at 1e-4 (tests/test_torch_train.py's). The optimizer is sgd
with momentum and global-norm clipping: the clip's norm runs over every
shard. A rank's log is in the fixture's tmp dir (``log_{group}{rank}.txt``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import configs, weights
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_shard_worker as worker  # noqa: E402

B, S = 8, 20
SPAWN_TIMEOUT_S = 240
PORT_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen3-0.6b", "qwen2-1.5b")

CASES = [
    dict(name="qwen3_2x2", arch="qwen3-0.6b", mesh=[2, 2], group="a",
         pallas=True, micro=[1, 2], serve=True),
    dict(name="qwen3_2x2_plain", arch="qwen3-0.6b", mesh=[2, 2], group="a",
         pallas=False, micro=[2], serve=False),
    dict(name="qwen3_1x4", arch="qwen3-0.6b", mesh=[1, 4], group="b",
         pallas=True, micro=[1], serve=True),
    dict(name="qwen2_1x4", arch="qwen2-1.5b", mesh=[1, 4], group="b",
         pallas=True, micro=[2], serve=True),
    dict(name="qwen2_1x4_plain", arch="qwen2-1.5b", mesh=[1, 4], group="b",
         pallas=False, micro=[1], serve=False),
    dict(name="qwen3_2x2x2", arch="qwen3-0.6b", mesh=[2, 2, 2], group="c",
         pallas=True, micro=[2], serve=True),
]
GROUPS = {"a": 4, "b": 4, "c": 8}        # group -> ranks
TRAIN = [(c["name"], m) for c in CASES for m in c["micro"]]
SERVE = [c["name"] for c in CASES if c["serve"]]

# the reference's dry-run on an Auto-axes 2 x 2 mesh of 8 host devices
# (jax 0.9's default axis types do not lower these cells: ROADMAP §C)
_JAX_DRYRUN = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
from repro import configs
from repro.launch import dryrun
out = {}
for kind in ("prefill", "decode", "train"):
    shape = configs.ShapeSpec(kind, kind, 256, 8)
    rec = dryrun.run_cell("qwen3-0.6b", kind, mesh=mesh, reduced=True,
                          shape=shape, verbose=False)
    out[kind] = {"status": rec["status"], "error": rec.get("error"),
                 "memory": rec.get("memory"),
                 "collectives": rec.get("collectives")}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _env():
    path = str(ROOT / "src")
    old = os.environ.get("PYTHONPATH")
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": path + (os.pathsep + old if old else "")}


def _reference_params(arch):
    cfg = jconfigs.get_reduced(arch)
    params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(np.asarray, params)


def _batch():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels[:, S - 3:] = -1
    return tokens, labels


def _jsys(case, m=1):
    return JT.SystemConfig(precision="fp32", q_chunk=16, kv_chunk=16,
                           use_pallas=case["pallas"], microbatches=m)


def _unsharded(case, params_np, tokens, labels, memo):
    """{key: array} of the port's and the reference's unsharded steps:
    ``port/...`` and ``ref/...``, keyed as the worker keys its output.
    ``memo`` keeps each (arch, use_pallas, microbatches) step and each
    (arch, use_pallas) prefill once: the meshes share them."""
    arch = case["arch"]
    tcfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    out = {}
    tbatch = {"tokens": torch.from_numpy(tokens).long(),
              "labels": torch.from_numpy(labels).long()}
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    for m in case["micro"]:
        key = (arch, case["pallas"], m)
        if key in memo:
            out.update(memo[key])
            continue
        opt = worker.optimizer()
        params = weights.from_jax(params_np, tcfg, "cpu")
        state = {"params": params, "opt": opt.init(params), "step": 0}
        state, metrics = tsteps.make_train_step(
            tcfg, worker.system(case, m), opt)(state, tbatch)
        out[f"port/m{m}/loss"] = metrics["loss"].numpy()
        out[f"port/m{m}/accuracy"] = metrics["accuracy"].numpy()
        for p, t in weights.flatten(state["params"]).items():
            out[f"port/m{m}/params/{p}"] = t.numpy()
        jo = jopt.sgd(worker.LR, momentum=0.9, clip_norm=1.0)
        jparams = jax.tree.map(jnp.asarray, params_np)
        jstate = {"params": jparams, "opt": jo.init(jparams),
                  "step": jnp.zeros((), jnp.int32)}
        jstate, jm = jax.jit(jsteps.make_train_step(
            jcfg, _jsys(case, m), jo))(jstate, jbatch)
        out[f"ref/m{m}/loss"] = np.asarray(jm["loss"])
        out[f"ref/m{m}/accuracy"] = np.asarray(jm["accuracy"])
        for p, a in weights.flatten(jax.tree.map(
                np.asarray, jstate["params"])).items():
            out[f"ref/m{m}/params/{p}"] = a
        memo[key] = {k: v for k, v in out.items() if f"/m{m}/" in k}
    key = (arch, case["pallas"])
    if case["serve"] and key in memo:
        out.update(memo[key])
    elif case["serve"]:
        n = worker.DECODE_STEPS
        params = weights.from_jax(params_np, tcfg, "cpu")
        sys_cfg = worker.system(case)
        logits, cache = tsteps.make_prefill_step(tcfg, sys_cfg, max_len=S + n)(
            params, {"tokens": tbatch["tokens"]})
        out["port/prefill_logits"] = logits.numpy()
        decode = tsteps.make_decode_step(tcfg, sys_cfg)
        tok, toks = logits.argmax(-1), [logits.argmax(-1)]
        for i in range(n):
            logits, cache = decode(params, cache, tok, S + i)
            tok = logits.argmax(-1)
            toks.append(tok)
        out["port/tokens"] = torch.cat(toks, 1).numpy()
        jlogits, _ = jax.jit(jsteps.make_prefill_step(
            jcfg, _jsys(case), max_len=S + n))(
            jax.tree.map(jnp.asarray, params_np), {"tokens": jbatch["tokens"]})
        out["ref/prefill_logits"] = np.asarray(jlogits)
        memo[key] = {k: v for k, v in out.items() if "/m" not in k}
    return out


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Starts the two gloo groups and the JAX dry-run, computes the
    unsharded steps meanwhile; returns {case: (sharded, unsharded)} and the
    reference's dry-run records."""
    out = tmp_path_factory.mktemp("shard")
    tokens, labels = _batch()
    params = {a: _reference_params(a) for a in ARCHS}
    inputs = {"tokens": tokens, "labels": labels}
    for arch in ARCHS:
        flat = weights.flatten(weights.from_jax(
            params[arch], configs.get_reduced(arch), "cpu"))
        inputs.update({f"{arch}/{p}": t.numpy() for p, t in flat.items()})
    np.savez(out / "inputs.npz", **inputs)
    (out / "cases.json").write_text(json.dumps(CASES))
    logs, procs = [], []
    for group, world in GROUPS.items():
        for r in range(world):
            log = open(out / f"log_{group}{r}.txt", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_shard_worker.py"),
                 group, str(r), str(world), str(out)], stdout=log,
                stderr=subprocess.STDOUT, env=_env()))
    log = open(out / "log_jax.txt", "w")
    logs.append(log)
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX_DRYRUN, str(out / "ref_cells.json")],
        stdout=log, stderr=subprocess.STDOUT, env=_env()))
    try:
        memo = {}
        unsharded = {c["name"]: _unsharded(c, params[c["arch"]], tokens,
                                           labels, memo) for c in CASES}
        codes = [p.wait(timeout=SPAWN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(codes):
        text = "\n".join(f.read_text()[-3000:]
                         for f in sorted(out.glob("log*.txt")))
        pytest.fail(f"exit codes {codes}:\n{text}")
    runs = {c["name"]: (dict(np.load(out / f"{c['name']}.npz")),
                        unsharded[c["name"]]) for c in CASES}
    return runs, json.loads((out / "ref_cells.json").read_text())


@pytest.mark.parametrize("name,micro", TRAIN)
def test_sharded_train_step_matches_unsharded_and_reference(sharded_runs,
                                                            name, micro):
    got, want = sharded_runs[0][name]
    assert bool(got[f"m{micro}/all_dtensors"])
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(got[f"m{micro}/{key}"],
                                   want[f"port/m{micro}/{key}"],
                                   err_msg=key, **PORT_TOL)
        np.testing.assert_allclose(got[f"m{micro}/{key}"],
                                   want[f"ref/m{micro}/{key}"],
                                   err_msg=key, **REF_TOL)
    prefix = f"m{micro}/params/"
    paths = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert paths and set(paths) == {
        k[len("port/" + prefix):] for k in want
        if k.startswith("port/" + prefix)}
    for p in paths:
        np.testing.assert_allclose(got[prefix + p], want["port/" + prefix + p],
                                   err_msg=p, **PORT_TOL)
        np.testing.assert_allclose(got[prefix + p], want["ref/" + prefix + p],
                                   err_msg=p, **REF_TOL)


@pytest.mark.parametrize("name", SERVE)
def test_sharded_prefill_and_decode_match(sharded_runs, name):
    got, want = sharded_runs[0][name]
    np.testing.assert_allclose(got["prefill_logits"],
                               want["port/prefill_logits"], **PORT_TOL)
    np.testing.assert_allclose(got["prefill_logits"],
                               want["ref/prefill_logits"], **REF_TOL)
    np.testing.assert_array_equal(got["tokens"], want["port/tokens"])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dryrun_argument_bytes_equal_the_references_sharded_cells(
        sharded_runs, kind):
    """The port's per-device argument bytes on a 2 x 2 mesh equal the
    reference's Auto-axes cells'; the reference keeps a train cell's step
    and a decode cell's position as int32 scalars (4 bytes each), the port
    as Python ints. Collective bytes are printed, not compared: GSPMD and
    DTensor place the reductions differently."""
    ref = sharded_runs[1][kind]
    assert ref["status"] == "ok", ref["error"]
    rec = dryrun.run_cell("qwen3-0.6b", kind, mesh="2x2", reduced=True,
                          shape=configs.ShapeSpec(kind, kind, 256, 8),
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    scalar = 0 if kind == "prefill" else 4
    assert rec["memory"]["argument_size_in_bytes"] + scalar == \
        ref["memory"]["argument_size_in_bytes"]
    print(f"{kind}: collectives port {rec['collectives']}, reference "
          f"{ref['collectives']}")


def test_gradient_reductions_are_counted_on_a_mesh_only():
    shape = configs.ShapeSpec("t", "train", 64, 8)
    one = dryrun.run_cell("qwen3-0.6b", "t", reduced=True, shape=shape,
                          verbose=False)
    four = dryrun.run_cell("qwen3-0.6b", "t", mesh="2x2", reduced=True,
                           shape=shape, verbose=False)
    assert one["status"] == four["status"] == "ok"
    assert one["collective_count"] == 0 and not any(
        one["collectives"].values())
    reductions = (four["collectives"]["all-reduce"]
                  + four["collectives"]["reduce-scatter"])
    assert reductions > 0 and four["collectives"]["all-gather"] > 0
    # weights are gathered, not activations: a rank multiplies half the
    # rows (data) by half the columns (model), so its flops stay under half
    # the 1x1 cell's (a replicated batch would put them at half or more)
    assert four["cost"]["flops"] < 0.5 * one["cost"]["flops"]


def test_dryrun_counts_all_to_all_where_heads_are_uneven():
    """Reduced qwen2-1.5b (2 kv heads) on a 1 x 4 mesh moves shards between
    dims of the "model" axis: the cell counts those moves as all-to-all
    (the card's DTensor path), not as the all-gather a "cpu" mesh would
    emulate them with."""
    rec = dryrun.run_cell("qwen2-1.5b", "t", mesh="1x4", reduced=True,
                          shape=configs.ShapeSpec("t", "train", 64, 8),
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["collectives"]["all-to-all"] > 0
    print(f"collectives {rec['collectives']}")


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-moe-a2.7b",
                                  "internvl2-26b", "whisper-small",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_sharded_families_pass_require_shardable_on_a_mesh(arch):
    """The MoE, vlm, audio, hybrid and ssm families have sharded steps
    (``tests/test_torch_sharded_families.py`` and
    ``tests/test_torch_sharded_recurrent.py`` run them)."""
    cfg = configs.get_reduced(arch)
    assert tsteps.family(cfg) in tsteps.SHARDED_FAMILIES
    tsteps.require_shardable(cfg, abstract_mesh_size(2, 2))
    tsteps.require_shardable(cfg, abstract_mesh_size(16, 16))
    tsteps.require_shardable(cfg, abstract_mesh_size(2, 16, 16))


def test_mesh_items_stand_in_the_roadmap():
    """Each family's item, as ``require_shardable`` and the dry-run name
    it, is an item of ROADMAP.md's queue A under that number and title."""
    import re
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for note in set(tsteps.MESH_ITEMS.values()):
        num, title = re.match(r"(\d+)\. (.+)$", note).groups()
        assert re.search(rf"^{num}\. \*\*{re.escape(title)}\.\*\*",
                         roadmap, re.M), note


class abstract_mesh_size:
    """A stand-in mesh with ``size()`` and ``shape``."""

    def __init__(self, *shape):
        self.shape = shape

    def size(self):
        return int(np.prod(self.shape))
