"""The hybrid (Griffin) and ssm (xLSTM) families' sharded steps
(``launch.steps`` with a ``DeviceMesh``) on the CPU over gloo, against the
port's unsharded step and the JAX reference's: the counterpart of
``tests/test_torch_sharded_families.py`` for the recurrent families.

A module fixture starts two gloo groups at once
(``tests/torch_shard_worker.py``, one process a rank, a ``FileStore`` in
the test's tmp dir): 4 ranks for the (2, 2) mesh, 8 for (2, 2, 2) with
pods. Beside them a JAX subprocess on 8 XLA host devices runs the
reference's dry-run of both archs on an Auto-axes 2 x 2 mesh. Meanwhile
this process runs the port's and the reference's unsharded steps on the
same parameters (the reference's init) and inputs.

Reduced recurrentgemma-9b (MQA, K = 1 over a model dim of 2: rank 0 of
"model" holds the kv head, rank 1 none) with ``use_pallas`` on and off;
reduced xlstm-350m, whose sLSTM's contiguous column split puts i and f on
model rank 0 and z and o on rank 1 (d_inner 128), so each step gathers
its pre-activations. Train steps at 1 and 2 microbatches, the prefill's
logits, and decode from ``transformer.init_cache`` (the reference's only
decode of these families) over the prompt's first tokens.

Tolerances: the sharded train step and prefill against the port's
unsharded ones at fp32 1e-5, against the reference at 1e-4. Decode logits:
the hybrid's at 1e-5 of the port; the xLSTM's at 1e-4 of the port, since
its decode from ``init_cache`` is ill-conditioned at random init (the
normalizer n . q of the first steps cancels): the port and the reference,
both unsharded fp32, already differ by 6.5e-5 there, and the sharded
decode reduces C q and n . q over "model" in another order. Both against
the reference at 1e-4, and the greedy tokens of every decode step equal.
A planted fault, an sLSTM that takes its gates from a rank's own columns,
must fail the 1e-5 check.
"""
import json
import os
import subprocess
import sys
import time
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
# decode logits against the unsharded port, by arch (module docstring)
DECODE_TOL = {"recurrentgemma-9b": PORT_TOL, "xlstm-350m": REF_TOL}
ARCHS = ("recurrentgemma-9b", "xlstm-350m")

CASES = [
    dict(name="rg_2x2", arch="recurrentgemma-9b", mesh=[2, 2], group="a",
         pallas=True, micro=[1, 2], serve=True),
    dict(name="rg_2x2_plain", arch="recurrentgemma-9b", mesh=[2, 2],
         group="a", pallas=False, micro=[1], serve=True),
    dict(name="xlstm_2x2", arch="xlstm-350m", mesh=[2, 2], group="a",
         pallas=True, micro=[1, 2], serve=True),
    dict(name="xlstm_2x2_own_gates", arch="xlstm-350m", mesh=[2, 2],
         group="a", pallas=True, micro=[1], serve=False, fault="own_gates"),
    dict(name="rg_2x2x2", arch="recurrentgemma-9b", mesh=[2, 2, 2],
         group="b", pallas=True, micro=[2], serve=True),
    dict(name="xlstm_2x2x2", arch="xlstm-350m", mesh=[2, 2, 2], group="b",
         pallas=True, micro=[1], serve=True),
]
GROUPS = {"a": 4, "b": 8}                # group -> ranks
TRAIN = [(c["name"], m) for c in CASES if "fault" not in c
         for m in c["micro"]]
SERVE = [c["name"] for c in CASES if c["serve"]]
BYTES = [(a, k) for a in ARCHS for k in ("prefill", "decode", "train")]

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
for arch in sys.argv[2].split(","):
    for kind in ("prefill", "decode", "train"):
        shape = configs.ShapeSpec(kind, kind, 256, 8)
        rec = dryrun.run_cell(arch, kind, mesh=mesh, reduced=True,
                              shape=shape, verbose=False)
        out[f"{arch}/{kind}"] = {"status": rec["status"],
                                 "error": rec.get("error"),
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
    params = jax.jit(JT.init, static_argnums=1)(
        jax.random.PRNGKey(0), jconfigs.get_reduced(arch))
    return jax.tree.map(np.asarray, params)


def _inputs():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels[:, S - 3:] = -1
    return {"tokens": tokens, "labels": labels}


def _jsys(case, m=1):
    return JT.SystemConfig(precision="fp32", q_chunk=16, kv_chunk=16,
                           use_pallas=case["pallas"], microbatches=m)


def _jbatch(tbatch):
    return {k: jnp.asarray(t.numpy().astype(np.int32))
            for k, t in tbatch.items()}


def _reference_decode(jcfg, jsys, params_np, tokens, n):
    """The reference's ``n`` decode steps from its ``init_cache`` (fp32)."""
    decode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    cache = JT.init_cache(jcfg, tokens.shape[0], n, dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, params_np)
    out = []
    for t in range(n):
        logits, cache = decode(params, cache,
                               jnp.asarray(tokens[:, t:t + 1]), t)
        out.append(np.asarray(logits))
    return np.stack(out)


def _unsharded(case, params_np, inputs, memo):
    """{key: array} of the port's and the reference's unsharded steps,
    ``port/...`` and ``ref/...``, keyed as the worker keys its output;
    ``memo`` keeps each (arch, use_pallas, microbatches) step and each
    (arch, use_pallas) serve once."""
    arch = case["arch"]
    tcfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    out = {}
    tbatch = worker.batch_of(tcfg, inputs)
    for m in case["micro"]:
        key = (arch, case["pallas"], m)
        if key not in memo:
            got = {}
            opt = worker.optimizer()
            params = weights.from_jax(params_np, tcfg, "cpu")
            state = {"params": params, "opt": opt.init(params), "step": 0}
            state, metrics = tsteps.make_train_step(
                tcfg, worker.system(case, m), opt)(state, tbatch)
            got[f"port/m{m}/loss"] = metrics["loss"].numpy()
            got[f"port/m{m}/accuracy"] = metrics["accuracy"].numpy()
            for p, t in weights.flatten(state["params"]).items():
                got[f"port/m{m}/params/{p}"] = t.numpy()
            jo = jopt.sgd(worker.LR, momentum=0.9, clip_norm=1.0)
            jparams = jax.tree.map(jnp.asarray, params_np)
            jstate = {"params": jparams, "opt": jo.init(jparams),
                      "step": jnp.zeros((), jnp.int32)}
            jstate, jm = jax.jit(jsteps.make_train_step(
                jcfg, _jsys(case, m), jo))(jstate, _jbatch(tbatch))
            got[f"ref/m{m}/loss"] = np.asarray(jm["loss"])
            got[f"ref/m{m}/accuracy"] = np.asarray(jm["accuracy"])
            for p, a in weights.flatten(jax.tree.map(
                    np.asarray, jstate["params"])).items():
                got[f"ref/m{m}/params/{p}"] = a
            memo[key] = got
        out.update(memo[key])
    key = (arch, case["pallas"])
    if case["serve"] and key not in memo:
        n = worker.DECODE_STEPS
        params = weights.from_jax(params_np, tcfg, "cpu")
        sys_cfg = worker.system(case)
        prompt = worker.batch_of(tcfg, inputs, "prefill")
        logits, _ = tsteps.make_prefill_step(tcfg, sys_cfg)(params, prompt)
        jlogits, _ = jax.jit(jsteps.make_prefill_step(jcfg, _jsys(case)))(
            jax.tree.map(jnp.asarray, params_np), _jbatch(prompt))
        memo[key] = {
            "port/prefill_logits": logits.numpy(),
            "port/decode_logits": worker.decode_from_init(
                tcfg, sys_cfg, params, tbatch["tokens"], n),
            "ref/prefill_logits": np.asarray(jlogits),
            "ref/decode_logits": _reference_decode(
                jcfg, _jsys(case), params_np, inputs["tokens"], n)}
    if case["serve"]:
        out.update(memo[key])
    return out


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Starts the two gloo groups and the JAX dry-run, computes the
    unsharded steps meanwhile; returns {case: (sharded, unsharded)} and the
    reference's dry-run records."""
    t0 = time.perf_counter()
    out = tmp_path_factory.mktemp("shardrec")
    inputs = _inputs()
    params = {a: _reference_params(a) for a in ARCHS}
    arrays = dict(inputs)
    for arch in ARCHS:
        flat = weights.flatten(weights.from_jax(
            params[arch], configs.get_reduced(arch), "cpu"))
        arrays.update({f"{arch}/{p}": t.numpy() for p, t in flat.items()})
    np.savez(out / "inputs.npz", **arrays)
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
        [sys.executable, "-c", _JAX_DRYRUN, str(out / "ref_cells.json"),
         ",".join(ARCHS)],
        stdout=log, stderr=subprocess.STDOUT, env=_env()))
    try:
        memo = {}
        tinputs = np.load(out / "inputs.npz")
        unsharded = {c["name"]: _unsharded(c, params[c["arch"]], tinputs,
                                           memo) for c in CASES}
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
    print(f"sharded recurrent fixture: {time.perf_counter() - t0:.1f} s")
    return runs, json.loads((out / "ref_cells.json").read_text())


def _train_pairs(got, want, micro):
    """[(name, sharded, port, reference)] of a train step's loss, accuracy
    and every updated parameter."""
    pairs = [(k, got[f"m{micro}/{k}"], want[f"port/m{micro}/{k}"],
              want[f"ref/m{micro}/{k}"]) for k in ("loss", "accuracy")]
    prefix = f"m{micro}/params/"
    paths = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert paths and set(paths) == {
        k[len("port/" + prefix):] for k in want
        if k.startswith("port/" + prefix)}
    return pairs + [(p, got[prefix + p], want["port/" + prefix + p],
                     want["ref/" + prefix + p]) for p in paths]


@pytest.mark.parametrize("name,micro", TRAIN)
def test_sharded_train_step_matches_unsharded_and_reference(sharded_runs,
                                                            name, micro):
    got, want = sharded_runs[0][name]
    assert bool(got[f"m{micro}/all_dtensors"])
    for key, g, port, ref in _train_pairs(got, want, micro):
        np.testing.assert_allclose(g, port, err_msg=key, **PORT_TOL)
        np.testing.assert_allclose(g, ref, err_msg=key, **REF_TOL)


@pytest.mark.parametrize("name", SERVE)
def test_sharded_prefill_and_decode_match(sharded_runs, name):
    """The prefill's logits, and every step's logits of a decode from
    ``init_cache`` over the prompt's first tokens, with their greedy
    tokens."""
    got, want = sharded_runs[0][name]
    arch = next(c["arch"] for c in CASES if c["name"] == name)
    np.testing.assert_allclose(got["prefill_logits"],
                               want["port/prefill_logits"], **PORT_TOL)
    np.testing.assert_allclose(got["prefill_logits"],
                               want["ref/prefill_logits"], **REF_TOL)
    np.testing.assert_allclose(got["decode_logits"],
                               want["port/decode_logits"],
                               **DECODE_TOL[arch])
    np.testing.assert_allclose(got["decode_logits"],
                               want["ref/decode_logits"], **REF_TOL)
    np.testing.assert_array_equal(got["decode_logits"].argmax(-1),
                                  want["port/decode_logits"].argmax(-1))
    err = np.abs(got["decode_logits"] - want["port/decode_logits"]).max()
    print(f"{name}: decode max|sharded - port| {err:.3e}")


def test_planted_own_gates_fault_is_caught(sharded_runs):
    """An sLSTM that takes its gates from a rank's own columns (no gather
    of the pre-activations) fails the 1e-5 check of the train step."""
    got, want = sharded_runs[0]["xlstm_2x2_own_gates"]
    off = []
    for key, g, port, _ in _train_pairs(got, want, 1):
        if not np.allclose(g, port, **PORT_TOL):
            off.append(key)
    print(f"own-gates fault: {len(off)} of the step's values off, among "
          f"them {off[:4]}")
    assert "loss" in off and len(off) > 2


@pytest.mark.parametrize("arch,kind", BYTES)
def test_dryrun_argument_bytes_equal_the_references_sharded_cells(
        sharded_runs, arch, kind):
    """The port's per-device argument bytes on a 2 x 2 mesh equal the
    reference's Auto-axes cells'; the reference keeps a train cell's step
    and a decode cell's position as int32 scalars (4 bytes each), the port
    as Python ints. The xLSTM's decode never reads its position, so the
    reference's jit drops it."""
    ref = sharded_runs[1][f"{arch}/{kind}"]
    assert ref["status"] == "ok", ref["error"]
    rec = dryrun.run_cell(arch, kind, mesh="2x2", reduced=True,
                          shape=configs.ShapeSpec(kind, kind, 256, 8),
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    reads_scalar = kind == "train" or (kind == "decode"
                                       and arch != "xlstm-350m")
    scalar = 4 if reads_scalar else 0
    assert rec["memory"]["argument_size_in_bytes"] + scalar == \
        ref["memory"]["argument_size_in_bytes"]
    print(f"{arch} {kind}: collectives port {rec['collectives']}, "
          f"reference {ref['collectives']}; trace {rec['trace_s']} s")
