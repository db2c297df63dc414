"""The MoE, vlm and audio families' sharded steps (``launch.steps`` with a
``DeviceMesh``) on the CPU over gloo, against the port's unsharded step and
the JAX reference's: the counterpart of ``tests/test_torch_sharded.py``
for these families.

A module fixture starts two gloo groups at once
(``tests/torch_shard_worker.py``, one process a rank, a ``FileStore`` in
the test's tmp dir): 4 ranks for the (2, 2) mesh, 8 for (2, 2, 2) with
pods. Beside them a JAX subprocess on 8 XLA host devices runs the
reference's dry-run of the four archs on an Auto-axes 2 x 2 mesh.
Meanwhile this process runs the port's and the reference's unsharded
steps on the same parameters (the reference's init) and inputs.

The cases cover both placements the rules give the experts' FSDP dim:
reduced mixtral-8x22b (E = 4) on (2, 2), where E takes the data axis, and
reduced qwen2-moe-a2.7b with ``n_experts=6`` in both packages on
(2, 2, 2), where E does not divide the batch axes (4) and d_model takes
them, as at 16x16 (E = 8 and 60 over 16). Reduced internvl2-26b goes
through its adapter and reduced whisper-small through its encoder, cross
cache and wrapping self cache. ``use_pallas`` on and off for the
attention families, 1 and 2 microbatches.

Tolerances: the sharded step against the port's unsharded one at fp32
1e-5, against the reference at 1e-4 (``tests/test_torch_sharded.py``'s).
An MoE case compares the experts its prefill chose, row by row and layer
by layer, before any value, and prints the router's smallest top-k margin
(a near-tie there would flip a choice, not bend a value).
"""
import dataclasses
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
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro_torch import configs, weights
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_shard_worker as worker  # noqa: E402

B, S = 8, 20
SPAWN_TIMEOUT_S = 240
PORT_TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
E6 = {"n_experts": 6}
# params key -> (arch, config fields replaced in both packages)
PARAMS = {"mixtral-8x22b": ("mixtral-8x22b", {}),
          "qwen2-moe-e6": ("qwen2-moe-a2.7b", E6),
          "internvl2-26b": ("internvl2-26b", {}),
          "whisper-small": ("whisper-small", {})}
REF_ARCHS = ("mixtral-8x22b", "qwen2-moe-a2.7b", "internvl2-26b",
             "whisper-small")

CASES = [
    dict(name="mixtral_2x2", arch="mixtral-8x22b", mesh=[2, 2], group="a",
         pallas=True, micro=[1, 2], serve=True),
    dict(name="mixtral_2x2_plain", arch="mixtral-8x22b", mesh=[2, 2],
         group="a", pallas=False, micro=[2], serve=True),
    dict(name="internvl2_2x2", arch="internvl2-26b", mesh=[2, 2], group="a",
         pallas=True, micro=[1, 2], serve=True),
    dict(name="internvl2_2x2_plain", arch="internvl2-26b", mesh=[2, 2],
         group="a", pallas=False, micro=[1], serve=False),
    dict(name="whisper_2x2", arch="whisper-small", mesh=[2, 2], group="a",
         pallas=False, micro=[1, 2], serve=True),
    dict(name="qwen2moe_e6_2x2x2", arch="qwen2-moe-a2.7b",
         params="qwen2-moe-e6", cfg=E6, mesh=[2, 2, 2], group="b",
         pallas=True, micro=[1, 2], serve=True),
    dict(name="qwen2moe_e6_2x2x2_plain", arch="qwen2-moe-a2.7b",
         params="qwen2-moe-e6", cfg=E6, mesh=[2, 2, 2], group="b",
         pallas=False, micro=[1], serve=False),
]
GROUPS = {"a": 4, "b": 8}                # group -> ranks
TRAIN = [(c["name"], m) for c in CASES for m in c["micro"]]
SERVE = [c["name"] for c in CASES if c["serve"]]
ROUTED = [c["name"] for c in CASES
          if c["serve"] and configs.get_reduced(c["arch"]).family == "moe"]

# the reference's dry-run on an Auto-axes 2 x 2 mesh of 8 host devices
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


def _configs(key):
    """(the port's config, the reference's) of a params key."""
    arch, fields = PARAMS[key]
    return (dataclasses.replace(configs.get_reduced(arch), **fields),
            dataclasses.replace(jconfigs.get_reduced(arch), **fields))


def _reference_params(key):
    _, jcfg = _configs(key)
    init = JE.init if isinstance(jcfg, JE.EncDecConfig) else JT.init
    params = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jax.tree.map(np.asarray, params)


def _inputs():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels[:, S - 3:] = -1
    d = configs.get_reduced("whisper-small")
    return {"tokens": tokens, "labels": labels,
            "embeddings": rng.standard_normal((B, S, 64)).astype(np.float32),
            "frames": rng.standard_normal(
                (B, d.n_enc_frames, d.d_model)).astype(np.float32)}


def _jsys(case, m=1):
    return JT.SystemConfig(precision="fp32", q_chunk=16, kv_chunk=16,
                           use_pallas=case["pallas"], microbatches=m)


def _jbatch(tbatch):
    return {k: jnp.asarray(t.numpy().astype(np.int32)
                           if k in ("tokens", "labels") else t.numpy())
            for k, t in tbatch.items()}


def _routes_of(fn):
    """(fn()'s result, the experts each ``moe._gate`` call chose, the
    smallest margin between a row's k-th and (k+1)-th router
    probability)."""
    routes, margins, gate = [], [], moe._gate

    def spy(x, router, cfg, token_chunk):
        out = gate(x, router, cfg, token_chunk)
        probs = torch.softmax(moe._segments(x, token_chunk).float()
                              @ router.float(), -1)
        top = probs.topk(cfg.top_k + 1, -1).values
        margins.append(float((top[..., -2] - top[..., -1]).min()))
        routes.append(out[1].numpy())
        return out
    moe._gate = spy
    try:
        return fn(), routes, min(margins, default=float("inf"))
    finally:
        moe._gate = gate


def _unsharded(case, params_np, inputs, memo):
    """{key: array} of the port's and the reference's unsharded steps:
    ``port/...`` and ``ref/...``, keyed as the worker keys its output.
    ``memo`` keeps each (params, use_pallas, microbatches) step and each
    (params, use_pallas) prefill once."""
    key_p = case.get("params", case["arch"])
    tcfg, jcfg = _configs(key_p)
    out = {}
    tbatch = worker.batch_of(tcfg, inputs)
    for m in case["micro"]:
        key = (key_p, case["pallas"], m)
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
            jcfg, _jsys(case, m), jo))(jstate, _jbatch(tbatch))
        out[f"ref/m{m}/loss"] = np.asarray(jm["loss"])
        out[f"ref/m{m}/accuracy"] = np.asarray(jm["accuracy"])
        for p, a in weights.flatten(jax.tree.map(
                np.asarray, jstate["params"])).items():
            out[f"ref/m{m}/params/{p}"] = a
        memo[key] = {k: v for k, v in out.items() if f"/m{m}/" in k}
    key = (key_p, case["pallas"])
    if case["serve"] and key in memo:
        out.update(memo[key])
    elif case["serve"]:
        n = worker.DECODE_STEPS
        params = weights.from_jax(params_np, tcfg, "cpu")
        sys_cfg = worker.system(case)
        prompt = worker.batch_of(tcfg, inputs, "prefill")
        (logits, cache), routes, margin = _routes_of(
            lambda: tsteps.make_prefill_step(tcfg, sys_cfg, max_len=S + n)(
                params, prompt))
        out["port/prefill_logits"] = logits.numpy()
        for layer, idx in enumerate(routes):
            out[f"port/routes/{layer}"] = idx
        out["port/margin"] = np.float64(margin)
        decode = tsteps.make_decode_step(tcfg, sys_cfg)
        tok, toks = logits.argmax(-1), [logits.argmax(-1)]
        for i in range(n):
            logits, cache = decode(params, cache, tok, S + i)
            tok = logits.argmax(-1)
            toks.append(tok)
        out["port/tokens"] = torch.cat(toks, 1).numpy()
        jlogits, _ = jax.jit(jsteps.make_prefill_step(
            jcfg, _jsys(case), max_len=S + n))(
            jax.tree.map(jnp.asarray, params_np), _jbatch(prompt))
        out["ref/prefill_logits"] = np.asarray(jlogits)
        memo[key] = {k: v for k, v in out.items() if "/m" not in k}
    return out


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Starts the two gloo groups and the JAX dry-run, computes the
    unsharded steps meanwhile; returns {case: (sharded, unsharded)} and the
    reference's dry-run records."""
    t0 = time.perf_counter()
    out = tmp_path_factory.mktemp("shardfam")
    inputs = _inputs()
    params = {k: _reference_params(k) for k in PARAMS}
    arrays = dict(inputs)
    for key in PARAMS:
        flat = weights.flatten(weights.from_jax(params[key], _configs(key)[0],
                                                "cpu"))
        arrays.update({f"{key}/{p}": t.numpy() for p, t in flat.items()})
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
         ",".join(REF_ARCHS)],
        stdout=log, stderr=subprocess.STDOUT, env=_env()))
    try:
        memo = {}
        tinputs = np.load(out / "inputs.npz")
        unsharded = {c["name"]: _unsharded(
            c, params[c.get("params", c["arch"])], tinputs, memo)
            for c in CASES}
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
    print(f"sharded families fixture: {time.perf_counter() - t0:.1f} s")
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


@pytest.mark.parametrize("name", ROUTED)
def test_sharded_moe_routes_as_unsharded(sharded_runs, name):
    """Each layer of the sharded prefill chose the unsharded prefill's
    experts for every row and token (as sets: top-k's order of equal
    probabilities is no choice)."""
    got, want = sharded_runs[0][name]
    layers = sorted(k for k in want if k.startswith("port/routes/"))
    assert layers and len(layers) == len(
        [k for k in got if k.startswith("routes/")])
    print(f"{name}: smallest top-k margin {float(want['port/margin']):.3e}")
    for k in layers:
        np.testing.assert_array_equal(
            np.sort(got[k[len("port/"):]], -1), np.sort(want[k], -1),
            err_msg=k)


@pytest.mark.parametrize("name", SERVE)
def test_sharded_prefill_and_decode_match(sharded_runs, name):
    got, want = sharded_runs[0][name]
    np.testing.assert_allclose(got["prefill_logits"],
                               want["port/prefill_logits"], **PORT_TOL)
    np.testing.assert_allclose(got["prefill_logits"],
                               want["ref/prefill_logits"], **REF_TOL)
    np.testing.assert_array_equal(got["tokens"], want["port/tokens"])


@pytest.mark.parametrize("arch", REF_ARCHS)
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dryrun_argument_bytes_equal_the_references_sharded_cells(
        sharded_runs, arch, kind):
    """The port's per-device argument bytes on a 2 x 2 mesh equal the
    reference's Auto-axes cells' (the arguments each step reads: jit drops
    the vlm prefill's embedding table and whisper decode's encoder and
    cross k/v weights); the reference keeps a train cell's step and a
    decode cell's position as int32 scalars (4 bytes each), the port as
    Python ints."""
    ref = sharded_runs[1][f"{arch}/{kind}"]
    assert ref["status"] == "ok", ref["error"]
    rec = dryrun.run_cell(arch, kind, mesh="2x2", reduced=True,
                          shape=configs.ShapeSpec(kind, kind, 256, 8),
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    scalar = 0 if kind == "prefill" else 4
    assert rec["memory"]["argument_size_in_bytes"] + scalar == \
        ref["memory"]["argument_size_in_bytes"]
    print(f"{arch} {kind}: collectives port {rec['collectives']}, "
          f"reference {ref['collectives']}")
