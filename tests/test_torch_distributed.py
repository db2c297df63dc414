"""The port's distributed layer against the reference, on the CPU.

* Compression: ``repro_torch.distributed.compression`` against
  ``repro.distributed.compression`` on seeded numpy inputs: int8 payloads
  and scales exactly, top-k masks equal, error-feedback residuals at 1e-6.
* Sharding rules: ``param_specs``, ``state_specs``, ``cache_specs`` and
  ``batch_specs`` equal the reference's for every arch of ``ARCH_IDS`` at
  full width, on meshes (1,1), (2,4), (16,16) and (2,16,16), with both
  ``param_sharding`` values. The reference gets a stand-in mesh (axis names
  and ``devices=np.empty(shape)``) and ``jax.eval_shape`` trees; the port an
  ``AbstractMesh`` and meta tensors (caches built under ``FakeTensorMode``,
  since ``init_cache`` takes only cpu or cuda), so no 256 devices are needed.
* Four gloo ranks (``tests/torch_dist_worker.py``, one process each, a
  ``FileStore`` in the test's own directory, every wait bounded):
  ``compressed_grad_mean`` against the reference run on 4 XLA host devices
  in a subprocess (as ``tests/test_collectives.py``), at 1e-6;
  ``reshard_state`` over (4,1) -> (2,2) -> (1,4), a checkpoint restored onto
  (2,2) with ``placements=``, and an uneven dim over ("pod", "data"): the
  logical arrays bit for bit, each rank's shard the shape its spec gives.
"""
import functools
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
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SPAWN_TIMEOUT_S = 180


# ------------------------------------------------------------ compression

def _inputs(seed, shape=(64, 32)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", ["randn", "halves", "zeros", "vector"])
def test_quantize_int8_matches_reference(case):
    x = {"randn": _inputs(0), "zeros": np.zeros((4, 8), np.float32),
         "vector": _inputs(1, (37,)),
         # x / scale lands on .5 exactly: both round half to even
         "halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5],
                            np.float32)}[case]
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_matches_reference(frac):
    x = _inputs(2)
    x[0, :8] = x[1, :8] = 3.0          # ties at the threshold keep more
    jv, jm = jcomp.topk_sparsify(jnp.asarray(x), frac)
    tv, tm = tcomp.topk_sparsify(torch.from_numpy(x), frac)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
def test_compress_grads_error_feedback_matches_reference(method):
    shapes = {"w": (64, 32), "b": (32,), "layers": (2, 16, 8)}
    jef = jcomp.init_ef({k: jnp.zeros(s) for k, s in shapes.items()})
    tef = tcomp.init_ef({k: torch.zeros(s) for k, s in shapes.items()})
    for step in range(3):
        g = {k: _inputs(10 * step + i, s)
             for i, (k, s) in enumerate(shapes.items())}
        jg, jef = jcomp.compress_grads({k: jnp.asarray(v) for k, v in
                                        g.items()}, jef, method, 0.05)
        tg, tef = tcomp.compress_grads({k: torch.from_numpy(v) for k, v in
                                        g.items()}, tef, method, 0.05)
        for k in shapes:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    grads = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    assert tcomp.compressed_bytes(
        {k: torch.from_numpy(v) for k, v in grads.items()}, method, 0.05) \
        == jcomp.compressed_bytes(
            {k: jnp.asarray(v) for k, v in grads.items()}, method, 0.05)


# --------------------------------------------------------- sharding rules

class _FakeMesh:
    """The reference's rule engine reads axis names and devices.shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = {"1x1": (1, 1, 1), "2x4": (2, 4, 1), "16x16": (16, 16, 1),
          "2x16x16": (16, 16, 2)}


def _meshes(name):
    m = tmesh.abstract_mesh(*MESHES[name])
    return _FakeMesh(m.shape, m.mesh_dim_names), m


def _ref_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jsharding._path_str(path): tuple(s) for path, s in flat}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jconfigs.get_config(arch)
    return cfg, jax.eval_shape(
        lambda: jsteps.model_init(jax.random.PRNGKey(0), cfg))


def _port_params(arch):
    cfg = tconfigs.get(arch)
    return cfg, weights.unflatten({
        p: torch.empty(s, device="meta")
        for p, s in weights.leaf_shapes(cfg).items()})


@pytest.mark.parametrize("param_sharding", ["2d", "tp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_and_state_specs_match_reference(arch, mesh, param_sharding):
    jmesh, tm = _meshes(mesh)
    jcfg, jparams = _ref_params(arch)
    tcfg, tparams = _port_params(arch)
    jsys = JT.SystemConfig(param_sharding=param_sharding)
    tsys = TT.SystemConfig(param_sharding=param_sharding)
    want = _ref_flat(jsharding.param_specs(jparams, jcfg, jmesh, jsys))
    got = weights.flatten(tsharding.param_specs(tparams, tcfg, tm, tsys))
    assert got == want
    jstate = {"params": jparams, "opt": {"m": jparams, "v": jparams},
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    tstate = {"params": tparams, "opt": {"m": tparams, "v": tparams},
              "step": 0}
    want = _ref_flat(jsharding.state_specs(jstate, jcfg, jmesh, jsys))
    got = weights.flatten(tsharding.state_specs(tstate, tcfg, tm, tsys))
    assert got == want and got["step"] == ()


@functools.lru_cache(maxsize=None)
def _ref_cache(arch):
    cfg = jconfigs.get_config(arch)
    init = jencdec.init_cache if jsteps.is_encdec(cfg) else \
        JT.init_cache
    return cfg, jax.eval_shape(lambda: init(cfg, 128, 1024))


def _port_cache(arch):
    cfg = tconfigs.get(arch)
    init = tencdec.init_cache if tsteps.is_encdec(cfg) else TT.init_cache
    with FakeTensorMode():
        return cfg, init(cfg, 128, 1024, device="cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    jmesh, tm = _meshes(mesh)
    jcfg, jcache = _ref_cache(arch)
    tcfg, tcache = _port_cache(arch)
    want = _ref_flat(jsharding.cache_specs(jcache, jcfg, jmesh))
    got = weights.flatten(tsharding.cache_specs(tcache, tcfg, tm))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_reference(mesh):
    jmesh, tm = _meshes(mesh)
    jb = {"tokens": jax.ShapeDtypeStruct((256, 4096), jnp.int32),
          "frames": jax.ShapeDtypeStruct((256, 1500, 80), jnp.float32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    assert tsharding.batch_specs(tb, tm) == _ref_flat(
        jsharding.batch_specs(jb, jmesh))


@pytest.mark.parametrize("shape,prefs", [
    ((5, 64), [["fsdp~"], ["model~"]]),        # padded: 5 rows over 4 ranks
    ((3, 64), [["fsdp~"], ["model"]]),         # padding would pass 2x
    ((24, 6), [["model", "fsdp"], ["fsdp~"]]),
    ((8, 8), [[None], ["fsdp", "model"]]),
])
@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
@pytest.mark.parametrize("param_sharding", ["2d", "tp"])
def test_rule_engine_matches_reference(shape, prefs, mesh, param_sharding):
    jmesh, tm = _meshes(mesh)
    want = jsharding.RuleEngine(
        jmesh, JT.SystemConfig(param_sharding=param_sharding)).spec(
        shape, prefs)
    got = tsharding.RuleEngine(
        tm, TT.SystemConfig(param_sharding=param_sharding)).spec(
        shape, prefs)
    assert got == tuple(want)


def test_placements_from_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.abstract_mesh(2, 4, pods=2)
    R = Replicate()
    assert tsharding.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert tsharding.placements(("data", None), m) == (R, Shard(0), R)
    assert tsharding.placements((), m) == (R, R, R)
    with pytest.raises(ValueError, match="mesh's order"):
        tsharding.placements((("data", "pod"),), m)


def test_meshes_need_a_process_group_and_the_right_world():
    assert tmesh.abstract_production_mesh() == ((16, 16), ("data", "model"))
    assert tmesh.abstract_production_mesh(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.single_device_mesh(device="cpu")


# ------------------------------------------------------- four gloo ranks

_JAX_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.distributed.collectives import compressed_grad_mean
grads = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4,), ("data",))
out = {}
for method in ("none", "int8"):
    mean = compressed_grad_mean(grads, mesh, method=method)
    out.update({f"{method}/{k}": np.asarray(v) for k, v in mean.items()})
np.savez(sys.argv[2], **out)
"""


def _env():
    path = str(ROOT / "src")
    old = os.environ.get("PYTHONPATH")
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": path + (os.pathsep + old if old else "")}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Runs the JAX reference and the four gloo ranks, all at once; returns
    (out dir, the ranks' reports, the reference's means)."""
    out = tmp_path_factory.mktemp("gloo")
    rng = np.random.RandomState(0)
    np.savez(out / "grads.npz", w=rng.randn(WORLD, 64, 32).astype(np.float32),
             b=rng.randn(WORLD, 32).astype(np.float32))
    logs = [open(out / f"log{r}.txt", "w") for r in range(WORLD + 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_REFERENCE, str(out / "grads.npz"),
         str(out / "ref.npz")], stdout=logs[WORLD],
        stderr=subprocess.STDOUT, env=_env())]
    procs += [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(out)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=_env()) for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=SPAWN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(codes):
        logs = "\n".join((out / f"log{r}.txt").read_text()[-3000:]
                         for r in range(WORLD + 1))
        pytest.fail(f"exit codes {codes}:\n{logs}")
    reports = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    return out, reports, dict(np.load(out / "ref.npz"))


@pytest.mark.parametrize("method", ["none", "int8"])
def test_gloo_compressed_grad_mean_matches_reference(gloo_run, method):
    out, _, ref = gloo_run
    for r in range(WORLD):
        got = np.load(out / f"coll{r}.npz")
        for k in ("w", "b"):
            key = f"{method}/{k}"
            assert got[key].shape == ref[key].shape
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_array_equal(got[key], np.load(
                out / "coll0.npz")[key])


def _local_shape(shape, spec, names, mesh_shape, coord):
    """A shard's shape under DTensor's chunks: for each tensor dim, the
    mesh dims its spec names, in mesh order, each taking torch.chunk's
    piece of what the last left."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in entry if isinstance(entry, list) else [entry]:
            if axis is None:
                continue
            i = names.index(axis)
            c = -(-out[d] // mesh_shape[i])
            out[d] = max(0, min(c, out[d] - coord[i] * c))
    return out


def _global_shapes():
    shapes = weights.leaf_shapes(tconfigs.get_reduced("qwen3-0.6b"))
    return {f"{pre}/{p}": list(s) for pre in ("params", "opt/m", "opt/v")
            for p, s in shapes.items()}


@pytest.mark.parametrize("run", ["reshard_4x1", "reshard_2x2",
                                 "reshard_1x4", "restore_2x2"])
def test_gloo_state_on_mesh_is_exact_and_sharded_by_spec(gloo_run, run):
    _, reports, _ = gloo_run
    shapes = _global_shapes()
    sharded = set()
    for rep in (r[run] for r in reports):
        leaves = rep["leaves"]
        assert leaves.pop("step") == [None, None, True]
        assert set(leaves) == set(shapes)
        for path, (spec, local, exact) in leaves.items():
            assert exact, path
            assert local == _local_shape(shapes[path], spec, rep["names"],
                                         rep["shape"], rep["coord"]), path
            if local != shapes[path]:
                sharded.add(path)
    # every mesh but a 1-wide one splits the big leaves
    assert "params/layers/mlp/w_gate" in sharded


def test_gloo_uneven_dim_over_two_mesh_dims(gloo_run):
    """5 rows over ("pod", "data") on 2 x 2: DTensor's nested chunks 2, 1,
    1, 1 in the ranks' order, the array exact."""
    _, reports, _ = gloo_run
    rows = {}
    for rep in (r["uneven_pod_data"] for r in reports):
        spec, local, exact = rep["leaves"]["x"]
        assert exact
        assert local == _local_shape([5, 2], spec, rep["names"],
                                     rep["shape"], rep["coord"])
        rows[tuple(rep["coord"])] = local[0]
    assert [rows[c] for c in sorted(rows)] == [2, 1, 1, 1]


def test_gloo_reshard_params_places_as_the_restore(gloo_run):
    assert all(r["reshard_params_2x2"] for r in gloo_run[1])


def test_gloo_production_mesh_refuses_four_ranks(gloo_run):
    assert all(r["production_mesh_refused"] for r in gloo_run[1])
