"""The port's dry-run (repro_torch.launch.dryrun) on meta tensors: the
reference's tests/test_dryrun.py on the port's side, then the records'
memory and kernel calls, the MoE layer's meta routing, the abstract
helpers of launch/steps.py, and count_params/model_flops against the
reference's."""
import dataclasses
import json
import math

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.analysis import roofline as jroofline
from repro.launch import steps as jsteps
from repro_torch import configs, weights
from repro_torch.analysis import cost, roofline
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import moe
from repro_torch.optim import optimizers

SMALL = configs.ShapeSpec("small_train", "train", 16, 4)


def _leaf_bytes(tree):
    return sum(t.numel() * t.element_size()
               for t in weights.flatten(tree).values()
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_reduced_train_cell_runs_on_meta(arch):
    """Every arch's reduced train step, 4 x 16 (frames for whisper,
    embeddings for the vlm), on 1x1: the default sys's 4 microbatches,
    remat block."""
    rec = dryrun.run_cell(arch, "small_train", reduced=True, shape=SMALL,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["sys"]["microbatches"] == 4 and rec["sys"]["remat"] == "block"
    assert rec["traced_microbatches"] == [2, 3]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["roofline"]["step_time_s"] > 0
    assert rec["per_device_gb"] > 0 and rec["fits"]
    json.dumps(rec)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_reduced_serve_cells(kind):
    shape = configs.ShapeSpec(kind, kind, 32, 2)
    rec = dryrun.run_cell("qwen3-0.6b", kind, reduced=True, shape=shape,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    L = configs.get_reduced("qwen3-0.6b").n_layers
    assert rec["kernels"] == ({"B1": L} if kind == "prefill" else {})
    assert rec["cost"]["flops"] > 0 and rec["roofline"]["step_time_s"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0


def test_extrapolated_microbatches_equal_the_whole_loop(monkeypatch):
    """A train cell of 6 microbatches counted from its 2- and 3-microbatch
    steps equals the step run whole, count for count."""
    shape = configs.ShapeSpec("t", "train", 16, 6)
    for arch in ("qwen3-0.6b", "qwen2-moe-a2.7b"):
        cut = dryrun.run_cell(arch, "t", reduced=True, shape=shape,
                              verbose=False)
        monkeypatch.setattr(dryrun, "_MAX_TRACED", 6)
        whole = dryrun.run_cell(arch, "t", reduced=True, shape=shape,
                                verbose=False)
        monkeypatch.undo()
        assert cut["traced_microbatches"] == [2, 3]
        assert whole["traced_microbatches"] is None
        for key in ("memory", "cost", "kernels", "roofline"):
            assert cut[key] == whole[key], key


def test_argument_bytes_are_the_state_and_the_batch():
    cfg = configs.get_reduced("qwen3-0.6b")
    rec = dryrun.run_cell("qwen3-0.6b", "small_train", reduced=True,
                          shape=SMALL, verbose=False)
    opt = optimizers.adamw(1e-3)
    state = steps.abstract_state(cfg, opt)
    batch = steps.input_specs(cfg, SMALL).tree
    assert rec["memory"]["argument_size_in_bytes"] == \
        _leaf_bytes(state) + _leaf_bytes(batch)
    # parameters in cfg.dtype, both adamw moments fp32
    n = sum(math.prod(s) for s in weights.leaf_shapes(cfg).values())
    assert _leaf_bytes(state) == 3 * 4 * n


@pytest.mark.parametrize("arch,kind", [("internvl2-26b", "prefill"),
                                       ("whisper-small", "decode")])
def test_unread_arguments_are_counted_apart(arch, kind):
    """The vlm's prefill starts from the adapter and reads no embedding
    table; whisper's decode reads no encoder weight and takes the cross
    attention's k and v from the cache. Those arguments are
    ``unused_argument_bytes``, out of ``argument_size_in_bytes`` (the
    reference's jit drops them) and in ``per_device_gb`` (the card holds
    them)."""
    cfg = configs.get_reduced(arch)
    shape = configs.ShapeSpec(kind, kind, 32, 2)
    rec = dryrun.run_cell(arch, kind, reduced=True, shape=shape,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    unread = [p for p in weights.leaf_shapes(cfg)
              if p == "embed" or p.startswith(("enc_", "dec_layers/cross/wk",
                                               "dec_layers/cross/wv"))]
    unread = [p for p in unread if (kind == "prefill") == (p == "embed")]
    want = sum(math.prod(weights.leaf_shapes(cfg)[p]) * 4 for p in unread)
    mem = rec["memory"]
    assert unread and mem["unused_argument_bytes"] == want
    assert rec["per_device_gb"] == round(
        (mem["argument_size_in_bytes"] + want + mem["temp_size_in_bytes"])
        / 2 ** 30, 3)


def test_kernel_calls_of_a_train_step():
    """B1, B2, B3 once a layer (use_pallas on, the port's default); under
    remat block with 2 microbatches B1 twice a layer and microbatch."""
    L = configs.get_reduced("qwen3-0.6b").n_layers
    plain = dryrun.run_cell("qwen3-0.6b", "small_train", reduced=True,
                            shape=SMALL, verbose=False,
                            sys_overrides=dict(microbatches=1, remat="none"))
    assert plain["sys"]["use_pallas"]
    assert plain["kernels"] == {"B1": L, "B2": L, "B3": L}
    remat = dryrun.run_cell("qwen3-0.6b", "small_train", reduced=True,
                            shape=SMALL, verbose=False,
                            sys_overrides=dict(microbatches=2, remat="block"))
    assert remat["kernels"] == {"B1": 2 * L * 2, "B2": L * 2, "B3": L * 2}
    off = dryrun.run_cell("qwen3-0.6b", "small_train", reduced=True,
                          shape=SMALL, verbose=False,
                          sys_overrides=dict(use_pallas=False))
    assert off["kernels"] == {}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_meshes_past_one_chip_run_every_family(mesh):
    """A dense cell runs on a production mesh as rank 0 of a fake group
    (one kv head and 32768 x 32 / dp rows a rank: B1 once a layer, the
    weights gathered). mixtral-8x22b (141 B parameters, more than one card
    holds) runs there too: its prefill launches B1 once a layer on a
    rank's own heads and fits. No family is skipped for want of a sharded
    step: recurrentgemma-9b's decode_32k cell (the recurrent states split
    on their channels, the attention's plain decode) runs and fits."""
    for arch in ("qwen3-0.6b", "mixtral-8x22b"):
        rec = dryrun.run_cell(arch, "prefill_32k", mesh=mesh, verbose=False)
        assert rec["status"] == "ok" and rec["mesh"] == mesh, \
            rec.get("traceback")
        assert rec["kernels"] == {"B1": configs.get_config(arch).n_layers}
        assert rec["fits"] and rec["collectives"]["all-gather"] > 0
        assert rec["roofline"]["chips"] == math.prod(
            int(d) for d in mesh.split("x"))
    hybrid = dryrun.run_cell("recurrentgemma-9b", "decode_32k", mesh=mesh,
                             verbose=False)
    assert hybrid["status"] == "ok" and hybrid["mesh"] == mesh, \
        hybrid.get("traceback")
    assert hybrid["fits"] and hybrid["kernels"] == {}
    assert not steps.MESH_ITEMS
    assert not torch.distributed.is_initialized()


def test_xlstm_decode_runs_sharded_at_16x16():
    """xlstm-350m's decode_32k on 16x16: the mLSTM's C q and n . q partial
    sums and the sLSTM's gathered pre-activations (one step) run as rank 0
    of a fake group; the cell fits and launches no kernel."""
    rec = dryrun.run_cell("xlstm-350m", "decode_32k", mesh="16x16",
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["fits"] and rec["kernels"] == {}
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["collectives"]["all-gather"] > 0
    assert not torch.distributed.is_initialized()


def test_long_500k_skips_full_attention_archs():
    rec = dryrun.run_cell("yi-34b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


def test_cli(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert "perdev=" in capsys.readouterr().out
    assert dryrun.main(["--both-meshes", "--arch", "qwen3-0.6b", "--shape",
                        "decode_32k", "--out", str(out)]) == 0
    assert [r["mesh"] for r in json.loads(out.read_text())] == \
        ["16x16", "2x16x16"]


def test_cli_cuts_depth(tmp_path):
    """``--layers`` runs a depth-cut cell (``chip_smoke.py``'s fake-rank
    cells): the record names the depth, and the arguments shrink with it."""
    out = tmp_path / "cut.json"
    args = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out",
            str(out)]
    assert dryrun.main(args + ["--layers", "2"]) == 0
    (cut,) = json.loads(out.read_text())
    assert dryrun.main(args) == 0
    (whole,) = json.loads(out.read_text())
    assert cut["status"] == whole["status"] == "ok"
    assert cut["layers"] == 2 and "layers" not in whole
    assert cut["memory"]["argument_size_in_bytes"] < \
        whole["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch,factor,capped", [
    ("qwen2-moe-a2.7b", 1.25, False), ("mixtral-8x22b", 0.5, True)])
def test_meta_moe_counts_the_balanced_routers_rows(arch, factor, capped,
                                                   monkeypatch):
    """On meta, each expert runs on B*T*k / E rows (the first n % E one
    more), capped at B*C; the same index_add_ combines them."""
    cfg = configs.get_reduced(arch)
    mc = dataclasses.replace(cfg.moe_cfg(), dropless=False,
                             capacity_factor=factor)
    B, T = 3, 16
    shapes = {p.split("moe/")[1]: s[1:]
              for p, s in weights.leaf_shapes(cfg).items() if "moe/" in p}
    params = weights.unflatten({p: torch.empty(s, device="meta")
                                for p, s in shapes.items()})
    rows = []
    expert = moe._expert
    monkeypatch.setattr(moe, "_expert", lambda p, e, x: (
        rows.append(x.shape[0]), expert(p, e, x))[1])
    x = torch.empty(B, T, mc.d_model, device="meta")
    with cost.CostMode() as mode:
        y, aux = moe.apply_moe(params, x, mc)
    n, E = B * T * mc.top_k, mc.n_experts
    C = max(1, int(-(-mc.top_k * T * mc.capacity_factor // E)))
    want = [min(B * C, n // E + (e < n % E)) for e in range(E)]
    assert rows == [r for r in want if r]
    assert (sum(want) < n) == capped
    assert y.shape == x.shape and aux.shape == ()
    d, f = mc.d_model, mc.d_ff
    routed = sum(want) * 3 * 2 * d * f
    shared = (B * T * 3 * 2 * d * moe.shared_d_ff(mc)) if mc.n_shared else 0
    router = 2 * B * T * d * E
    mm = mode.cost.fp32_flops      # the reduced configs are fp32
    assert mm == routed + shared + router


def test_count_params_and_model_flops_equal_the_reference():
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        jparams = jax.eval_shape(
            lambda: jsteps.model_init(jax.random.PRNGKey(0), jcfg))
        params = steps.abstract_state(cfg, optimizers.sgd(1e-3))["params"]
        frac = (cfg.top_k / cfg.n_experts
                if getattr(cfg, "n_experts", 0) else None)
        assert roofline.count_params(params, frac) == \
            jroofline.count_params(jparams, frac), arch
        for name in configs.SHAPES:
            assert roofline.model_flops(cfg, configs.SHAPES[name], params) \
                == jroofline.model_flops(jcfg, jconfigs.SHAPES[name],
                                         jparams), (arch, name)


def test_model_flops_moe_uses_active_params():
    cfg = configs.get_config("mixtral-8x22b")
    total, active = roofline.count_params(weights.leaf_shapes(cfg),
                                          cfg.top_k / cfg.n_experts)
    assert total > 100e9           # ~141B
    assert active < 0.45 * total   # 2-of-8 experts + dense trunk


def test_shape_applicability_matrix():
    table = {a: [s for s in configs.SHAPES
                 if configs.shape_applicable(configs.get_config(a),
                                             configs.SHAPES[s])]
             for a in configs.ARCH_IDS}
    assert "long_500k" in table["mixtral-8x22b"]
    assert "long_500k" in table["recurrentgemma-9b"]
    assert "long_500k" in table["xlstm-350m"]
    assert "long_500k" not in table["yi-34b"]
    assert "long_500k" not in table["whisper-small"]
    runnable = sum(len(v) for v in table.values())
    assert runnable == 33          # 40 cells - 7 documented skips
    assert configs.SHAPES == {k: configs.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jconfigs.SHAPES.items()}


# --------------------------------------------------------------------------
# the abstract helpers of launch/steps.py


def test_abstract_helpers_match_the_reference_shapes_and_dtypes():
    arch = "qwen3-0.6b"
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape = configs.SHAPES["decode_32k"]
    got = steps.cache_specs_abstract(cfg, shape).tree
    want = jsteps.cache_specs_abstract(jcfg, jconfigs.SHAPES["decode_32k"])
    flat = weights.flatten(got)
    jflat = weights.flatten(want)
    assert set(flat) == set(jflat)
    for p, t in flat.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jflat[p].shape)
        assert str(t.dtype).split(".")[1] == str(jflat[p].dtype)
    for name in configs.SHAPES:
        io = steps.input_specs(cfg, configs.SHAPES[name]).tree
        jio = jsteps.input_specs(jcfg, jconfigs.SHAPES[name])
        assert set(io) == set(jio)
        for k, t in io.items():
            if k != "pos":
                assert tuple(t.shape) == tuple(jio[k].shape)
                assert t.dtype == torch.int32


def test_abstract_specs_come_from_the_sharding_rules():
    cfg = configs.get_config("qwen3-0.6b")
    mesh = abstract_mesh(16, 16)
    sys = steps.default_sys(cfg, configs.SHAPES["train_4k"])
    opt = optimizers.adamw(1e-3)
    state = steps.state_specs_abstract(cfg, opt, mesh, sys)
    assert state.specs == sharding.state_specs(state.tree, cfg, mesh, sys)
    params = steps.param_specs_abstract(cfg, mesh, sys)
    assert params.specs == state.specs["params"]
    io = steps.input_specs(cfg, configs.SHAPES["train_4k"], mesh)
    assert io.specs == {"tokens": ("data", None), "labels": ("data", None)}
    one = steps.input_specs(cfg, configs.SHAPES["long_500k"], mesh)
    assert one.specs["tokens"] == (None, None)     # a batch of 1 replicates
    assert steps.input_specs(cfg, configs.SHAPES["train_4k"]).specs is None
    moments = weights.flatten(state.tree["opt"])
    assert {t.dtype for t in moments.values()} == {torch.float32}
