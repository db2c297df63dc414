"""The port's cost analysis (repro_torch.analysis.cost): the reference's
tests/test_hlo_analysis.py case for case, on meta tensors counted by the
dispatch mode, then the live-storage tracker, the kernels' meta branches
and bounds, and flop parity with the reference's HLO analysis."""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from repro import configs as jconfigs
from repro.analysis import hlo_analysis
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.analysis import cost, roofline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fa_bwd
from repro_torch.kernels import mlstm as ml
from repro_torch.kernels import rglru as rg
from repro_torch.launch import steps
from repro_torch.models.transformer import SystemConfig


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _analyze(fn, *args):
    return cost.count(fn, *args)[1].cost


def test_plain_dot_flops():
    c = _analyze(lambda a, b: a @ b, _meta(128, 256), _meta(256, 64))
    assert c.flops == 2 * 128 * 256 * 64


def test_loop_multiplies_by_trip_count():
    def f(x, w):
        for _ in range(17):
            x = x @ w
        return x
    c = _analyze(f, _meta(128, 128), _meta(128, 128))
    assert c.flops == 2 * 128 * 128 * 128 * 17


def test_nested_loop_trips():
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    c = _analyze(f, _meta(64, 64), _meta(64, 64))
    assert c.flops == 2 * 64 ** 3 * 15


def test_score_like_classifier():
    assert cost._is_score_like((4, 2, 1024, 1024))
    assert cost._is_score_like((1, 1, 2, 1024, 2048))
    assert not cost._is_score_like((1024, 1024))           # rank 2
    assert not cost._is_score_like((1, 4096, 1024))        # rank 3
    assert not cost._is_score_like((4, 2, 4096, 128))


def test_collective_counted_by_kind(tmp_path):
    """A world-1 gloo all-reduce of a 128 x 256 fp32 tensor: its operand
    bytes under "all-reduce", one collective; the functional collective
    counts the same."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        x = torch.ones(128, 256)
        with cost.CostMode() as mode:
            dist.all_reduce(x)
        with cost.CostMode() as functional:
            y = torch.distributed._functional_collectives.all_reduce(
                x, "sum", dist.group.WORLD)
            y.wait() if hasattr(y, "wait") else y
    finally:
        dist.destroy_process_group()
    assert mode.cost.coll["all-reduce"] == 128 * 256 * 4 == 131_072
    assert mode.cost.coll_count == 1
    assert mode.cost.coll_bytes == 131_072
    assert functional.cost.coll == mode.cost.coll
    assert functional.cost.coll_count == 1


def test_dtensor_all_to_all_counted_as_all_to_all():
    """A meta DTensor moved from Shard(0) to Shard(1) over a mesh dim of 2
    on the dry-run's fake group: one all-to-all of the local shard's bytes
    (8 x 16 fp32 of a 16 x 16), as the card's DTensor runs it; no
    all-gather stands in for it."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import dryrun, mesh as mesh_lib
    with dryrun.fake_group(mesh_lib.abstract_mesh(1, 2)) as mesh:
        x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                               (Shard(0), Shard(0)), run_check=False)
        with cost.CostMode() as mode:
            y = x.redistribute(mesh, (Shard(0), Shard(1)))
        assert tuple(y.to_local().shape) == (16, 8)
    assert not dist.is_initialized()
    assert mode.cost.coll["all-to-all"] == 8 * 16 * 4
    assert mode.cost.coll["all-gather"] == 0
    assert mode.cost.coll_count == 1


def test_a_collectives_result_stays_counted_while_it_lives():
    """A meta DTensor's partial sum reduced (Partial -> Replicate) on the
    dry-run's fake group: on meta the step goes on with the collective's
    autograd wrapper, whose storage is its own, so the all-reduce's output
    is kept alive, and counted, as long as the result lives (a card's step
    goes on using that output itself)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.launch import dryrun, mesh as mesh_lib
    mib = 1024 * 1024
    with dryrun.fake_group(mesh_lib.abstract_mesh(2, 2)) as mesh:
        x = DTensor.from_local(torch.empty(512, 512, device="meta"), mesh,
                               (Partial(), Replicate()), run_check=False)
        with cost.CostMode() as mode:
            y = x.redistribute(mesh, (Replicate(), Replicate()))
            held = mode.live_bytes
            z = y.to_local() * 2
            both = mode.live_bytes
            del y
            after = mode.live_bytes
        del z
    assert not dist.is_initialized()
    assert (held, both, after) == (mib, 2 * mib, mib)


def test_a_loops_functional_all_gather_is_counted_and_kept():
    """``spmd.gather_last`` (the sLSTM's per-step gather: an autograd
    functional all-gather on local tensors, issued inside ``local_apply``)
    on the dry-run's fake group over a "model" dim of 4: one all-gather of
    the local columns' bytes (4 x 128 bf16), the whole result (4 x 512)
    counted while it lives. Either namespace of the autograd op counts as
    an all-gather."""
    from repro_torch import spmd
    from repro_torch.launch import dryrun, mesh as mesh_lib
    for name in ("_c10d_functional", "_c10d_functional_autograd"):
        op = getattr(torch.ops, name).all_gather_into_tensor.default
        assert cost._rule(op).collective == "all-gather"
    with dryrun.fake_group(mesh_lib.abstract_mesh(1, 4)) as mesh:
        t = torch.empty(4, 128, dtype=torch.bfloat16, device="meta")
        with cost.CostMode() as mode:
            g = spmd.gather_last(t, mesh, 1, 4)
            assert tuple(g.shape) == (4, 512)
            held = mode.live_bytes
            del g
            after = mode.live_bytes
    assert not dist.is_initialized()
    assert mode.cost.coll["all-gather"] == 4 * 128 * 2
    assert mode.cost.coll_count == 1
    assert held >= 4 * 512 * 2 and after < 4 * 512 * 2


def test_slstm_counts_one_all_gather_a_step():
    """Reduced xlstm-350m (d_inner 128, one sLSTM) prefilled on a 1 x 4
    mesh at 16 and 32 tokens: the 16 more time steps add 16 all-gathers of
    a rank's pre-activation columns, 4 rows x 512 / 4 columns in bf16
    (1024 bytes) each, and no other collective (the row-parallel
    all-reduces grow with the tokens, not in number)."""
    from repro_torch.launch import dryrun
    recs = [dryrun.run_cell("xlstm-350m", "p", mesh="1x4", reduced=True,
                            shape=configs.ShapeSpec("p", "prefill", n, 4),
                            verbose=False) for n in (16, 32)]
    assert all(r["status"] == "ok" for r in recs), recs
    cfg = configs.get_reduced("xlstm-350m")
    step = 4 * (4 * cfg.mlstm_cfg().d_inner // 4) * 2
    more = {k: recs[1]["collectives"][k] - recs[0]["collectives"][k]
            for k in recs[0]["collectives"]}
    assert more["all-gather"] == 16 * step * cfg.ssm_groups
    assert more["all-reduce"] > 0
    assert not any(more[k] for k in ("reduce-scatter", "all-to-all",
                                     "collective-permute"))
    assert recs[1]["collective_count"] - recs[0]["collective_count"] == \
        16 * cfg.ssm_groups


@pytest.mark.parametrize("op", ["gather", "index"])
def test_autograds_scatter_into_its_own_zeros_counts_one_buffer(op):
    """gather's and index's backward make zeros and scatter into them in
    place; under the mode autograd takes the out-of-place scatter, whose
    result is counted in the zeros' place: one buffer of the input's size
    at the peak, not two."""
    mib4 = 1024 * 1024 * 4
    x = torch.empty(1024, 1024, device="meta", requires_grad=True)
    idx = torch.zeros(1024, 1, dtype=torch.long, device="meta")
    rows = torch.zeros(8, dtype=torch.long, device="meta")
    with cost.CostMode() as mode:
        y = torch.gather(x, 1, idx) if op == "gather" else x[rows]
        y.sum().backward()
    assert mib4 <= mode.peak_bytes < mib4 + 64 * 1024


def test_a_scatter_into_zeros_outside_autograd_counts_both():
    """Zeros made by the step itself may stay live after an out-of-place
    scatter into them: the zeros and the result count apart."""
    mib4 = 1024 * 1024 * 4
    idx = torch.zeros(1024, 1, dtype=torch.long, device="meta")
    src = torch.empty(1024, 1, device="meta")
    with cost.CostMode() as mode:
        z = x = torch.zeros(1024, 1024, device="meta")
        y = z.scatter_add(1, idx, src)
        live = mode.live_bytes
    del x, y, z
    assert live == 2 * mib4


def test_arguments_no_op_reads_are_counted_apart():
    """An argument that only a view touched is unread: the reference's jit
    drops it from the executable's arguments."""
    a, b = _meta(256, 256), _meta(512, 512)
    _, mode = cost.count(lambda a, b: (a * 2, b.view(-1)), a, b)
    assert mode.argument_bytes == (256 * 256 + 512 * 512) * 4
    assert mode.unused_argument_bytes == 512 * 512 * 4


def test_bytes_nonzero_and_sane():
    c = _analyze(lambda x: (x * 2 + 1).sum(), _meta(256, 256))
    assert c.bytes >= 256 * 256 * 4          # at least one read
    assert c.bytes < 50 * 256 * 256 * 4      # not absurdly overcounted


def test_views_and_allocations_move_no_bytes():
    c = _analyze(lambda x: (x.view(64, 1024).t().unsqueeze(0)[0, :2],
                            torch.empty_like(x)), _meta(256, 256))
    assert c.bytes == 0 and c.flops == 0


# --------------------------------------------------------------------------
# live storages


def test_peak_of_a_matmul_chain_by_hand():
    """x (argument) and five products x1..x5 of 1 MiB each: x_{i+1} is made
    while x_i lives, then x_i dies, so two products are alive at most; the
    last one is the output. A discarded 3 MiB temporary on the way peaks
    above that."""
    mib = 1024 * 1024
    w, x = _meta(512, 512), _meta(512, 512)

    def chain(x, w):
        for i in range(5):
            x = x @ w
            if i == 2:
                tmp = torch.cat([x, x, x])       # 3 MiB beside x3
                del tmp
        return x
    out, mode = cost.count(chain, x, w)
    assert mode.argument_bytes == 2 * mib
    assert mode.peak_bytes == 4 * mib        # x3 and the 3 MiB cat
    assert mode.live_bytes == mib            # x5, the result
    assert mode.output_bytes(out) == mib


def test_peak_sees_autograd_saved_tensors():
    """Saved activations live until the backward frees them: the forward's
    peak holds every layer's input."""
    mib = 1024 * 1024
    ws = [torch.empty(512, 512, device="meta", requires_grad=True)
          for _ in range(4)]
    x = _meta(512, 512)

    def step(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        grads = torch.autograd.grad(x.sum(), ws)
        return grads
    out, mode = cost.count(step, x, ws)
    # the forward keeps the four tanh outputs (each tanh's backward and the
    # next product need it) and holds a fifth MiB while it makes the last
    # one; the backward frees them as it goes
    assert mode.peak_bytes >= 5 * mib
    assert mode.output_bytes(out) == 4 * mib


# --------------------------------------------------------------------------
# the kernels' meta branches and bounds


@pytest.mark.parametrize("kernel,shape,dtype,ms", [
    ("B1", (8, 2048, 8, 2, 128), torch.bfloat16, 0.1390),
    ("B2", (4, 2048, 8, 2, 128), torch.bfloat16, 0.1043),
    ("B3", (4, 2048, 8, 2, 128), torch.bfloat16, 0.1390),
    ("B4", (8, 2048, 4, 512), torch.float32, 1.0297),
    ("B5", (8, 2048, 4096), torch.float32, 0.2404)])
def test_kernel_bounds_equal_perf_md(kernel, shape, dtype, ms):
    """Each kernel's bound at PERF.md section 6's shape equals its bound
    column (4 decimals)."""
    size = torch.empty((), dtype=dtype).element_size()
    if kernel == "B4":
        work = roofline.mlstm_work(*shape, size)
    elif kernel == "B5":
        work = roofline.rglru_work(*shape)
    else:
        B, S, K, G, D = shape
        work = roofline.flash_work(kernel, B, S, S, K, G, D, size)
    got, by = roofline.kernel_bound(work)
    assert round(got, 4) == ms
    assert by == ("bytes" if kernel == "B5" else "operations")


def test_flash_meta_reports_work_and_launches_nothing():
    B, S, K, G, D = 2, 96, 2, 3, 64
    q = _meta(B, S, K, G, D, dtype=torch.bfloat16)
    k, v = (_meta(B, S, K, D, dtype=torch.bfloat16) for _ in range(2))
    before = (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv)
    with cost.CostMode() as mode:
        out, lse = fa.flash_attention(q, k, v, window=32, return_lse=True)
        dq, dk, dv = fa_bwd.flash_attention_bwd(q, k, v, out, lse, out,
                                                window=32)
    assert (out.shape, out.dtype) == (q.shape, q.dtype)
    assert (lse.shape, lse.dtype) == ((B, S, K, G), torch.float32)
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    assert all(t.device.type == "meta" for t in (out, lse, dq, dk, dv))
    assert (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv) == before
    kernels = mode.cost.kernels
    assert {n: w["calls"] for n, w in kernels.items()} == {
        "B1": 1, "B2": 1, "B3": 1}
    for name in ("B1", "B2", "B3"):
        want = roofline.flash_work(name, B, S, S, K, G, D, 2, True, 32)
        assert (kernels[name]["flops"], kernels[name]["bytes"]) == \
            (want.flops, want.bytes)
    # the visible pairs of a causal window of 32 over 96 queries
    assert roofline.visible_pairs(96, 96, True, 32) == \
        sum(min(s + 1, 32) for s in range(96))


def test_recurrent_meta_reports_work_and_launches_nothing():
    before = (ml.launches, rg.launches)
    q, k, v = (_meta(2, 64, 2, 32) for _ in range(3))
    ig, fg = _meta(2, 64, 2), _meta(2, 64, 2)
    la, b, h0 = _meta(2, 64, 48), _meta(2, 64, 48), _meta(2, 48)
    with cost.CostMode() as mode:
        h = ml.mlstm_chunkwise(q, k, v, ig, fg, chunk=32)
        hs, h_last = rg.rglru_scan(la, b, h0)
    assert h.shape == q.shape and hs.shape == la.shape
    assert h_last.shape == (2, 48) and hs.dtype == torch.float32
    assert (ml.launches, rg.launches) == before
    k4, k5 = mode.cost.kernels["B4"], mode.cost.kernels["B5"]
    assert k4["calls"] == k5["calls"] == 1
    assert k4["flops"] == roofline.mlstm_work(2, 64, 2, 32, 4).flops
    assert k5["bytes"] == roofline.rglru_work(2, 64, 48, h0=True).bytes
    # B4's and B5's work is fp32: it counts at the fp32 peak
    assert mode.cost.fp32_flops >= k4["flops"] + k5["flops"]


def test_meta_calls_on_mixed_devices_still_raise():
    q = torch.zeros(1, 8, 1, 1, 16)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k.to("meta"))


# --------------------------------------------------------------------------
# parity with the reference's HLO analysis


def test_flops_match_reference_hlo_analysis():
    """Full-width qwen3-0.6b prefill of 1 x 256 tokens, plain attention
    (use_pallas off), no mesh: the port's counted flops against
    ``hlo_analysis.analyze`` of the reference's compiled step (2.4146e11;
    the port counted 0.99974 of it when this test was written)."""
    jcfg = jconfigs.get_config("qwen3-0.6b")
    jstep = jsteps.make_prefill_step(jcfg, JT.SystemConfig(use_pallas=False))
    jparams = jax.eval_shape(
        lambda: jsteps.model_init(jax.random.PRNGKey(0), jcfg))
    hlo = jax.jit(jstep).lower(
        jparams, {"tokens": jax.ShapeDtypeStruct((1, 256), jnp.int32)}
    ).compile().as_text()
    want = hlo_analysis.analyze(hlo).flops

    cfg = configs.get_config("qwen3-0.6b")
    sys = SystemConfig(use_pallas=False)
    shape = configs.ShapeSpec("p", "prefill", 256, 1)
    params = steps._meta_params(cfg)
    batch = steps.input_specs(cfg, shape).tree
    got = cost.count(steps.make_prefill_step(cfg, sys), params,
                     batch)[1].cost.flops
    assert abs(got / want - 1) < 0.05, (got, want)
