"""Dry-run: run every (arch x shape) cell's real step on meta tensors and
describe it on one NVIDIA H100. The counterpart of ``repro.launch.dryrun``.

For each cell this runs the port's step function (train / prefill /
decode) on meta inputs (``launch.steps``' abstract helpers) under
``analysis.cost.CostMode``: no tensor is allocated, on any device, and no
card is needed. The kernels' wrappers take their meta branches, so they
report their work instead of launching. It records:
  * memory  -- the step's arguments and the peak bytes its own allocations
    hold (argument + unused argument + temp = the step's peak): does the
    cell fit the card? ``argument_size_in_bytes`` counts the arguments the
    step reads, as the reference's (jit drops unused arguments);
    ``unused_argument_bytes`` the ones it holds unread (the vlm's
    embedding table in a prefill, whisper's encoder in a decode).
  * cost    -- flops, bytes, transcendentals and the kernels' calls,
  * collective bytes by kind,
  * the roofline (``analysis.roofline``) on the card.

It is a prediction: the reference's dry-run compiles for a TPU it does not
run on, and this one describes a card it does not touch.

A mesh past 1x1 (``--mesh 16x16``, ``--multi-pod``, ``--both-meshes``: the
reference's production meshes) runs the sharded step (``launch.steps``
with a ``DeviceMesh``) as rank 0 of that many: a ``fake`` process group
(``FakeStore``, rank 0, world = the mesh's size) is started for the cell,
the state, batch and cache are meta DTensors placed by
``distributed.sharding``, and every count is rank 0's own (its local ops
and the collectives it issues; the fake collectives move nothing). Rank 0
holds ``torch.chunk``'s largest piece of an uneven split, so its peak is
the per-device bound. The group is destroyed at the end of the cell; a
process that already has a group is refused. Every family has a sharded
step; a family without one would be recorded as skipped, naming its item
(``steps.MESH_ITEMS``; ROADMAP.md, "Configurations the port does not
run"). On meta tensors an MoE layer routes as a balanced router would
(``models.moe.balanced_route``). An sLSTM's time loop runs step by step on
meta as on a device: xlstm-350m's train_4k and prefill_32k cells take
4,096 and 32,768 steps a layer, many minutes each.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-moe-a2.7b \
      --shape train_4k --mesh 16x16 --layers 4     # a depth-cut cell
  python -m repro_torch.launch.dryrun --all [--mesh 16x16] [--out EXP.json]
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import configs
from repro_torch.analysis import cost as cost_lib
from repro_torch.analysis import roofline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.optim import optimizers


def _abstract_mesh(mesh) -> mesh_lib.AbstractMesh:
    """None (1x1), "AxB" or "PxAxB", or anything with ``shape`` and
    ``mesh_dim_names``."""
    if mesh is None:
        mesh = "1x1"
    if isinstance(mesh, str):
        dims = tuple(int(d) for d in mesh.split("x"))
        if len(dims) == 2:
            return mesh_lib.abstract_mesh(dims[0], dims[1])
        if len(dims) == 3:
            return mesh_lib.abstract_mesh(dims[1], dims[2], dims[0])
        raise ValueError(f"mesh {mesh!r}: AxB or PxAxB")
    return mesh_lib.AbstractMesh(tuple(mesh.shape),
                                 tuple(mesh.mesh_dim_names))


_MAX_TRACED = 3     # microbatches a train cell runs at most (see _train)


@contextlib.contextmanager
def fake_group(amesh: mesh_lib.AbstractMesh):
    """Rank 0 of a ``fake`` process group as large as ``amesh``, and the
    ``DeviceMesh`` over it (None for one chip: no group). Its collectives
    complete at once and write nothing. The group is destroyed on exit.

    The mesh is a "cuda" one on any host (the fake group touches no
    device): its device type picks DTensor's collectives, and the card's
    are what a cell predicts. On a "cpu" mesh DTensor stands an
    all-gather and a chunk in for each all-to-all (gloo has none), which
    would count an all-to-all's bytes as a larger all-gather."""
    world = math.prod(amesh.shape)
    if world == 1:
        yield None
        return
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "this process already has one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield init_device_mesh("cuda", amesh.shape,
                               mesh_dim_names=amesh.mesh_dim_names)
    finally:
        dist.destroy_process_group()


def _placed(abstract: steps.Abstract, mesh):
    """An abstract tree as meta DTensors on ``mesh`` (as it is without)."""
    if mesh is None:
        return abstract.tree
    return steps.place(abstract.tree, abstract.specs, mesh)


def train_optimizer():
    """A train cell's optimizer: adamw, as the reference's dry-run."""
    return optimizers.adamw(optimizers.warmup_cosine(3e-4, 100, 10000),
                            weight_decay=0.1)


def _train(cfg, sys, shape, mesh=None):
    """A train cell (``train_optimizer``) on meta state and batch. Returns
    (mode, result, params, microbatches traced).

    A step of n > 3 microbatches runs at 2 and at 3 microbatches of the
    cell's microbatch size, and its counts are extrapolated to n: the
    microbatches are iterations of one loop over equal shapes, so each adds
    the same flops, bytes and kernel calls (the reference's analysis
    multiplies a while body by its trip count the same way), and from the
    second on each runs with the same storages alive, so the peak is the
    3-microbatch step's. The arguments are the whole cell's: the state and
    the batch of n microbatches."""
    opt = train_optimizer()
    n = sys.microbatches

    def state_of():
        if mesh is None:
            return steps.abstract_state(cfg, opt)
        return _placed(steps.state_specs_abstract(cfg, opt, mesh, sys), mesh)

    batch = _placed(steps.input_specs(cfg, shape, mesh), mesh)
    if n <= _MAX_TRACED:
        state = state_of()
        out, mode = cost_lib.count(
            steps.make_train_step(cfg, sys, opt, mesh=mesh), state, batch)
        return mode, out, state["params"], None
    rows = shape.global_batch // n
    runs = []
    for m in (2, 3):
        cut = dataclasses.replace(shape, global_batch=rows * m)
        state = state_of()
        runs.append(cost_lib.count(
            steps.make_train_step(cfg, dataclasses.replace(sys,
                                                           microbatches=m),
                                  opt, mesh=mesh),
            state, _placed(steps.input_specs(cfg, cut, mesh), mesh)))
    (_, two), (out, three) = runs
    mode = cost_lib.CostMode()
    mode.cost.add(three.cost, n - 2)
    mode.cost.add(two.cost, -(n - 3))
    mode.arguments((state, batch))
    # what the 3-microbatch step read of the state, and the whole batch
    mode.mark_read(batch, like=three)
    mode.peak_bytes = max(two.peak_bytes, three.peak_bytes)
    return mode, out, state["params"], [2, 3]


def _serve_step(cfg, sys, shape, max_len, amesh, mesh=None):
    """A prefill or decode cell on meta parameters (and cache); DTensors
    on ``mesh`` where one is given."""
    batch = _placed(steps.input_specs(cfg, shape, mesh), mesh)
    params = steps.param_specs_abstract(cfg, mesh or amesh, sys)
    params = _placed(params, mesh)
    if shape.kind == "prefill":
        step_fn = steps.make_prefill_step(cfg, sys, max_len=max_len)
        args = (params, batch)
    else:
        step_fn = steps.make_decode_step(cfg, sys)
        cache = _placed(steps.cache_specs_abstract(cfg, shape, mesh,
                                                   quant=sys.kv_quant), mesh)
        args = (params, cache, batch["tokens"], batch["pos"])
    out, mode = cost_lib.count(step_fn, *args)
    return mode, out, params


def run_cell(arch: str, shape_name: str, *, mesh=None,
             sys_overrides: Optional[dict] = None, verbose: bool = True,
             reduced: bool = False, shape=None,
             max_len: Optional[int] = None,
             cfg_overrides: Optional[dict] = None) -> dict:
    """Run one cell on meta tensors; returns a result record
    (JSON-serializable).

    ``reduced=True`` uses the family-preserving smoke config and ``shape``
    overrides the registry entry; ``max_len`` sizes a prefill's cache (the
    prompt's length by default) and ``cfg_overrides`` replaces config
    fields (a server's bf16 weights: ``{"dtype": torch.bfloat16}``)."""
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = shape if shape is not None else configs.SHAPES[shape_name]
    amesh = _abstract_mesh(mesh)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(s) for s in amesh.shape)}
    if cfg_overrides and "n_layers" in cfg_overrides:
        rec["layers"] = cfg.n_layers
    if not configs.shape_applicable(cfg, shape):
        rec.update(status="skipped",
                   reason="full-attention arch; long_500k needs sub-quadratic "
                          "serving")
        return rec
    chips = math.prod(amesh.shape)
    fam = steps.family(cfg)
    if chips > 1 and fam not in steps.SHARDED_FAMILIES:
        rec.update(status="skipped",
                   reason=f"the {fam} family has no sharded step on a "
                          f"{rec['mesh']} mesh: ROADMAP.md queue A item "
                          f"{steps.MESH_ITEMS.get(fam, '(none named)')} "
                          "(\"Configurations the "
                          "port does not run\")")
        return rec

    sizes = dict(zip(amesh.mesh_dim_names, amesh.shape))
    sys = steps.default_sys(cfg, shape, dp=sizes.get("data", 1),
                            tp=sizes.get("model", 1),
                            pods=sizes.get("pod", 1))
    if sys_overrides:
        sys = dataclasses.replace(sys, **sys_overrides)
    rec["sys"] = {k: v for k, v in sys.__dict__.items()}

    t0 = time.time()
    try:
        with fake_group(amesh) as mesh:
            if shape.kind == "train":
                mode, out, params, traced = _train(cfg, sys, shape, mesh)
            else:
                mode, out, params = _serve_step(cfg, sys, shape, max_len,
                                                amesh, mesh)
                traced = None
            counts, terms = _record(cfg, shape, chips, mode, out, params,
                                    traced)
        trace_s = time.time() - t0
    except Exception as e:  # a failing cell is a bug; surface it loudly
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} FAILED: {e}")
        return rec

    rec.update(status="ok", trace_s=round(trace_s, 2), **counts)
    if verbose:
        print(f"[dryrun] {arch:20s} {shape_name:12s} {rec['mesh']:8s} ok "
              f"trace={trace_s:6.1f}s perdev={rec['per_device_gb']:7.3f}GB "
              f"of {roofline.HBM_BYTES / 2**30:.1f} "
              f"dom={terms.dominant:10s} "
              f"c/m/n={terms.compute_s:.2e}/{terms.memory_s:.2e}/"
              f"{terms.collective_s:.2e}s mfu={terms.mfu:.2f}")
    return rec


def _record(cfg, shape, chips, mode, out, params, traced):
    """(a run cell's counts, its roofline terms): memory (rank 0's on a
    mesh), cost, kernels, collectives, the roofline over ``chips`` and
    whether it fits."""
    c = mode.cost
    mflops = roofline.model_flops(cfg, shape, params)
    terms = roofline.terms_from_dispatch(c, chips, mflops)
    unused = mode.unused_argument_bytes
    rec = dict(
        memory={"argument_size_in_bytes": int(mode.argument_bytes - unused),
                "unused_argument_bytes": int(unused),
                "output_size_in_bytes": int(mode.output_bytes(out)),
                "temp_size_in_bytes": int(mode.peak_bytes)},
        cost={"flops": c.flops, "bytes accessed": c.bytes,
              "transcendentals": c.transcendentals,
              "score_bytes": c.score_bytes, "fp32_flops": c.fp32_flops},
        kernels=c.kernel_calls(), traced_microbatches=traced,
        collectives={k: int(v) for k, v in c.coll.items()},
        collective_count=int(c.coll_count),
        roofline=terms.to_dict(),
    )
    per_dev_bytes = (mode.argument_bytes
                     + rec["memory"]["temp_size_in_bytes"])
    rec["per_device_gb"] = round(per_dev_bytes / 2**30, 3)
    rec["fits"] = per_dev_bytes <= roofline.HBM_BYTES
    return rec, terms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="AxB (data x model) or PxAxB")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the reference's 16x16 and 2x16x16")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this depth (n_layers)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cut = {"n_layers": args.layers} if args.layers else None

    if args.all:
        archs = configs.ARCH_IDS
        shapes = list(configs.SHAPES)
    else:
        archs = [args.arch] if args.arch else configs.ARCH_IDS
        shapes = [args.shape] if args.shape else list(configs.SHAPES)

    if args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    else:
        meshes = ["2x16x16" if args.multi_pod else args.mesh]
    results = []
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                results.append(run_cell(arch, shape, mesh=mesh,
                                        cfg_overrides=cut))

    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    fail = [r for r in results if r["status"] == "FAILED"]
    print(f"\n[dryrun] {ok} ok, {sk} skipped, {len(fail)} failed "
          f"of {len(results)} cells")
    for r in fail:
        print(f"  FAILED {r['arch']} x {r['shape']} x {r['mesh']}: {r['error']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    return 0 if not fail else 1


if __name__ == "__main__":
    raise SystemExit(main())
