"""Where the dry-run's per-device peak and the card's part, for one
production-mesh cell run as rank 0 of a fake group.

    python3 tools/probe_shard_memory.py [--shape train_4k] [--micro 3]

Runs qwen3-0.6b's cell (``--shape``, at ``--micro`` microbatches for a
train cell) on a fake 16x16 group three ways and prints each one's
arguments and peak: (1) the dry-run's trace, meta tensors; (2) the same
step on the card, random shards, under ``analysis.cost.CostMode`` (its
live-storage peak) beside ``torch.cuda.max_memory_allocated`` of that run;
(3) the same card run without the mode. All three run on the dry-run's
"cuda" mesh (``dryrun.fake_group``) and print their collective bytes by
kind. Numbers of the card runs are not checked: the fake collectives write
nothing. Needs a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, spmd  # noqa: E402
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH, MESH = "qwen3-0.6b", "16x16"


def cell(shape_name, micro):
    cfg = configs.get_config(ARCH)
    shape = configs.SHAPES[shape_name]
    amesh = dryrun._abstract_mesh(MESH)
    sizes = dict(zip(amesh.mesh_dim_names, amesh.shape))
    sys_cfg = steps.default_sys(cfg, shape, dp=sizes["data"],
                                tp=sizes["model"])
    if shape.kind == "train" and micro:
        rows = shape.global_batch // sys_cfg.microbatches
        shape = dataclasses.replace(shape, global_batch=rows * micro)
        sys_cfg = dataclasses.replace(sys_cfg, microbatches=micro)
    return cfg, shape, amesh, sys_cfg


def inputs(cfg, shape, sys_cfg, mesh, make):
    batch = tree_map(make, dryrun._placed(
        steps.input_specs(cfg, shape, mesh), mesh))
    if shape.kind == "train":
        opt = dryrun.train_optimizer()
        state = tree_map(make, dryrun._placed(
            steps.state_specs_abstract(cfg, opt, mesh, sys_cfg), mesh))
        return steps.make_train_step(cfg, sys_cfg, opt, mesh=mesh), (state,
                                                                      batch)
    params = tree_map(make, dryrun._placed(
        steps.param_specs_abstract(cfg, mesh, sys_cfg), mesh))
    return steps.make_prefill_step(cfg, sys_cfg), (params, batch)


def line(name, args_b, peak_b, coll, extra=""):
    gib = 2 ** 30
    kinds = ", ".join(f"{k} {int(v):,}" for k, v in coll.items() if v)
    print(f"{name}: arguments {args_b / gib:.4f} GiB, peak (arguments + "
          f"temp) {peak_b / gib:.4f} GiB{extra}; collectives {kinds}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--micro", type=int, default=3)
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0), flush=True)
    cfg, shape, amesh, sys_cfg = cell(args.shape, args.micro)
    print(f"{ARCH} {args.shape} on {MESH}: {shape.global_batch} x "
          f"{shape.seq_len}, microbatches {sys_cfg.microbatches}, remat "
          f"{sys_cfg.remat}", flush=True)

    with dryrun.fake_group(amesh) as mesh:
        step, step_args = inputs(cfg, shape, sys_cfg, mesh, lambda t: t)
        _, mode = cost.count(step, *step_args)
    line("(1) meta, cuda mesh", mode.argument_bytes,
         mode.argument_bytes + mode.peak_bytes, mode.cost.coll)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for under_mode in (True, False):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        with dryrun.fake_group(amesh) as mesh:
            def make(t):
                if not torch.is_tensor(t):
                    return t
                local = t.to_local()
                if local.dtype.is_floating_point:
                    local = torch.randn(local.shape, generator=gen,
                                        device="cuda").mul_(0.02).to(
                                            local.dtype)
                else:
                    local = torch.randint(0, cfg.vocab, local.shape,
                                          generator=gen, device="cuda",
                                          dtype=local.dtype)
                return spmd.wrap(local, mesh, t.placements, t.shape)
            step, step_args = inputs(cfg, shape, sys_cfg, mesh, make)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if under_mode:
                out, mode = cost.count(step, *step_args)
            else:
                out = step(*step_args)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before
            del out, step_args
        args_b = base - before
        if under_mode:
            line("(2) card, cuda mesh, CostMode", mode.argument_bytes,
                 mode.argument_bytes + mode.peak_bytes, mode.cost.coll,
                 f"; max_memory_allocated: arguments "
                 f"{args_b / 2 ** 30:.4f}, peak {peak / 2 ** 30:.4f} GiB; "
                 f"{s:.1f} s")
        else:
            print(f"(3) card, cuda mesh: arguments {args_b / 2 ** 30:.4f} "
                  f"GiB, max_memory_allocated peak {peak / 2 ** 30:.4f} "
                  f"GiB; {s:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
