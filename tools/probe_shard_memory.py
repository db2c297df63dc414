"""Where the dry-run's per-device peak and the card's part, for one
production-mesh cell run as rank 0 of a fake group.

    python3 tools/probe_shard_memory.py [--arch qwen3-0.6b]
        [--shape train_4k] [--micro 3]

Runs an arch's cell (``--shape``, at ``--micro`` microbatches for a
train cell) on a fake 16x16 group three ways and prints each one's
arguments and peak: (1) the dry-run's trace, meta tensors; (2) the same
step on the card, random shards, under ``analysis.cost.CostMode`` (its
live-storage peak) beside ``torch.cuda.max_memory_allocated`` of that run;
(3) the same card run without the mode. With ``--breakdown`` (1) and (2)
print the live storages at the mode's peak by the op that made them, and
(2) the op where the mode's live bytes run furthest from the card's
``memory_allocated``, with both breakdowns there. All three run on the
dry-run's
"cuda" mesh (``dryrun.fake_group``) and print their collective bytes by
kind. Numbers of the card runs are not checked: the fake collectives write
nothing, so an MoE arch's card runs route as the dry-run's meta run does
(a balanced router, ``models.moe.balanced_route``) rather than on
garbage. Needs a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, spmd  # noqa: E402
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

MESH = "16x16"


@contextlib.contextmanager
def balanced_routing():
    """``moe._route`` as the meta run routes (``moe.balanced_route``)."""
    route = moe._route
    moe._route = moe.balanced_route
    try:
        yield
    finally:
        moe._route = route


class Breakdown(cost.CostMode):
    """``CostMode`` that remembers the op that made each storage, the live
    storages by that op at its peak, and (on the card) where its live bytes
    and the allocator's part most."""

    def __init__(self, base=None):
        super().__init__()
        self.base, self.made, self.cur = base, {}, None
        self.at_peak, self.gap = None, (0, None, None)

    def by_op(self):
        out = {}
        for key, n in self._live.items():
            out[self.made.get(key, "?")] = out.get(self.made.get(key, "?"),
                                                   0) + n
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.cur = str(func)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.base is not None:
            gap = (self.argument_bytes + self.live_bytes
                   - (torch.cuda.memory_allocated() - self.base))
            if abs(gap) > abs(self.gap[0]):
                self.gap = (gap, self.cur, self.by_op())
        return out

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key not in self._args and key not in self._live:
            self.made[key] = self.cur
        before = self.peak_bytes
        super()._track(t)
        if self.peak_bytes > before:
            self.at_peak = (self.cur, self.by_op())


def show(title, op, parts, top=12):
    print(f"  {title} at {op}:", flush=True)
    for name, n in sorted(parts.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {n / 2 ** 20:10.2f} MiB  {name}", flush=True)


def cell(arch, shape_name, micro):
    cfg = configs.get_config(arch)
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
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--micro", type=int, default=3)
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0), flush=True)
    cfg, shape, amesh, sys_cfg = cell(args.arch, args.shape, args.micro)
    print(f"{args.arch} {args.shape} on {MESH}: {shape.global_batch} x "
          f"{shape.seq_len}, microbatches {sys_cfg.microbatches}, remat "
          f"{sys_cfg.remat}", flush=True)

    with dryrun.fake_group(amesh) as mesh:
        step, step_args = inputs(cfg, shape, sys_cfg, mesh, lambda t: t)
        with Breakdown() as mode:
            mode.arguments(step_args)
            step(*step_args)
    line("(1) meta, cuda mesh", mode.argument_bytes,
         mode.argument_bytes + mode.peak_bytes, mode.cost.coll)
    if args.breakdown:
        show("live storages at the peak", *mode.at_peak)

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
            with balanced_routing():
                if under_mode:
                    with Breakdown(before) as mode:
                        mode.arguments(step_args)
                        out = step(*step_args)
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
            if args.breakdown:
                show("live storages at the peak", *mode.at_peak)
                gap, op, parts = mode.gap
                show(f"the mode's live bytes {gap / 2 ** 20:+.2f} MiB off "
                     f"memory_allocated", op, parts)
        else:
            print(f"(3) card, cuda mesh: arguments {args_b / 2 ** 30:.4f} "
                  f"GiB, max_memory_allocated peak {peak / 2 ** 30:.4f} "
                  f"GiB; {s:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
