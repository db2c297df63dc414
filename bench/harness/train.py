"""The ``train`` kind: the program's train step on one model, driven for a
fixed time.

Workload parameters: ``batch`` rows of ``seq`` tokens, ``remat``,
``microbatches`` and ``precision`` (the program's system config), and
adamw's ``lr``, ``warmup_steps``, ``total_steps`` (``warmup_cosine``) and
``weight_decay``; ``checked_steps`` steps are compared with the reference.

Set-up builds one train state around the benchmark's weights and drives
it through the first ``checked_steps`` steps, on batches drawn from the
seed, through the same call and feed as the window: that is the warm-up,
and the readings of the check come from it. The same state then trains
for ``--seconds`` in the window; the window ends with the first step that
completes past that time, and every token of every step in it counts.
"""
from __future__ import annotations

import math
import time

from bench.harness import check, program, trace, weights, yardstick


def optim_span(update):
    """The optimizer's update call inside a ``bench.optim`` trace range."""
    def wrapped(*args, **kw):
        with trace.span("optim"):
            return update(*args, **kw)
    return wrapped


def hyper(tr: dict) -> dict:
    return {"lr": tr["lr"], "warmup": tr["warmup_steps"],
            "total": tr["total_steps"], "weight_decay": tr["weight_decay"]}


def first_grad(state) -> dict:
    """{leaf: norm} of the first gradient as adamw got it: its first
    moment after one step over (1 - b1)."""
    m = weights.flatten(program.first_moment(state))
    return {k: float(t.norm()) / (1 - program.B1) for k, t in m.items()}


def run(ctx) -> dict:
    tr, cfg, dev = ctx.traffic, ctx.cfg, ctx.device
    B, S, n_check = tr["batch"], tr["seq"], tr["checked_steps"]
    mcfg = program.model_config(cfg)
    sys = program.system_config(tr["remat"], tr["microbatches"],
                                tr["precision"])
    h = hyper(tr)
    opt = program.optimizer(h["lr"], h["warmup"], h["total"],
                            h["weight_decay"], wrap=optim_span)
    if ctx.cuda:
        program.load_kernels()
    flat = weights.init_params(cfg, ctx.seed, dev)
    state = program.train_state(weights.unflatten(flat), opt)
    step = ctx.wrap_step(program.train_step(mcfg, sys, opt))
    feed = weights.batches(cfg, ctx.seed, dev, B, S)

    prog = {"losses": []}
    for i in range(n_check):
        state, m = step(state, next(feed))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = first_grad(state)
    prog["change"] = check.change_norms(flat, cfg, ctx.seed, dev)
    ctx.sync()
    launches0 = program.launches()
    setup_s = time.perf_counter() - ctx.t_start

    steps = failed = 0
    prof = trace.profile() if ctx.trace else None
    energy0 = ctx.energy.read()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    while True:
        with trace.span("feed"):
            batch = next(feed)
        with trace.span("step"):
            state, m = step(state, batch)
            loss = float(m["loss"])
        steps += 1
        failed += not math.isfinite(loss)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    energy1 = ctx.energy.read()
    peak = ctx.peak_bytes()
    launched = {k: v - launches0[k] for k, v in program.launches().items()}
    del state, step, flat, m, batch, feed
    ctx.free()

    rec = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "failed": failed, "tokens": steps * B * S, "peak_bytes": peak,
           "energy_j": (None if energy0 is None or energy1 is None
                        else energy1 - energy0),
           "launches": launched, "trace": None, "tune": None}
    if prof is not None:
        rec["trace"] = traced(prof, window_s, cfg, [(B, S, sys.remat,
                                                      steps)])
        del prof

    ref_feed = weights.batches(cfg, ctx.seed, dev, B, S)
    ref = check.run_reference(cfg, ctx.seed, dev,
                              [next(ref_feed) for _ in range(n_check)], h,
                              mode=tr["reference_mode"])
    rec["readings"] = check.readings(prog, ref)
    rec["leaves"] = check.leaf_detail(prog, ref)
    return rec


def traced(prof, window_s: float, cfg: dict, runs) -> dict:
    """The profiler's reduction, with the window's model FLOPs and B1-B3's
    bounds. ``runs``: (batch, seq, remat, steps) of every step kind in
    the window; B1 runs twice a layer under remat (the recomputation)."""
    t = trace.reduce(prof, int(window_s * 1e9))
    L = cfg["num_hidden_layers"]
    flops = b1 = b23 = 0.0
    steps = 0
    for B, S, remat, n in runs:
        flops += n * yardstick.train_flops(cfg, B, S)
        bounds = yardstick.attention_bounds_ms(cfg, B, S)
        b1 += n * L * bounds["B1"] * (1 if remat == "none" else 2) / 1e3
        b23 += n * L * (bounds["B2"] + bounds["B3"]) / 1e3
        steps += n
    t.update(steps=steps, model_flops=flops, b1_bound_s=b1,
             b23_bound_s=b23)
    return t
