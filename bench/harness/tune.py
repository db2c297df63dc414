"""The ``tune`` kind: a PipeTune job over the program's train step, as a
user runs one: ``Experiment(job).with_tuner("pipetune", max_probes=...)
.with_backend(<the benchmark's backend>).with_scheduler("random", ...)
.with_groundtruth(GroundTruth())``, trials one after another until the
window ends.

Workload parameters: each trial trains ``epochs`` epochs of
``steps_per_epoch`` steps of ``batch`` rows of ``seq`` tokens; its
learning rate is drawn log-uniform over ``lr_range`` by the random
scheduler seeded with ``--seed``; ``sys_space`` is the system space
(remat x microbatches) and ``warm`` the config set-up warms (PipeTune's
default: its profile epochs run it); adamw's ``warmup_steps``,
``total_steps`` and ``weight_decay``; ``max_probes``; ``n_trials``, more
than a window holds.

The backend (``Backend``) follows the program's example LM backend: a
trial's weights and batches come from the seed and the trial's index,
each step is timed on the host clock between two synchronises, and it
trains in ``precision`` whatever precision an epoch's config names (the
job fixes it). Its profiles hold execution-level counters only (step
times, throughput, shapes, system config), as the paper's do. After its
last epoch a trial's weights and optimizer state are dropped: the random
scheduler never resumes one.

The window starts when the job starts and ends at the first step boundary
past ``--seconds``: trial set-up, the profile epochs, the probes, the
lookups and the scheduler all fall in it.

The first trial's profile epoch (PipeTune's default config) is compared
with the reference (``check``): its steps' losses, the first step's
gradient as the optimizer got it, each leaf's change after the epoch; the
reference follows the same steps from the seed's weights. The readings
that later steps overwrite are taken in the window (which does not close
inside that epoch), in a pause (``Backend.pause``) whose time and energy
the window does not count and whose deadline moves on by as much; the
reference runs after the window.
The probes' and the locked config's epochs are not compared: a check of
their first steps from the program's own weights could not tell bf16 from
fp8 (the gradient has shrunk many times over by then, and its bf16
rounding with it reads like fp8's), and at the same weights every config
of the space computes the profile config's gradient to a few parts in
1e4 (the benchmark's notes on the tune cell).
"""
from __future__ import annotations

import contextlib
import math
import time

from bench.harness import check, program, trace, weights
from bench.harness.train import hyper, optim_span, traced

CHECKED_TRIAL = 0


class WindowClosed(Exception):
    """Raised at the first step boundary past the window's end."""


class Backend:
    """PipeTune's backend: the program's train step on ``cfg``."""

    def __init__(self, ctx, deadline: float):
        self.ctx, self.cfg, self.tr = ctx, ctx.cfg, ctx.traffic
        self.api = program.tuning_api()
        self.mcfg = program.model_config(self.cfg)
        self.deadline = deadline
        self.profiler = self.api["Profiler"](ctx.device)
        self.runner = None
        self.trials = []          # index -> {"lr", "hp"}
        self.log = []             # one entry a step
        self.steps_fns = {}
        self.checked = {"losses": []}
        self.want_grads, self.grads = False, None
        self.closed_at = None
        self.paused_s = 0.0
        self.paused_j = 0.0

    @contextlib.contextmanager
    def pause(self):
        """The check's own reading: out of the window's time and energy,
        and the window's end moved on by its length."""
        self.ctx.sync()
        t0, e0 = time.perf_counter(), self.ctx.energy.read()
        with trace.span("check"):
            yield
            self.ctx.sync()
        e1, dt = self.ctx.energy.read(), time.perf_counter() - t0
        self.paused_s += dt
        self.deadline += dt
        if e0 is not None and e1 is not None:
            self.paused_j += e1 - e0

    def capabilities(self):
        return self.api["BackendCapabilities"](
            async_precompile=False, simulated=False, deterministic=False)

    def init_trial(self, workload, hparams, seed=0):
        with trace.span("trial_init"):
            idx = len(self.trials)
            lr = float(hparams["learning_rate"])
            h = hyper(dict(self.tr, lr=lr))
            opt = program.optimizer(
                h["lr"], h["warmup"], h["total"], h["weight_decay"],
                wrap=lambda update: optim_span(self.reading_grads(update)))
            flat = weights.init_params(self.cfg, self.ctx.seed,
                                       self.ctx.device, "trial", idx)
            state = program.train_state(weights.unflatten(flat), opt)
            feed = weights.batches(self.cfg, self.ctx.seed, self.ctx.device,
                                   self.tr["batch"], self.tr["seq"], "trial",
                                   idx)
            self.trials.append({"lr": lr, "hp": h})
            return self.api["TrialState"](
                workload=workload, hparams=dict(hparams), cfg=self.mcfg,
                params=(state, opt, flat), opt_state=None, step=0, epoch=0,
                data=feed, eval_batch={}, seed=idx)

    def reading_grads(self, update):
        """The optimizer's update, which on a checked step first reads the
        norm of each leaf of the gradient it gets (in a pause)."""
        def wrapped(grads, *args, **kw):
            if self.want_grads:
                self.want_grads = False
                with self.pause():
                    self.grads = {k: float(g.norm()) for k, g in
                                  weights.flatten(grads).items()}
            return update(grads, *args, **kw)
        return wrapped

    def _kind(self, ts) -> str:
        """"profile", "probe" or "locked": what PipeTune runs this epoch."""
        if ts.epoch == 0:
            return "profile"
        rec = next((self.runner.records[tid]
                    for tid, st in self.runner.states.items() if st is ts),
                   None)
        if rec is None or rec.gt_hit:
            return "locked"
        n_probes = min(self.tr["max_probes"],
                       len(system_space(self.tr, self.api).configs()))
        return "probe" if ts.epoch <= n_probes else "locked"

    def step_fn(self, idx, opt, remat, micro):
        key = (idx, remat, micro)
        if key not in self.steps_fns:
            sys = program.system_config(remat, micro, self.tr["precision"])
            self.steps_fns[key] = self.ctx.wrap_step(
                program.train_step(self.mcfg, sys, opt))
        return self.steps_fns[key]

    def run_epoch(self, ts, sys_cfg, collect_profile=True):
        ctx, tr = self.ctx, self.tr
        state, opt, flat = ts.params
        remat, micro = sys_cfg["remat"], int(sys_cfg["microbatches"])
        step = self.step_fn(ts.seed, opt, remat, micro)
        kind = self._kind(ts)
        checked = ts.seed == CHECKED_TRIAL and ts.epoch == 0
        times, e0, paused_j = [], ctx.energy.read(), self.paused_j
        for i in range(tr["steps_per_epoch"]):
            if not checked and time.perf_counter() >= self.deadline:
                self.closed_at = time.perf_counter()
                raise WindowClosed()
            batch = next(ts.data)
            self.want_grads = checked and i == 0
            ctx.sync()
            t0, paused_s = time.perf_counter(), self.paused_s
            with trace.span("step"):
                state, m = step(state, batch)
                loss = float(m["loss"])
            t1 = time.perf_counter() - (self.paused_s - paused_s)
            times.append(t1 - t0)
            self.log.append({"trial": ts.seed, "epoch": ts.epoch,
                             "kind": kind, "remat": remat, "micro": micro,
                             "t": t1 - t0, "loss": loss})
            if checked:
                self.checked["losses"].append(loss)
                if i == 0:
                    self.checked["grad"] = self.grads
        if checked:
            with self.pause():
                self.checked["change"] = check.change_norms(
                    flat, self.cfg, ctx.seed, ctx.device, "trial",
                    CHECKED_TRIAL)
        e1 = ctx.energy.read()
        sys = program.system_config(remat, micro, tr["precision"])
        B, S = tr["batch"], tr["seq"]
        prof = self.profiler.build(
            step_times=times, tokens_per_step=B * S, sys_config=sys,
            workload_meta={"batch": B, "seq_or_dim": S,
                           "layers": self.cfg["num_hidden_layers"],
                           "d_model": self.cfg["hidden_size"],
                           "vocab": self.cfg["vocab_size"]})
        ts.params = (state, opt, flat)
        ts.step += len(times)
        ts.epoch += 1
        if ts.epoch >= tr["epochs"]:
            self._drop(ts)
        return ts, self.api["EpochResult"](
            duration_s=float(sum(times)),
            energy_j=(0.0 if e0 is None or e1 is None
                      else e1 - e0 - (self.paused_j - paused_j)),
            loss=loss, accuracy=-loss, profile=prof,
            sys_config=dict(sys_cfg), step_times=times)

    def _drop(self, ts):
        """The trial's weights, optimizer state and steps let go: freed as
        ``run_epoch`` returns."""
        ts.params = ts.data = None
        for key in [k for k in self.steps_fns if k[0] == ts.seed]:
            del self.steps_fns[key]


def warm_up(ctx):
    """Two steps of the warm config on a state of its own, then freed."""
    tr, cfg = ctx.traffic, ctx.cfg
    h = hyper(dict(tr, lr=tr["lr_range"][0]))
    opt = program.optimizer(h["lr"], h["warmup"], h["total"],
                            h["weight_decay"], wrap=optim_span)
    flat = weights.init_params(cfg, ctx.seed, ctx.device, "warm")
    state = program.train_state(weights.unflatten(flat), opt)
    sys = program.system_config(tr["warm"]["remat"],
                                tr["warm"]["microbatches"], tr["precision"])
    step = ctx.wrap_step(program.train_step(program.model_config(cfg), sys,
                                            opt))
    feed = weights.batches(cfg, ctx.seed, ctx.device, tr["batch"], tr["seq"],
                           "warm")
    for _ in range(2):
        state, m = step(state, next(feed))
        float(m["loss"])
    del state, step, flat, feed, m
    ctx.free()


def run(ctx) -> dict:
    tr, cfg = ctx.traffic, ctx.cfg
    api = program.tuning_api()
    if ctx.cuda:
        program.load_kernels()
    warm_up(ctx)
    api["register_backend"]("bench-lm", lambda **kw: Backend(**kw),
                            sys_space=lambda **kw: system_space(tr, api))
    job = make_job(cfg, tr, ctx.seed, api)
    gt = api["GroundTruth"]()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    prof = trace.profile() if ctx.trace else None
    energy0 = ctx.energy.read()
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    exp = (api["Experiment"](job)
           .with_tuner("pipetune", max_probes=tr["max_probes"])
           .with_backend("bench-lm", ctx=ctx, deadline=t0 + ctx.seconds)
           .with_groundtruth(gt)
           .with_scheduler(tr["scheduler"], n_trials=tr["n_trials"]))
    # the runner the facade would build, kept so that the backend can read
    # its trial records and the window's end can leave them readable
    runner = exp.build_runner()
    backend = runner.backend
    backend.runner = runner
    try:
        api["Experiment"](job).with_tuner(runner).with_scheduler(
            tr["scheduler"], n_trials=tr["n_trials"]).run()
    except WindowClosed:
        pass
    end = backend.closed_at or time.perf_counter()
    paused_s, paused_j = backend.paused_s, backend.paused_j
    window_s = end - t0 - paused_s
    if prof is not None:
        prof.stop()
    energy1 = ctx.energy.read()
    peak = ctx.peak_bytes()
    log, checked, trials = backend.log, backend.checked, backend.trials
    del exp, runner, backend
    ctx.free()

    B, S = tr["batch"], tr["seq"]
    tokens = len(log) * B * S
    rec = {"setup_s": setup_s, "window_s": window_s, "steps": len(log),
           "failed": sum(not math.isfinite(s["loss"]) for s in log),
           "tokens": tokens, "peak_bytes": peak,
           "energy_j": (None if energy0 is None or energy1 is None
                        else energy1 - energy0 - paused_j),
           "paused_s": paused_s, "trace": None,
           "tune": {"tokens": tokens, "window_s": window_s,
                    "probe_tokens": sum(B * S for s in log
                                        if s["kind"] == "probe"),
                    "step_s": sum(s["t"] for s in log),
                    "gt_hits": gt.hits, "gt_misses": gt.misses,
                    "trials": len(trials),
                    "by_config": _by_config(log)}}
    if prof is not None:
        runs = [(B, S, r, sum(1 for s in log if s["remat"] == r))
                for r in sorted({s["remat"] for s in log})]
        rec["trace"] = traced(prof, window_s, cfg, runs)
        del prof
    if "change" not in checked:
        rec["readings"] = {}
        return rec
    ref_feed = weights.batches(cfg, ctx.seed, ctx.device, B, S, "trial",
                               CHECKED_TRIAL)
    n = len(checked["losses"])
    ref = check.run_reference(
        cfg, ctx.seed, ctx.device, [next(ref_feed) for _ in range(n)],
        trials[CHECKED_TRIAL]["hp"], names=("trial", CHECKED_TRIAL),
        mode=tr["reference_mode"])
    ref["grad"] = ref["raw_grad"]
    rec["readings"] = check.readings(checked, ref)
    rec["leaves"] = check.leaf_detail(checked, ref)
    return rec


def make_job(cfg: dict, tr: dict, seed: int, api: dict):
    """The tuning job: the learning rate log-uniform over ``lr_range``,
    drawn by a scheduler seeded with ``seed``."""
    return api["HPTJob"](
        workload=cfg["name"],
        space=api["SearchSpace"]([api["Param"]("learning_rate", "log",
                                               *tr["lr_range"])]),
        max_epochs=tr["epochs"], seed=seed % 2 ** 32)


def first_learning_rate(cfg: dict, tr: dict, seed: int) -> float:
    """The checked trial's learning rate, as the job's scheduler draws it."""
    api = program.tuning_api()
    sched = api["make_scheduler"](tr["scheduler"],
                                  make_job(cfg, tr, seed, api),
                                  n_trials=tr["n_trials"])
    return float(sched.suggest()[CHECKED_TRIAL].hparams["learning_rate"])


def system_space(tr: dict, api: dict):
    """The job's system space: remat x microbatches at the job's one
    precision."""
    sp = tr["sys_space"]
    return api["SystemSpace"](remat=tuple(sp["remat"]),
                              microbatches=tuple(sp["microbatches"]),
                              precision=(tr["precision"],))


def _by_config(log) -> dict:
    """Steps and mean step ms by (remat, microbatches)."""
    out = {}
    for s in log:
        k = f"{s['remat']}/{s['micro']}"
        n, t = out.get(k, (0, 0.0))
        out[k] = (n + 1, t + s["t"])
    return {k: {"steps": n, "ms": 1e3 * t / n} for k, (n, t) in out.items()}
