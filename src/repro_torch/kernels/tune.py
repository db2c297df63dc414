"""KernelTuneBackend: the tuner pointed at the port's own kernels.

PipeTune's thesis is that system parameters deserve the same tuning loop
as hyperparameters. This module, the port of ``repro.kernels.tune``, closes
that loop on the port itself: a ``Backend``-protocol implementation whose
"trials" time kernel variants — ``chunk`` for the mLSTM kernel (B4),
``chunk`` and ``r_block`` for the RG-LRU kernel (B5), ``remat`` and
``microbatches`` for a Table-3 train step — per workload shape, through the
port's own ask/tell schedulers, ``TrialRunner`` and serial executor
(``repro_torch.api.Experiment``). Winning configs land in a
:class:`KernelConfigDB` find-db keyed by ``(kernel, shape_key,
hardware_key)``, where ``ops.mlstm``/``ops.rglru`` resolve them through
``repro_torch.kernels.findb.lookup_or_default`` and
``TorchRealBackend._effective_sys`` fills the sys-config keys its caller
left unset.

Differences from the reference: ``device`` (``cuda`` unless the caller asks
for ``cpu``) takes the place of ``interpret``; on the card each rep is timed
with CUDA events on the current stream, on the CPU with the host clock (the
CPU runs the plain versions, so its times say nothing of the kernels). The
flash-attention workloads parse (their shape keys are the reference's) but
do not tune: the port's B1-B3 have no ``q_block``/``kv_block`` (ROADMAP
queue A, item 8). A ``train_step`` config's time is the median step time of
one epoch of a ``TorchRealBackend`` trial kept per config, as in the
reference, after ``warmup`` untimed epochs of a new config (the reference
times its first epoch). The default and the trials' winner are re-timed
in three interleaved rounds, not two, and the winner is persisted only if
it beats the default by more than the default's spread over them (the
reference persists it whatever the margin). The service-backed sources
(``--store``, ``--journal``, ``import``) wait for the service package
(item 12).

Workload specs
--------------
``"<kernel>@k=v,k=v"`` or a named preset::

    mlstm@B=8,S=2048,H=4,D=512     # xlstm-350m width
    rglru@B=8,S=2048,R=4096        # recurrentgemma-9b width
    train_step@arch=lenet-mnist,batch=64      # hillclimb system dims

CLI::

    python -m repro_torch.kernels.tune tune --workload mlstm-smoke
    python -m repro_torch.kernels.tune tune --workload mlstm-smoke \\
        --device cpu --golden golden.json
    python -m repro_torch.kernels.tune tune --workload train-smoke
    python -m repro_torch.kernels.tune show --golden golden.json
    python -m repro_torch.kernels.tune export --golden golden.json --out copy.json
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       TrialState)
from repro_torch.core.groundtruth import (GroundTruthError, KernelConfigDB,
                                          export_golden, load_golden)
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.core.pipetune import TuneV1
from repro_torch.core.profiler import EpochProfile
from repro_torch.kernels import findb

__all__ = ["KernelTuneBackend", "PRESETS", "install_kernel_db",
           "kernel_space", "parse_workload", "tune_kernel",
           "workload_shape_key"]

PRESETS = {
    "flash-fwd-smoke": "flash_attention@B=1,S=256,K=2,G=1,D=32",
    "flash-bwd-smoke": "flash_attention_bwd@B=1,S=256,K=2,G=1,D=32",
    "mlstm-smoke": "mlstm@B=1,S=256,H=2,D=32",
    "rglru-smoke": "rglru@B=1,S=512,R=128",
    "train-smoke": "train_step@arch=lenet-mnist,batch=64",
}

# the presets the CLI tunes by default: the kernels the port can tune
DEFAULT_WORKLOADS = ("mlstm-smoke", "rglru-smoke")

# which variant keys each kernel understands (hparams and recognized
# sys_cfg keys both feed these; everything else is ignored)
KERNEL_KEYS = {
    "flash_attention": ("q_block", "kv_block"),
    "flash_attention_bwd": ("q_block", "kv_block"),
    "mlstm": ("chunk",),
    "rglru": ("chunk", "r_block"),
    "train_step": ("remat", "microbatches", "precision", "donate"),
}

# the hand-picked config each kernel ran on before autotuning — what a
# variant's speedup is measured against. train_step spells out the
# TorchRealBackend fallbacks explicitly so the baseline never resolves
# through the find-db it is trying to beat.
BASELINES = dict(findb.DEFAULTS)
BASELINES["train_step"] = {"remat": "none", "microbatches": 1,
                           "precision": "fp32"}

# rounds of the default and the trials' winner, interleaved, behind the
# stored config and the summary's times
HEADLINE_ROUNDS = 3

_INT_KEYS = ("q_block", "kv_block", "chunk", "r_block", "microbatches")

_ITEM12 = "ROADMAP queue A, item 12 (Tuning service and wire protocol)"

# kernels the port cannot time yet, and why
_NOT_YET = {
    "flash_attention": "the port's flash-attention kernels (B1-B3) have no "
                       "q_block/kv_block to tune; their tile choices come "
                       "with their redesign (ROADMAP queue A, item 8)",
    "flash_attention_bwd": "the port's flash-attention kernels (B1-B3) have "
                           "no q_block/kv_block to tune; their tile choices "
                           "come with their redesign (ROADMAP queue A, "
                           "item 8)",
}


def _check_tunable(kernel: str) -> None:
    if kernel in _NOT_YET:
        raise ValueError(f"cannot tune {kernel!r}: {_NOT_YET[kernel]}")


def parse_workload(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``"kernel@k=v,..."`` (or a PRESETS name) -> (kernel, dims)."""
    spec = PRESETS.get(spec, spec)
    kernel, _, dimstr = spec.partition("@")
    if kernel not in KERNEL_KEYS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{sorted(KERNEL_KEYS)} (or a preset: "
                         f"{sorted(PRESETS)})")
    dims: Dict[str, Any] = {}
    for part in filter(None, dimstr.split(",")):
        k, _, v = part.partition("=")
        if not _ or not k:
            raise ValueError(f"bad dim {part!r} in workload {spec!r}; "
                             "expected k=v")
        if v.lstrip("-").isdigit():
            dims[k] = int(v)
        elif v in ("True", "False"):
            dims[k] = v == "True"
        elif v == "none":
            dims[k] = None
        else:
            dims[k] = v
    if kernel in ("flash_attention", "flash_attention_bwd"):
        for d in ("B", "S", "K", "G", "D"):
            if d not in dims:
                raise ValueError(f"{kernel} workload needs dim {d}")
        dims.setdefault("T", dims["S"])
        dims.setdefault("causal", True)
        dims.setdefault("window", None)
    elif kernel == "mlstm":
        for d in ("B", "S", "H", "D"):
            if d not in dims:
                raise ValueError(f"mlstm workload needs dim {d}")
    elif kernel == "rglru":
        for d in ("B", "S", "R"):
            if d not in dims:
                raise ValueError(f"rglru workload needs dim {d}")
    else:                                                 # train_step
        if "arch" not in dims:
            raise ValueError("train_step workload needs arch=<config id>")
        dims.setdefault("batch", 64)
        dims.setdefault("steps", 4)
    return kernel, dims


def workload_shape_key(kernel: str, dims: Dict[str, Any]) -> str:
    """The exact key the kernel call sites look up — writing tuned entries
    under it is what makes them take effect with no extra plumbing."""
    if kernel in ("flash_attention", "flash_attention_bwd"):
        return findb.attention_shape_key(
            B=dims["B"], S=dims["S"], K=dims["K"], G=dims["G"],
            D=dims["D"], T=dims["T"], causal=dims["causal"],
            window=dims["window"])
    if kernel == "mlstm":
        return findb.mlstm_shape_key(B=dims["B"], S=dims["S"],
                                     H=dims["H"], D=dims["D"])
    if kernel == "rglru":
        return findb.rglru_shape_key(B=dims["B"], S=dims["S"], R=dims["R"])
    return findb.train_step_shape_key(arch=dims["arch"], batch=dims["batch"])


def kernel_space(kernel: str, dims: Dict[str, Any]) -> SearchSpace:
    """The variant search space for one kernel workload, pruned to blocks
    that fit the shape (and, for mlstm, divide the sequence)."""
    sizes = (32, 64, 128, 256)
    if kernel in ("flash_attention", "flash_attention_bwd"):
        qs = tuple(c for c in sizes if c <= dims["S"]) or (dims["S"],)
        ks = tuple(c for c in sizes if c <= dims["T"]) or (dims["T"],)
        return SearchSpace([Param("q_block", "choice", choices=qs),
                            Param("kv_block", "choice", choices=ks)])
    if kernel == "mlstm":
        cs = tuple(c for c in sizes
                   if c <= dims["S"] and dims["S"] % c == 0) or (dims["S"],)
        return SearchSpace([Param("chunk", "choice", choices=cs)])
    if kernel == "rglru":
        cs = tuple(c for c in sizes if c <= dims["S"]) or (dims["S"],)
        rs = tuple(c for c in sizes if c <= dims["R"]) or (dims["R"],)
        return SearchSpace([Param("chunk", "choice", choices=cs),
                            Param("r_block", "choice", choices=rs)])
    return SearchSpace([Param("remat", "choice", choices=("none", "block")),
                        Param("microbatches", "choice", choices=(1, 2, 4))])


def variant_config(kernel: str, hparams: dict, sys_cfg: dict) -> dict:
    """The concrete kernel config one trial epoch measures: recognized keys
    from the trial's hparams, overridden by recognized sys_cfg keys (so
    system-probing tuners can drive the same backend)."""
    keys = KERNEL_KEYS[kernel]
    cfg = {k: hparams[k] for k in keys if k in hparams}
    cfg.update({k: sys_cfg[k] for k in keys if k in sys_cfg})
    merged = dict(BASELINES[kernel])
    merged.update(cfg)
    return {k: (int(v) if k in _INT_KEYS else v)
            for k, v in merged.items()}


class KernelTuneBackend:
    """``Backend`` whose epochs time one kernel variant per call.

    ``accuracy`` is the variant's *speedup over the kernel's baseline
    config* (maximized by every scheduler under the default "accuracy"
    objective), ``loss`` is the variant's time in seconds (the minimum over
    ``reps``). The first call of a variant — on the card it loads the
    kernel library and makes the first launch — is charged to
    ``compile_s``, as the reference charges the jit compile; then
    ``warmup`` untimed calls, then ``reps`` timed ones. ``kernel_calls``
    counts every kernel call the backend made, per kernel, so a run can
    hold the kernels' launch counters against it (for ``train_step``, the
    train steps it ran). A ``train_step`` variant's time is the median step
    of one epoch instead (``_time_train_step``).
    """

    def __init__(self, reps: int = 3, warmup: int = 1,
                 device: device_lib.DeviceLike = None):
        self.reps = max(1, int(reps))
        self.warmup = max(0, int(warmup))
        self.device = device_lib.resolve(device)
        self.kernel_calls: Dict[str, int] = {"mlstm": 0, "rglru": 0,
                                             "train_step": 0}
        self._baselines: Dict[str, float] = {}
        self._variants: Dict[tuple, Any] = {}
        self._inputs: Dict[tuple, dict] = {}
        self._real = None                      # lazy TorchRealBackend
        self._real_states: Dict[tuple, TrialState] = {}

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(async_precompile=False, simulated=False,
                                   deterministic=False)

    # ------------------------------------------------------------- protocol
    def init_trial(self, workload: str, hparams: dict, seed: int = 0
                   ) -> TrialState:
        kernel, dims = parse_workload(workload)
        _check_tunable(kernel)
        data = self._make_inputs(kernel, dims, seed)
        return TrialState(workload=workload, hparams=dict(hparams),
                          cfg={"kernel": kernel, "dims": dims}, params=None,
                          opt_state=None, step=0, epoch=0, data=data,
                          eval_batch={}, seed=seed)

    def run_epoch(self, ts: TrialState, sys_cfg: dict, collect_profile=True
                  ) -> Tuple[TrialState, EpochResult]:
        kernel, dims = ts.cfg["kernel"], ts.cfg["dims"]
        cfg = variant_config(kernel, ts.hparams, sys_cfg)
        base_s = self._baseline_time(ts)
        med, times, extra_s = self._time_config(ts, cfg)
        ts.epoch += 1
        ts.step += len(times)
        ts.loss_last = med
        profile = EpochProfile({})
        if collect_profile:
            profile = EpochProfile({
                "rt.step_time_mean": float(np.mean(times)),
                "rt.step_time_p90": float(np.percentile(times, 90)),
                "shape.batch": float(dims.get("B", dims.get("batch", 1))),
            })
        return ts, EpochResult(
            duration_s=float(np.sum(times)), energy_j=0.0, loss=med,
            accuracy=base_s / max(med, 1e-12), profile=profile,
            sys_config=dict(cfg), step_times=list(times), compile_s=extra_s)

    # ------------------------------------------------------------- plumbing
    def _make_inputs(self, kernel: str, dims: Dict[str, Any], seed: int):
        """The reference's inputs for the same seed (the same numpy draws in
        the same order), made once per workload and seed and kept."""
        if kernel == "train_step":
            return {"train": True}
        key = (kernel, workload_shape_key(kernel, dims), seed)
        if key in self._inputs:
            return self._inputs[key]
        rng = np.random.RandomState(seed + 17)

        def f32(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                self.device)

        if kernel == "mlstm":
            B, S, H, D = (dims[k] for k in ("B", "S", "H", "D"))
            args = tuple(f32(rng.randn(*shape)) for shape in
                         ((B, S, H, D),) * 3 + ((B, S, H),) * 2)
        else:                                                  # rglru
            B, S, R = dims["B"], dims["S"], dims["R"]
            log_a = f32(-np.abs(rng.randn(B, S, R)) * 0.1)
            args = (log_a, f32(rng.randn(B, S, R)))
        self._inputs[key] = {"args": args}
        return self._inputs[key]

    def _build_call(self, ts: TrialState, cfg: dict):
        """(callable, args) for one variant: a partial over the kernel's
        wrapper with the variant's config spelled out (so the find-db is
        never consulted while timing)."""
        kernel = ts.cfg["kernel"]
        if kernel == "mlstm":
            from repro_torch.kernels import mlstm
            fn = functools.partial(mlstm.mlstm_chunkwise, chunk=cfg["chunk"])
        else:
            from repro_torch.kernels import rglru
            fn = functools.partial(rglru.rglru_scan, chunk=cfg["chunk"],
                                   r_block=cfg["r_block"])
        return fn, ts.data["args"]

    def _variant(self, ts: TrialState, cfg: dict):
        """The variant's callable + its args + whether it still owes its
        first (cold) call."""
        key = (ts.workload, tuple(sorted(cfg.items())))
        ent = self._variants.get(key)
        if ent is not None:
            return ent[0], ent[1], False
        fn, args = self._build_call(ts, cfg)
        self._variants[key] = (fn, args)
        return fn, args, True

    def _call(self, kernel: str, fn, args):
        self.kernel_calls[kernel] += 1
        return fn(*args)

    def _time_call(self, ts: TrialState, cfg: dict
                   ) -> Tuple[float, List[float], float]:
        kernel = ts.cfg["kernel"]
        fn, args, cold = self._variant(ts, cfg)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        build_s = 0.0
        if cold:                     # library load + first launch
            t0 = time.perf_counter()
            self._call(kernel, fn, args)
            sync()
            build_s = time.perf_counter() - t0
        for _ in range(self.warmup):
            self._call(kernel, fn, args)
        times = []
        for _ in range(self.reps):
            with device_lib.Timer(self.device) as timer:
                self._call(kernel, fn, args)
            times.append(timer.ms / 1e3)
        # min, not median: interference is strictly additive on a warm
        # call, so the fastest rep is the best cost estimate
        return float(np.min(times)), times, build_s

    def _time_train_step(self, ts: TrialState, cfg: dict
                         ) -> Tuple[float, List[float], float]:
        """One epoch of a ``TorchRealBackend`` trial at ``cfg``: the median
        step time (each step ends with a synchronise of the backend's
        stream), the step times and the epoch's compile_s. Each config keeps
        its own trial, which trains on from epoch to epoch. A config's first
        ``warmup`` epochs go untimed, their time to compile_s: on the card
        the first steps of a new config set up cuBLAS, cuDNN and the
        allocator over more than the one step the compile strip covers (the
        reference times the first epoch)."""
        from repro_torch.core.backends import TorchRealBackend
        dims = ts.cfg["dims"]
        if self._real is None:
            self._real = TorchRealBackend(steps_per_epoch=int(dims["steps"]),
                                          device=self.device)
        key = (ts.workload, findb.shape_key(**cfg))
        inner = self._real_states.get(key)
        build_s = 0.0
        if inner is None:
            inner = self._real.init_trial(
                dims["arch"], {"batch_size": int(dims["batch"])},
                seed=ts.seed)
            t0 = time.perf_counter()
            for _ in range(self.warmup):
                inner, res = self._real.run_epoch(inner, dict(cfg),
                                                  collect_profile=False)
                self.kernel_calls["train_step"] += len(res.step_times)
            build_s = time.perf_counter() - t0
        inner, res = self._real.run_epoch(inner, dict(cfg),
                                          collect_profile=False)
        self._real_states[key] = inner
        self.kernel_calls["train_step"] += len(res.step_times)
        med = (float(np.median(res.step_times)) if res.step_times
               else res.duration_s)
        return med, list(res.step_times), res.compile_s + build_s

    def _time_config(self, ts: TrialState, cfg: dict
                     ) -> Tuple[float, List[float], float]:
        if ts.cfg["kernel"] == "train_step":
            return self._time_train_step(ts, cfg)
        return self._time_call(ts, cfg)

    def _baseline_time(self, ts: TrialState) -> float:
        """Time of the kernel's hand-picked default config, measured once
        per workload and cached — the denominator of every variant's
        speedup."""
        base = self._baselines.get(ts.workload)
        if base is None:
            cfg = variant_config(ts.cfg["kernel"], {}, {})
            base, _, _ = self._time_config(ts, cfg)
            self._baselines[ts.workload] = base
        return base


class VariantTuneV1(TuneV1):
    """TuneV1 that runs each variant as its hparams spell it: it passes no
    system config. TuneV1's fixed default (``SYS_DEFAULT``: remat block, 4
    microbatches) would override a ``train_step`` variant's keys in
    ``variant_config``, so that every trial timed that one config, as the
    reference's ``tune_kernel`` does. The kernels' variants read no system
    key, so their trials are the same either way."""

    def sys_for_epoch(self, record, state, epoch, prev):
        return {}


# ---------------------------------------------------------------------------
# the find-db loop: tune -> persist -> resolve; golden export/import
# ---------------------------------------------------------------------------

def tune_kernel(workload: str, *, db: Optional[KernelConfigDB] = None,
                scheduler: str = "grid", trials: Optional[int] = None,
                reps: int = 3, warmup: int = 1, seed: int = 0,
                device: device_lib.DeviceLike = None, force: bool = False
                ) -> Dict[str, Any]:
    """Resolve-or-tune one kernel workload; returns a summary dict.

    A find-db hit returns the known-best config with **zero** tuning
    trials. A miss runs the variant space through the standard
    ``Experiment`` machinery, persists the winner in ``db`` under the
    device's hardware key, and reports tuned-vs-default time (seconds).
    A winner that does not beat the default by more than the default's
    spread (``HEADLINE_ROUNDS`` re-timings) is not persisted: the default
    is, and ``config`` is the default; ``winner``, ``winner_s`` and
    ``spread`` say what the trials found. ``kernel_calls`` in the summary
    is the number of kernel calls the backend made (0 on a hit).
    """
    dev = device_lib.resolve(device)
    db = db if db is not None else findb.get_find_db()
    hw = findb.hardware_key(dev)
    kernel, dims = parse_workload(workload)
    _check_tunable(kernel)
    skey = workload_shape_key(kernel, dims)
    if not force:
        cached = db.get(kernel, skey, hw)
        if cached is not None:
            return {"workload": workload, "kernel": kernel, "shape": skey,
                    "hardware": hw, "source": "find-db", "trials": 0,
                    "config": dict(cached), "default_s": None,
                    "tuned_s": None, "speedup": None, "kernel_calls": 0}

    from repro_torch.api import Experiment
    backend = KernelTuneBackend(reps=reps, warmup=warmup, device=dev)
    job = HPTJob(workload=PRESETS.get(workload, workload),
                 space=kernel_space(kernel, dims), objective="accuracy",
                 max_epochs=1, seed=seed)
    sch_kw = {}
    if trials is not None and scheduler == "random":
        sch_kw["n_trials"] = int(trials)
    res = (Experiment(job).with_tuner(VariantTuneV1(backend))
           .with_scheduler(scheduler, **sch_kw).run())
    best = res.best_record
    if best is None or not best.epochs:
        raise RuntimeError(f"kernel tuning produced no trials for "
                           f"{workload!r}")
    winner = variant_config(kernel, best.hparams, {})
    # headline numbers: re-time default and winner back to back (warm,
    # interleaved, min of all) so the reported speedup never compares
    # measurements taken under different load. The winner is stored only if
    # it beats the default by more than the default's own spread over these
    # rounds; otherwise the default is, so that a win by noise slows no
    # caller that reads the find-db.
    base_cfg = variant_config(kernel, {}, {})
    ts = backend.init_trial(PRESETS.get(workload, workload), {}, seed=seed)
    d_times, t_times = [], []
    for _ in range(HEADLINE_ROUNDS):
        d_times.append(backend._time_config(ts, base_cfg)[0])
        t_times.append(backend._time_config(ts, winner)[0])
    default_s, winner_s = min(d_times), min(t_times)
    spread = max(d_times) / max(default_s, 1e-12) - 1.0
    cfg, tuned_s = winner, winner_s
    if default_s <= winner_s * (1.0 + spread):
        cfg, tuned_s = base_cfg, default_s
    db.put(kernel, skey, cfg, hardware=hw, objective=tuned_s)
    return {"workload": workload, "kernel": kernel, "shape": skey,
            "hardware": hw, "source": "tuned", "trials": len(res.records),
            "config": cfg, "default_s": default_s, "tuned_s": tuned_s,
            "speedup": default_s / max(tuned_s, 1e-12),
            "winner": winner, "winner_s": winner_s, "spread": spread,
            "tuning_time_s": res.tuning_time_s,
            "wall_time_s": res.wall_time_s,
            "kernel_calls": dict(backend.kernel_calls)}


def install_kernel_db(spec: str,
                      db: Optional[KernelConfigDB] = None) -> int:
    """Prime a find-db (the process-wide one by default) from a golden
    table JSON at ``spec``. Returns the number of rows installed. A
    service journal or a ``tcp://`` store raises: both need the service
    package."""
    db = db if db is not None else findb.get_find_db()
    if spec.startswith("tcp://"):
        raise NotImplementedError(
            f"{spec}: a live store (tcp://) needs the service package, "
            f"which the port does not have yet ({_ITEM12}); use a golden "
            "table")
    try:
        rows = load_golden(spec)
    except GroundTruthError as e:
        raise NotImplementedError(
            f"{e}. A service journal needs the service package, which the "
            f"port does not have yet ({_ITEM12}); use a golden table") \
            from None
    return db.merge_rows(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.tune",
        description="Kernel autotuning + find-db golden loop")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="tune workloads, persist winners")
    t.add_argument("--workload", action="append", default=None,
                   metavar="SPEC", help="preset name or kernel@k=v,... "
                   f"(presets: {', '.join(sorted(PRESETS))}); repeatable; "
                   f"default: {', '.join(DEFAULT_WORKLOADS)}")
    t.add_argument("--scheduler", default="grid")
    t.add_argument("--trials", type=int, default=None,
                   help="trial budget (random scheduler)")
    t.add_argument("--reps", type=int, default=3)
    t.add_argument("--warmup", type=int, default=1)
    t.add_argument("--golden", default=None, metavar="PATH",
                   help="also write/refresh a golden table at PATH")
    t.add_argument("--force", action="store_true",
                   help="re-tune even on a find-db hit")
    t.add_argument("--device", default=None,
                   help="cuda (default) or cpu (times the plain versions)")

    e = sub.add_parser("export", help="dump a golden config table")
    e.add_argument("--out", required=True, metavar="PATH")
    e.add_argument("--golden", default=None, metavar="PATH")

    s = sub.add_parser("show", help="print find-db rows")
    s.add_argument("--golden", default=None, metavar="PATH")

    args = ap.parse_args(argv)
    if args.cmd == "tune":
        dev = device_lib.resolve(args.device)
        specs = args.workload or list(DEFAULT_WORKLOADS)
        db = findb.get_find_db()
        if args.golden:
            try:
                db.merge_rows(load_golden(args.golden))
            except GroundTruthError:           # no table yet: a fresh one
                pass
        summaries = [tune_kernel(w, db=db, scheduler=args.scheduler,
                                 trials=args.trials, reps=args.reps,
                                 warmup=args.warmup, force=args.force,
                                 device=dev)
                     for w in specs]
        if args.golden:
            export_golden(db.rows(), args.golden)
        json.dump(summaries, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    if not args.golden:
        raise SystemExit("need a source: --golden PATH (--store and "
                         "--journal need the service package, which the "
                         f"port does not have yet: {_ITEM12})")
    rows = load_golden(args.golden)
    if args.cmd == "export":
        n = export_golden(rows, args.out)
        print(f"exported {n} entries -> {args.out}")
        return 0
    json.dump(rows, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
