"""Training backends behind PipeTune's trial runner: the counterpart of
``repro.core.backends``.

A backend trains (or, for the kernel tuner, times) one trial an epoch at a
time: ``init_trial`` makes a ``TrialState``, ``run_epoch`` advances it under
a system config and returns an ``EpochResult``.

TorchRealBackend — trains the paper's small workloads (Table 3) for real on
                   one device, epoch at a time, with per-epoch switchable
                   system parameters (microbatching, remat, precision);
                   registered as ``"real"``.
``repro_torch.kernels.tune.KernelTuneBackend`` times kernel variants;
``repro_torch.cluster.sim.SimBackend`` models epochs (same interface).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.core import energy as energy_lib
from repro_torch.core.profiler import EpochProfile, Profiler
from repro_torch.core.seeding import stable_hash
from repro_torch.data import synthetic
from repro_torch.models import small
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map

# Memory-conservative production default (grad accumulation + remat —
# the "safe" config an operator picks without workload knowledge; the paper's
# trials likewise all start from one fixed default). PipeTune's probing
# discovers when the aggressive configs fit and are faster.
SYS_DEFAULT = {"remat": "block", "microbatches": 4, "precision": "fp32"}

# threads that run their epochs as the main thread does (``serial_lane``)
_SERIAL = threading.local()


@contextlib.contextmanager
def serial_lane():
    """Run the calling thread's epochs as a serial run on the main thread
    does: on the thread's current stream (the default stream, unless the
    caller entered another), not on a lane stream of its own. A trial
    worker's RPC handler threads take turns running one trial at a time
    (``repro_torch.service.worker``); under this context a trial there runs
    on the stream, and through the step cache, that an in-process trial
    would."""
    prev = getattr(_SERIAL, "on", False)
    _SERIAL.on = True
    try:
        yield
    finally:
        _SERIAL.on = prev


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a training backend can do, declared instead of duck-typed.

    async_precompile — candidate system configs compile off the critical path
                       (the runner may call ``precompile_async``).
    simulated        — epochs are modeled, not executed (wall time is free).
    deterministic    — ``run_epoch`` is a pure function of (state, sys_cfg),
                       so results are bit-identical regardless of the order
                       trials execute in (safe for parallel executors that
                       need reproducibility).
    """
    async_precompile: bool = False
    simulated: bool = False
    deterministic: bool = False


def backend_capabilities(backend) -> BackendCapabilities:
    """Capabilities of ``backend``, with a duck-typing fallback for
    third-party backends that predate the protocol."""
    fn = getattr(backend, "capabilities", None)
    if fn is not None:
        return fn()
    return BackendCapabilities(
        async_precompile=callable(getattr(backend, "precompile_async", None)))


def sys_key(sys_cfg: dict) -> str:
    return "|".join(f"{k}={sys_cfg[k]}" for k in sorted(sys_cfg))


@dataclasses.dataclass
class EpochResult:
    duration_s: float
    energy_j: float
    loss: float
    accuracy: float
    profile: EpochProfile
    sys_config: dict
    step_times: list
    compile_s: float = 0.0


@dataclasses.dataclass
class TrialState:
    workload: str
    hparams: dict
    cfg: Any
    params: Any
    opt_state: Any
    step: int
    epoch: int
    data: Any              # Batches
    eval_batch: dict
    seed: int
    loss_last: float = float("nan")


def _strip_first_step(step_times: list, compile_s: float) -> float:
    """The reference's compile strip: the first call of a freshly built step
    pays one-time costs (on the card: cuDNN's algorithm choice and the
    allocator's warm-up), which belong to ``compile_s``, not to training
    time. When at least 3 steps ran and the first took more than 3x the
    median of the rest, the excess moves to ``compile_s`` and the first step
    is booked at that median. Edits ``step_times`` in place; returns the new
    ``compile_s``. Applied to every epoch alike, so probe measurements
    compare warm against warm."""
    if len(step_times) >= 3:
        med = float(np.median(step_times[1:]))
        if step_times[0] > 3.0 * med:
            compile_s += step_times[0] - med
            step_times[0] = med
    return compile_s


class TorchRealBackend:
    """Trains ``repro_torch.models.small`` workloads for real (paper Table
    3), the counterpart of the reference's ``RealBackend``.

    It differs from the reference where PyTorch does:
    - ``device``: ``cuda`` unless the caller passes ``"cpu"``
      (``device.resolve``). Weights are drawn on the CPU from the trial seed
      and moved, so a trial starts from the same weights on either device.
    - The step runs eagerly. ``remat != "none"`` runs the loss under
      ``torch.utils.checkpoint(use_reentrant=False)``; ``microbatches`` is
      gradient accumulation, with grads, loss and accuracy averaged over the
      microbatches; ``precision="bf16"`` casts the parameters and float
      inputs inside the loss, with fp32 masters. The reference's donation
      is the in-place update of the parameters.
    - Step times are host wall time around the step, ended by a
      synchronise of the lane's own CUDA stream on the card (see below);
      the batch moves to the device before the timer starts.
    - Eager PyTorch has nothing to compile off the critical path, so
      ``capabilities()`` declares ``async_precompile=False`` (PipeTune's
      precompile branch is never taken); ``compile_s`` holds the step's
      build time (building the closures) plus the first-step strip
      (``_strip_first_step``).
    - Step times are host-noisy, so runs are not bit-reproducible
      (``deterministic=False``), and epochs are executed, not modeled.

    Concurrent trials (``ParallelTrialExecutor``'s lanes, one host thread
    each) share one backend:
    - The step cache is locked, and a step is built once per key.
    - On the card each lane trains on a CUDA stream of its own
      (``lane_stream``: the caller's current stream on the main thread, so
      a serial run is what it was; a new stream on every other thread).
      PyTorch's current stream is per thread, so a lane's stream context
      does not leak into the others. A step's timer ends with a
      synchronise of that stream alone, so a trial's step time does not
      wait for its neighbours' kernels. It does still wait for them on the
      host: every lane dispatches its ops under the one GIL, so under
      lanes a step's time, the epoch's ``duration_s`` and ``energy_j``,
      ``JobResult.tuning_time_s`` and PipeTune's duration-based probes
      (which pick the system config) measure the trial together with its
      wave-mates' hold-ups, not the trial alone. Tune system parameters
      on a serial run.
    - A trial may move between lanes at an epoch boundary (a HyperBand
      rung resume lands on whichever lane is free). Its params and
      optimizer state were allocated on another stream, so at the start of
      each epoch the lane marks them with ``Tensor.record_stream``: when
      the lane frees one (the optimizer replaces its state every step), the
      caching allocator waits for the lane's queued kernels before it hands
      the block out again. The lane also waits for the default stream,
      where a lane thread makes a trial's initial weights (outside
      ``run_epoch`` a lane runs on it) and the thread running the job a
      PBT clone's copies.
    - Randomness is explicit (weights from a CPU generator seeded by the
      trial, batches from the trial's numpy generator, dropout from a
      generator seeded per step); nothing touches the global RNG.
    - The device, and with it the process's TF32 flags, is resolved once,
      here.
    """

    def __init__(self, n_train: int = 2048, n_eval: int = 512,
                 steps_per_epoch: Optional[int] = 8, device=None):
        self.device = device_lib.resolve(device)
        self.n_train, self.n_eval = n_train, n_eval
        self.steps_per_epoch = steps_per_epoch
        self._step_cache: Dict[tuple, Any] = {}
        self._lock = threading.Lock()       # the step cache
        self._lanes = threading.local()     # a lane's own CUDA stream
        self.profiler = Profiler(self.device)

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(async_precompile=False, simulated=False,
                                   deterministic=False)

    # ------------------------------------------------------------------ data
    def _dataset(self, workload: str, seed: int):
        cfg = configs.get_config(workload)
        wl_seed = seed + stable_hash(workload) % 1000
        if cfg.kind == "lenet":
            d = synthetic.make_image_dataset(wl_seed,
                                             self.n_train + self.n_eval,
                                             n_classes=cfg.n_classes)
        else:
            d = synthetic.make_text_dataset(wl_seed,
                                            self.n_train + self.n_eval,
                                            n_classes=cfg.n_classes,
                                            vocab=cfg.vocab,
                                            seq_len=cfg.seq_len)
        return synthetic.train_test_split(d, test_frac=self.n_eval /
                                          (self.n_train + self.n_eval),
                                          seed=seed)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    # ----------------------------------------------------------------- trial
    def init_trial(self, workload: str, hparams: dict, seed: int = 0
                   ) -> TrialState:
        cfg = configs.get_config(workload)
        upd = {}
        if "embed_dim" in hparams and cfg.kind != "lenet":
            upd["embed_dim"] = int(hparams["embed_dim"])
        if "dropout" in hparams:
            upd["dropout"] = float(hparams["dropout"])
        cfg = dataclasses.replace(cfg, **upd)
        train, test = self._dataset(workload, seed)
        bs = int(hparams.get("batch_size", 64))
        bs = min(bs, len(next(iter(train.values()))))
        data = synthetic.Batches(train, bs, seed=seed)
        params = tree_map(lambda a: a.to(self.device),
                          small.init(torch.Generator().manual_seed(seed), cfg))
        opt = self._opt(hparams)
        return TrialState(workload=workload, hparams=dict(hparams), cfg=cfg,
                          params=params, opt_state=opt.init(params), step=0,
                          epoch=0, data=data,
                          eval_batch={k: v[:256] for k, v in test.items()},
                          seed=seed)

    def _opt(self, hparams):
        lr = float(hparams.get("learning_rate", 0.01))
        return optimizers.sgd(lr, momentum=0.9)

    # ------------------------------------------------------- step functions
    def _build_step(self, cfg, hparams, sys_cfg):
        opt = self._opt(hparams)
        n_micro = int(sys_cfg.get("microbatches", 1))
        remat = sys_cfg.get("remat", "none")
        dtype = device_lib.compute_dtype(sys_cfg.get("precision", "fp32"))

        def loss_fn(params, batch, rng):
            cparams = tree_map(lambda a: a.to(dtype)
                               if a.is_floating_point() else a, params)
            batch = {k: (v.to(dtype) if v.is_floating_point() else v)
                     for k, v in batch.items()}
            loss, metrics = small.loss_fn(cparams, batch, cfg, rng=rng)
            return loss.float(), metrics["accuracy"].float()

        if remat != "none":
            plain_loss = loss_fn

            def loss_fn(params, batch, rng):
                return ckpt.checkpoint(plain_loss, params, batch, rng,
                                       use_reentrant=False)

        def grads_of(params, batch, rng):
            leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
            it = iter(leaves)
            loss, acc = loss_fn(tree_map(lambda _: next(it), params), batch,
                                rng)
            grads = torch.autograd.grad(loss, leaves)
            return list(grads), loss.detach(), acc.detach()

        def train_step(params, opt_state, step, batch, rng):
            if n_micro > 1:
                B = next(iter(batch.values())).shape[0]
                g_sum, l_sum, a_sum = None, 0.0, 0.0
                for i in range(n_micro):
                    mb = {k: x.reshape((n_micro, B // n_micro)
                                       + x.shape[1:])[i]
                          for k, x in batch.items()}
                    g, loss, acc = grads_of(params, mb, rng)
                    if g_sum is None:
                        g_sum = [x.float() for x in g]
                    else:
                        torch._foreach_add_(g_sum, g)
                    l_sum, a_sum = l_sum + loss, a_sum + acc
                torch._foreach_mul_(g_sum, 1.0 / n_micro)
                grads, loss, acc = g_sum, l_sum / n_micro, a_sum / n_micro
            else:
                grads, loss, acc = grads_of(params, batch, rng)
            it = iter(grads)
            updates, opt_state = opt.update(
                tree_map(lambda _: next(it), params), opt_state, params, step)
            with torch.no_grad():       # the reference's donation: in place
                torch._foreach_add_(tree_leaves(params),
                                    tree_leaves(updates))
            return params, opt_state, loss, acc

        @torch.no_grad()
        def eval_step(params, batch):
            logits = small.forward(params, batch, cfg)
            return torch.mean((torch.argmax(logits, -1)
                               == batch["labels"].long()).float())
        return train_step, eval_step

    def _step_key(self, ts: TrialState, sys_cfg: dict):
        """Everything ``_build_step`` bakes into the step. The reference's
        key leaves out ``learning_rate``, so there a trial reuses the step
        (and the learning rate) of an earlier trial that differs only in
        it; here the learning rate is part of the key."""
        hp = ts.hparams
        return (ts.workload, hp.get("embed_dim"), hp.get("dropout"),
                int(hp.get("batch_size", 64)),
                float(hp.get("learning_rate", 0.01)), sys_key(sys_cfg))

    def _effective_sys(self, ts: TrialState, sys_cfg: dict) -> dict:
        """Fill sys-config keys the caller left unspecified from the kernel
        find-db's tuned ``train_step`` entry for this (workload, batch) on
        this device.

        Explicit keys always win, so tuner-driven probing (which passes
        complete configs) is byte-for-byte unaffected; only callers that
        rely on defaults pick up tuned values. Idempotent, and applied
        before ``_step_key`` everywhere so cache keys stay coherent."""
        from repro_torch.kernels import findb
        tuned = findb.lookup_or_default(
            "train_step", findb.train_step_shape_key(
                arch=ts.workload, batch=int(ts.hparams.get("batch_size", 64))),
            default={}, hardware=findb.hardware_key(self.device))
        fill = {k: v for k, v in tuned.items()
                if k not in sys_cfg
                and k in ("remat", "microbatches", "precision", "donate")}
        return {**fill, **sys_cfg} if fill else sys_cfg

    def get_step(self, ts: TrialState, sys_cfg: dict):
        """(train_step, eval_step), building if needed; and the build's
        seconds (0 on a cache hit). Lanes asking for the same key at once
        get one build: it runs under the cache's lock (a build only makes
        closures)."""
        sys_cfg = self._effective_sys(ts, sys_cfg)
        key = self._step_key(ts, sys_cfg)
        with self._lock:
            if key in self._step_cache:
                return self._step_cache[key], 0.0
            t0 = time.perf_counter()
            pair = self._build_step(ts.cfg, ts.hparams, sys_cfg)
            self._step_cache[key] = pair
        return pair, time.perf_counter() - t0

    # ----------------------------------------------------------------- lanes
    def lane_stream(self):
        """The CUDA stream the calling thread's epochs run on (None on the
        CPU): the current stream on the main thread and under
        ``serial_lane``, a stream of the thread's own on any other."""
        if self.device.type != "cuda":
            return None
        if threading.current_thread() is threading.main_thread() or \
                getattr(_SERIAL, "on", False):
            return torch.cuda.current_stream(self.device)
        stream = getattr(self._lanes, "stream", None)
        if stream is None:
            stream = self._lanes.stream = torch.cuda.Stream(self.device)
        return stream

    def _claim(self, ts: TrialState, stream) -> None:
        """Make ``stream`` safe to run ``ts`` on (see the class doc): wait
        for the default stream and mark the state's tensors as used here."""
        default = torch.cuda.default_stream(self.device)
        if stream == default:
            return
        stream.wait_stream(default)
        for t in tree_leaves([ts.params, ts.opt_state]):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(stream)

    @staticmethod
    def _sync(stream):
        if stream is not None:
            stream.synchronize()

    # ----------------------------------------------------------------- epoch
    def run_epoch(self, ts: TrialState, sys_cfg: dict, collect_profile=True
                  ) -> Tuple[TrialState, EpochResult]:
        stream = self.lane_stream()
        if stream is None:
            return self._run_epoch(ts, sys_cfg, collect_profile, None)
        with torch.cuda.stream(stream):
            self._claim(ts, stream)
            return self._run_epoch(ts, sys_cfg, collect_profile, stream)

    def _run_epoch(self, ts: TrialState, sys_cfg: dict, collect_profile,
                   stream) -> Tuple[TrialState, EpochResult]:
        sys_cfg = self._effective_sys(ts, sys_cfg)
        (train_step, eval_step), compile_s = self.get_step(ts, sys_cfg)
        n_micro = int(sys_cfg.get("microbatches", 1))
        bs = int(ts.hparams.get("batch_size", 64))
        bs = (bs // n_micro) * n_micro if bs >= n_micro else n_micro
        params, opt_state = ts.params, ts.opt_state
        step_times, losses, accs = [], [], []
        n_steps = 0
        for batch in ts.data.epoch(ts.epoch):
            if self.steps_per_epoch and n_steps >= self.steps_per_epoch:
                break
            b = self._to_device({k: v[:bs] for k, v in batch.items()})
            # dropout seed of this step: (trial seed, epoch, step)
            rng = (ts.seed * 7919 + ts.epoch) * 1000003 + n_steps
            self._sync(stream)
            t0 = time.perf_counter()
            params, opt_state, loss, acc = train_step(
                params, opt_state, ts.step, b, rng)
            self._sync(stream)
            step_times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            accs.append(float(acc))
            ts.step += 1
            n_steps += 1
        compile_s = _strip_first_step(step_times, compile_s)
        acc = float(eval_step(params, self._to_device(ts.eval_batch)))
        util = 0.5          # the reference's utilization proxy
        e = energy_lib.epoch_energy(step_times, util, chips=1)
        profile = None
        if collect_profile:
            profile = self.profiler.build(
                step_times=step_times,
                sys_config=None,
                workload_meta={"batch": bs,
                               "seq_or_dim": getattr(ts.cfg, "seq_len", 28),
                               "params": sum(p.numel() for p in
                                             tree_leaves(ts.params)),
                               "layers": 2, "d_model":
                                   getattr(ts.cfg, "embed_dim", 0),
                               "vocab": getattr(ts.cfg, "vocab", 0)},
                loss_start=losses[0] if losses else 0.0,
                loss_end=losses[-1] if losses else 0.0,
                power_w=energy_lib.power_w(util, 1), compile_time=compile_s,
                tokens_per_step=bs)
        ts.params, ts.opt_state = params, opt_state
        ts.epoch += 1
        ts.loss_last = losses[-1] if losses else float("nan")
        return ts, EpochResult(
            duration_s=float(np.sum(step_times)), energy_j=e,
            loss=ts.loss_last, accuracy=acc,
            profile=profile or EpochProfile({}), sys_config=dict(sys_cfg),
            step_times=step_times, compile_s=compile_s)
