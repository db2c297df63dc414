"""Backend running the Type-III numeric workloads for real (paper Fig 12):
the counterpart of ``repro.core.numeric_backend``.

Short epochs (a few milliseconds on the card) make the profiling and
probing overhead proportionally large: the paper's hardest setting for
PipeTune. System knobs, as in the reference: precision (fp32/bf16) and
``microbatches``, the number of times the epoch function runs in one epoch.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import energy as energy_lib
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       TrialState, _strip_first_step)
from repro_torch.core.profiler import Profiler
from repro_torch.models import numeric


class TorchNumericBackend:
    """Runs ``repro_torch.models.numeric`` workloads on ``device`` (``cuda``
    unless the caller passes ``"cpu"``). Each run of the epoch function is
    timed on the host clock between two synchronises of the calling
    thread's current stream, which the reference does with
    ``jax.block_until_ready``; eager PyTorch compiles nothing, so the
    reference's first-call strip only ever evens out a slow first run.
    Energy is the port's H100 power model at the reference's utilization
    proxy of 0.6."""

    def __init__(self, device: device_lib.DeviceLike = None):
        self.device = device_lib.resolve(device)
        self.profiler = Profiler(self.device)
        self._cache: Dict[tuple, object] = {}

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(async_precompile=False, simulated=False,
                                   deterministic=False)

    def init_trial(self, workload: str, hparams: dict, seed: int = 0
                   ) -> TrialState:
        cfg = numeric.CONFIGS[workload]
        state = numeric.init_state(cfg, seed, self.device)
        return TrialState(workload=workload, hparams=dict(hparams), cfg=cfg,
                          params=state, opt_state=None, step=0, epoch=0,
                          data=None, eval_batch={}, seed=seed)

    def _epoch_fn(self, cfg, sys_cfg):
        dtype = device_lib.compute_dtype(
            "bf16" if sys_cfg.get("precision") == "bf16" else "fp32")
        key = (cfg.name, str(dtype))
        if key not in self._cache:
            self._cache[key] = numeric._epoch_fn(cfg, dtype)
        return self._cache[key]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run_epoch(self, ts: TrialState, sys_cfg: dict, collect_profile=True
                  ) -> Tuple[TrialState, EpochResult]:
        cfg = ts.cfg
        fn = self._epoch_fn(cfg, sys_cfg)
        reps = max(1, int(sys_cfg.get("microbatches", 1)))
        times = []
        aux = None
        state = ts.params
        for _ in range(reps):
            self._sync()
            t0 = time.perf_counter()
            state, aux = fn(state)
            self._sync()
            times.append(time.perf_counter() - t0)
        _strip_first_step(times, 0.0)         # the reference drops the excess
        acc = numeric.accuracy(cfg, state, aux)
        ts.params = state
        ts.epoch += 1
        util = 0.6
        profile = self.profiler.build(
            step_times=times, power_w=energy_lib.power_w(util, 1),
            loss_start=1 - acc, loss_end=1 - acc,
            workload_meta={"batch": cfg.size, "seq_or_dim": cfg.size,
                           "params": cfg.size ** 2, "layers": 1,
                           "d_model": cfg.size, "vocab": 0},
            tokens_per_step=cfg.size)
        return ts, EpochResult(
            duration_s=float(np.sum(times)),
            energy_j=energy_lib.epoch_energy(times, util, 1),
            loss=1 - acc, accuracy=acc, profile=profile,
            sys_config=dict(sys_cfg), step_times=times)
