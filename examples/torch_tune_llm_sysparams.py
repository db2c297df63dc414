"""PipeTune on an LM training job, on the PyTorch port: tune the system
parameters (remat / microbatches / precision) per epoch while hyper-tuning
the learning rate.

The job of ``examples/tune_llm_sysparams.py`` on ``repro_torch``, and the
demonstration of the ``repro_torch.api`` extension story: a user-defined
backend implements the three-method ``Backend`` protocol (init_trial /
run_epoch / capabilities), registers itself under a name, and the
``Experiment`` facade drives it like any built-in. Every train step runs
the port's LM step (``launch.steps.make_train_step``) with ``use_pallas``
at its default, so on the card each layer's attention is the hand-written
flash kernels: B1 forward, B2 and B3 backward (their fp32 variants here).
Subclasses change the model by overriding ``_cfg()``.

    PYTHONPATH=src python examples/torch_tune_llm_sysparams.py [--device cpu]

Trials train on the card; without a GPU the script raises unless
``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.api import Experiment, register_backend
from repro_torch.core import GroundTruth, SystemSpace
from repro_torch.core import energy
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       TrialState)
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.core.profiler import Profiler
from repro_torch.data import synthetic
from repro_torch.launch import steps as steps_lib
from repro_torch.models.transformer import ModelConfig, SystemConfig
from repro_torch.optim import optimizers

UTIL = 0.5          # the reference's utilization proxy for a training step


class LMBackend:
    """Epoch-at-a-time LM trainer with switchable system params.

    A trial's weights are drawn from its seed on the device, as
    ``launch.train`` draws them. A step is timed on the host clock between
    two synchronises of the device; energy is the port's H100 power
    model."""

    def __init__(self, steps_per_epoch=6, device=None):
        self.device = device_lib.resolve(device)
        self.steps_per_epoch = steps_per_epoch
        self.profiler = Profiler(self.device)
        self._cache = {}

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(async_precompile=False, simulated=False,
                                   deterministic=False)

    def _cfg(self):
        return ModelConfig(name="tune-lm", family="dense", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                           vocab=512, head_dim=32)

    def init_trial(self, workload, hparams, seed=0):
        cfg = self._cfg()
        opt = optimizers.adamw(float(hparams.get("learning_rate", 3e-4)))
        state = steps_lib.make_train_state(
            torch.Generator(device=self.device).manual_seed(seed), cfg, opt,
            self.device)
        toks = synthetic.make_lm_dataset(seed, 64 * 8 * 64, cfg.vocab)
        stream = toks[:64 * 8 * 64].reshape(-1, 8, 64)
        return TrialState(workload=workload, hparams=dict(hparams), cfg=cfg,
                          params=(state, opt), opt_state=None, step=0,
                          epoch=0, data=stream, eval_batch={}, seed=seed)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_epoch(self, ts, sys_cfg, collect_profile=True):
        state, opt = ts.params
        cfg = ts.cfg
        sys = SystemConfig(microbatches=int(sys_cfg.get("microbatches", 1)),
                           remat=sys_cfg.get("remat", "none"),
                           precision=sys_cfg.get("precision", "fp32"))
        key = ("step", str(sys_cfg), ts.hparams.get("learning_rate"))
        if key not in self._cache:
            self._cache[key] = steps_lib.make_train_step(cfg, sys, opt)
        step_fn = self._cache[key]
        times, losses = [], []
        for i in range(self.steps_per_epoch):
            chunk = ts.data[(ts.step + i) % len(ts.data)]
            batch = {"tokens": torch.from_numpy(chunk).to(self.device,
                                                          torch.long),
                     "labels": torch.from_numpy(np.roll(chunk, -1, -1)).to(
                         self.device, torch.long)}
            self._sync()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            self._sync()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        ts.params = (state, opt)
        ts.step += self.steps_per_epoch
        ts.epoch += 1
        power = energy.power_w(UTIL, 1)
        prof = self.profiler.build(step_times=times, loss_start=losses[0],
                                   loss_end=losses[-1], power_w=power,
                                   tokens_per_step=8 * 64)
        return ts, EpochResult(
            duration_s=float(np.sum(times)),
            energy_j=energy.epoch_energy(times, UTIL, 1),
            loss=losses[-1], accuracy=-losses[-1], profile=prof,
            sys_config=dict(sys_cfg), step_times=times)


register_backend("lm", LMBackend, sys_space=lambda **_: SystemSpace(
    remat=("none", "block"), microbatches=(1, 2, 4), precision=("fp32",)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    space = SearchSpace([Param("learning_rate", "log", 1e-4, 1e-2)])
    job = HPTJob(workload="tune-lm", space=space, max_epochs=6)
    res = (Experiment(job)
           .with_tuner("pipetune", max_probes=4)
           .with_backend("lm", device=args.device)
           .with_groundtruth(GroundTruth())
           .with_scheduler("random", n_trials=3)
           .run())
    best = res.best_record
    print(f"best lr: {res.best_hparams.get('learning_rate'):.2e} "
          f"(final loss {-res.best_accuracy:.3f})")
    print(f"system config locked by PipeTune: {best.sys_history[-1]}")
    durs = {}
    for rec in res.records.values():
        for e in rec.epochs:
            durs.setdefault(str(e.sys_config), []).append(e.duration_s)
    print("epoch time by system config:")
    for k, v in sorted(durs.items(), key=lambda kv: np.mean(kv[1])):
        print(f"  {np.mean(v):6.2f}s  {k}")
    return res


if __name__ == "__main__":
    main()
