"""Train an LM on a synthetic token stream: the counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 6 --batch 4 --seq 2048 --precision bf16 \\
        [--microbatches 1] [--remat none|block|dots] [--device cpu] \\
        [--kernel-db golden.json]

As in the reference: adamw over ``warmup_cosine(lr, 10, steps)`` with weight
decay 0.01, tokens from ``make_lm_dataset(0, batch * seq * 32, vocab)``, the
labels the tokens shifted by one (``np.roll``), a line every 10 steps, and
the system flags ``--microbatches/--remat/--precision`` (precision fp32 by
default). The reference's ``--reduced`` flag is a ``store_true`` that
defaults to True, so its command line always trains the reduced config;
here ``--arch`` names the config, as in ``repro_torch.launch.serve``:
``qwen3-0.6b`` is full width, ``qwen3-0.6b-reduced`` the smoke config.
Weights come from ``transformer.init`` on a ``torch.Generator`` seeded with
0. ``--kernel-db`` primes the kernel find-db from a golden table before the
first step, as in the reference. Checkpointing (``--ckpt``) is not ported
yet (ROADMAP.md queue A, item 'Checkpoint').

Step times are CUDA events on the card (the host clock on the CPU); the
first step is left out of the mean. Without a GPU the command raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.data import synthetic
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.sysargs import (add_kernel_db_arg, add_system_args,
                                        install_kernel_db_from_args,
                                        system_config_from_args)
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers


@dataclasses.dataclass
class TrainResult:
    cfg: T.ModelConfig
    sys: T.SystemConfig
    losses: List[float]
    accuracies: List[float]
    step_ms: List[float]            # every step, the first included
    tokens_per_step: int
    peak_memory_bytes: Optional[int]   # None on the CPU
    device_name: str
    kernel_db_rows: int = 0         # rows --kernel-db installed

    @property
    def ms_per_step(self) -> float:
        """Mean over the steps after the first (all of them if only one)."""
        timed = self.step_ms[1:] or self.step_ms
        return sum(timed) / len(timed)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_per_step / (self.ms_per_step / 1e3)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="arch id, or <arch>-reduced for the smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    add_system_args(ap)
    add_kernel_db_arg(ap)   # tuned kernel configs from a prior tune run
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    args = parser().parse_args(argv)
    dev = device_lib.resolve(args.device)
    cfg = configs.get(args.arch)
    kernel_db_rows = install_kernel_db_from_args(args)
    sys = system_config_from_args(args)
    opt = optimizers.adamw(
        optimizers.warmup_cosine(args.lr, 10, args.steps), weight_decay=0.01)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = steps_lib.make_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt, dev)
    step_fn = steps_lib.make_train_step(cfg, sys, opt)

    toks = synthetic.make_lm_dataset(0, args.batch * args.seq * 32, cfg.vocab)
    stream = toks.reshape(-1, args.batch, args.seq)
    losses, accs, step_ms = [], [], []
    for step in range(args.steps):
        chunk = stream[step % len(stream)]
        batch = {"tokens": torch.from_numpy(chunk).to(dev, torch.long),
                 "labels": torch.from_numpy(np.roll(chunk, -1, -1)).to(
                     dev, torch.long)}
        with device_lib.Timer(dev) as timer:
            state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["accuracy"]))
        step_ms.append(timer.ms)
        if (step + 1) % 10 == 0:
            print(f"step {step + 1:4d} loss={losses[-1]:.4f} "
                  f"({sum(step_ms[-10:]) / 10e3:.2f}s/step)")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    res = TrainResult(cfg=cfg, sys=sys, losses=losses, accuracies=accs,
                      step_ms=step_ms, tokens_per_step=args.batch * args.seq,
                      peak_memory_bytes=peak, device_name=name,
                      kernel_db_rows=kernel_db_rows)
    print(f"done: final loss {losses[-1] if losses else float('nan'):.4f}")
    if losses:
        print(f"trained {cfg.name} on {name}: {args.steps} steps of "
              f"{args.batch}x{args.seq} tokens, {res.ms_per_step:.3f} "
              f"ms/step ({res.tokens_per_s:,.0f} tok/s)")
    return res


if __name__ == "__main__":
    main()
