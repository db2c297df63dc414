"""End-to-end driver on the PyTorch port: train a small LM for a few hundred
steps, with checkpointing and restart.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
        --d-model 256 [--resume] [--device cpu]

The job of ``examples/train_lm.py`` on ``repro_torch``: the same flags and
the same scaled-down qwen3-style decoder (n_heads = max(4, d_model / 64),
n_kv_heads = max(2, d_model / 128), d_ff 4 × d_model, head_dim 64), adamw
over ``warmup_cosine(3e-4, 20, steps)`` with weight decay 0.01, 2
microbatches by default, tokens from ``make_lm_dataset``. A
``CheckpointManager`` (keep 2, the reference's format) saves the train
state every ``--ckpt-every`` steps into ``--ckpt-dir`` (default
``build/torch_train_lm_ckpt`` in the repository); ``--resume`` restores the
newest checkpoint and goes on from its step. Weights come from the port's
seeded ``init``. Trains on the card; without a GPU the script raises unless
``--device cpu`` is given.
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.sysargs import add_system_args, system_config_from_args
from repro_torch.models.transformer import ModelConfig
from repro_torch.optim import optimizers

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / \
    "torch_train_lm_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    add_system_args(ap, microbatches=2)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    cfg = ModelConfig(
        name="example-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128), d_ff=args.d_model * 4,
        vocab=args.vocab, head_dim=64)
    n_params = sum(int(np.prod(s)) for s in weights.leaf_shapes(cfg).values())
    print(f"model: {cfg.n_layers}L d={cfg.d_model} -> {n_params/1e6:.1f}M params")

    opt = optimizers.adamw(optimizers.warmup_cosine(3e-4, 20, args.steps),
                           weight_decay=0.01)
    sys = system_config_from_args(args)
    train_step = steps_lib.make_train_step(cfg, sys, opt)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    state = steps_lib.make_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, opt, dev)
    start = 0
    if args.resume:
        restored, meta = mgr.restore(state, device=dev)
        if restored is not None:
            state, start = restored, meta["step"]
            print(f"resumed from step {start}")

    toks = synthetic.make_lm_dataset(0, args.batch * args.seq * 64, cfg.vocab)
    toks = toks[:len(toks) // (args.batch * args.seq) * args.batch * args.seq]
    stream = toks.reshape(-1, args.batch, args.seq)

    t0, losses = time.time(), []
    for step in range(start, args.steps):
        chunk = stream[step % len(stream)]
        batch = {"tokens": torch.from_numpy(chunk).to(dev, torch.long),
                 "labels": torch.from_numpy(np.roll(chunk, -1, axis=-1)).to(
                     dev, torch.long)}
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, metadata={"step": step + 1})
        if (step + 1) % 20 == 0:
            dt = time.time() - t0
            tok_s = 20 * args.batch * args.seq / dt
            print(f"step {step+1:4d} loss={losses[-1]:.4f} "
                  f"({tok_s:,.0f} tok/s)")
            t0 = time.time()
    mgr.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}) — "
              f"{'LEARNING' if losses[-1] < losses[0] - 0.5 else 'check config'}")
    return losses


if __name__ == "__main__":
    main()
