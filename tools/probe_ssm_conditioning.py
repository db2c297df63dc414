"""How far one fp32 step moves xlstm-350m's logits and loss gradients.

    PYTHONPATH=src python tools/probe_ssm_conditioning.py [--layers 8] \\
        [--seq 512] [--noise 6e-8] [--seed 1]

Runs the port's xlstm-350m at full width, cut to ``--layers`` layers, in
fp32 on the CPU, twice from the same seeded weights and tokens: once as
drawn, once with every weight multiplied by (1 + noise * N(0, 1)), noise
about one fp32 step. It prints, as ``chip_smoke.py``'s ``[ssm]`` card
against CPU check measures them, max|d| / max|ref| of the logits and of
the worst loss-gradient leaves: the spread that rounding alone gives, and
so the floor under any limit on the card's distance from the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs, weights
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


def logits_and_grads(params, batch, cfg, sys_):
    flat = {k: v.detach().requires_grad_()
            for k, v in weights.flatten(params).items()}
    loss, _ = T.loss_fn(weights.unflatten(flat), batch, cfg, sys_)
    grads = torch.autograd.grad(loss, list(flat.values()))
    with torch.no_grad():
        logits = T.forward(params, {"tokens": batch["tokens"]}, cfg, sys_)[0]
    return logits, dict(zip(flat, grads))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--noise", type=float, default=6e-8)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(configs.get("xlstm-350m"),
                              n_layers=args.layers)
    params = T.init(torch.Generator().manual_seed(args.seed), cfg, "cpu")
    gen = torch.Generator().manual_seed(args.seed + 1)
    nudged = tree_map(lambda a: a * (1 + args.noise * torch.randn(
        a.shape, generator=gen)), params)
    toks = np.random.default_rng(args.seed).integers(0, cfg.vocab,
                                                     (1, args.seq))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, -1))}
    sys_ = T.SystemConfig(precision="fp32")
    ref_logits, ref_grads = logits_and_grads(params, batch, cfg, sys_)
    logits, grads = logits_and_grads(nudged, batch, cfg, sys_)

    def dist(a, b):
        return float((a - b).abs().max() / b.abs().max())
    print(f"xlstm-350m cut to {args.layers} layers, 1x{args.seq} tokens, "
          f"fp32 on the CPU, weights times (1 + {args.noise:g} N(0, 1)):")
    print(f"  logits {dist(logits, ref_logits):.3e}")
    d = {k: dist(grads[k], g) for k, g in ref_grads.items()}
    for k in sorted(d, key=d.get)[-5:]:
        print(f"  grad {k} {d[k]:.3e}")


if __name__ == "__main__":
    main()
