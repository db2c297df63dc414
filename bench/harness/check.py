"""The comparison that decides ``correct`` for a training cell.

The program's readings come from the steps that its window's own call
ran: each step's loss, the first gradient as adamw got it (its first
moment after one step over 1 - b1) and each leaf's change after the
checked steps. The reference (``bench/references/<reference>.py``)
follows the same steps from the same weights and batches, which the
benchmark regenerates from the seed. Three numbers are compared, each
with its limit from the cell's workload file:

* ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss;
* ``grad_gap``: the worst leaf's |program's norm - reference's norm| of
  the first gradient, over the larger of the reference's norm of that
  leaf and of the median leaf;
* ``change_gap``: the same of each leaf's change after the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under adamw by round-off alone).
"""
from __future__ import annotations

import importlib
import statistics

import torch

from bench.harness import weights

NEGLIGIBLE = 1e-3     # of the median leaf's reference gradient


def reference_module(cfg: dict):
    return importlib.import_module(f"bench.references.{cfg['reference']}")


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |prog - ref| / max(ref, median(ref))}."""
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if keep is None or k in keep}


def moving_leaves(ref: dict) -> set:
    med = statistics.median(ref["grad"].values())
    return {k for k, g in ref["grad"].items() if g >= NEGLIGIBLE * med}


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers of one run: ``prog`` and ``ref`` each hold
    "losses", "grad" ({leaf: norm}) and "change" ({leaf: norm})."""
    n = len(ref["losses"])
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"][:n], ref["losses"])),
        "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"]).values()),
        "change_gap": max(leaf_gaps(prog["change"], ref["change"],
                                    moving_leaves(ref)).values()),
    }


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, none missing or not finite."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out


def change_norms(flat: dict, cfg: dict, seed: int, device, *names) -> dict:
    """{leaf: ||now - initial||}: the initial weights regenerated from the
    seed (the same stream as ``weights.init_params``)."""
    init = weights.init_params(cfg, seed, device, *names)
    with torch.no_grad():
        out = {k: float((flat[k] - init[k]).norm()) for k in init}
    del init
    return out


def run_reference(cfg: dict, seed: int, device, batches, hp: dict,
                  names=(), mode: str = "fp32") -> dict:
    """The reference's readings over ``batches`` from the seed's initial
    weights: {"losses", "grad", "raw_grad", "change"}."""
    ref = reference_module(cfg)
    flat = weights.init_params(cfg, seed, device, *names)
    out = ref.train(flat, batches, cfg, hp, mode=mode)
    out["change"] = change_norms(flat, cfg, seed, device, *names)
    del flat
    return out


def leaf_detail(prog: dict, ref: dict) -> dict:
    """Each leaf's gaps, to find which leaf sets a worst-leaf number."""
    return {"grad": leaf_gaps(prog["grad"], ref["grad"]),
            "change": leaf_gaps(prog["change"], ref["change"],
                                moving_leaves(ref))}
