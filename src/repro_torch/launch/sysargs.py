"""Command-line flags for the system parameters: the counterpart of
``add_system_args`` and ``system_config_from_args`` in
``repro.launch.sysargs``, with the reference's defaults. The executor flags
come with the tuning-loop slice (ROADMAP.md, queue A).
"""
from __future__ import annotations

import argparse

from repro_torch.models.transformer import SystemConfig

SYSTEM_ARG_NAMES = ("microbatches", "remat", "precision")


def add_system_args(ap: argparse.ArgumentParser,
                    microbatches: int = 1, remat: str = "none",
                    precision: str = "fp32") -> argparse.ArgumentParser:
    ap.add_argument("--microbatches", type=int, default=microbatches)
    ap.add_argument("--remat", default=remat,
                    choices=["none", "block", "dots"])
    ap.add_argument("--precision", default=precision,
                    choices=["fp32", "bf16"])
    return ap


def system_config_from_args(args: argparse.Namespace,
                            **overrides) -> SystemConfig:
    kw = {name: getattr(args, name) for name in SYSTEM_ARG_NAMES}
    kw.update(overrides)
    return SystemConfig(**kw)
