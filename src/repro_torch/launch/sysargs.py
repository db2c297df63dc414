"""Command-line flags for the system parameters and the trial executor:
the counterpart of ``add_system_args``/``system_config_from_args`` and
``add_executor_args``/``executor_from_args`` in ``repro.launch.sysargs``,
with the reference's defaults. Of the executor flags the port has
``--executor`` and ``--parallelism``; the serial executor is its only one,
and the others (with ``--cluster-nodes``, ``--backends``, ``--workers``,
...) wait for ROADMAP queue A, 2b (iii); ``--trace`` and ``--wire`` for
items 13 and 12.
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


def add_executor_args(ap: argparse.ArgumentParser, executor: str = "serial",
                      parallelism: int = 1) -> argparse.ArgumentParser:
    """``--executor/--parallelism``: how a scheduler wave's trials
    execute."""
    ap.add_argument("--executor", default=executor,
                    help="executor registry name (serial / "
                         "plugin-registered)")
    ap.add_argument("--parallelism", type=int, default=parallelism,
                    help="trials per scheduler wave to run concurrently "
                         "(only 1: the parallel executor is not ported)")
    return ap


def executor_from_args(args: argparse.Namespace):
    """Build the executor the flags describe, through the registry. An
    unported executor raises the registry's KeyError, which names its
    ROADMAP item; ``--parallelism > 1`` would need the parallel executor
    and raises likewise."""
    from repro_torch.api import registry
    if args.parallelism > 1:
        raise ValueError(
            f"--parallelism {args.parallelism} needs the parallel executor, "
            "which the port does not have yet: ROADMAP queue A, item 2b "
            "(iii)")
    return registry.make_executor(args.executor)
