"""Command-line flags for the system parameters, the trial executor and the
kernel find-db: the counterpart of ``add_system_args``/
``system_config_from_args``, ``add_executor_args``/``executor_from_args``
and ``add_kernel_db_arg``/``install_kernel_db_from_args`` in
``repro.launch.sysargs``, with the reference's defaults. The executor flags
resolve through ``repro_torch.api.registry``: ``--executor parallel`` (or
``--parallelism N > 1``) runs a wave's trials on N thread lanes,
``--executor cluster`` drops the job onto the discrete-event simulated
cluster, and ``--workers`` composes a pool of local members. The
reference's ``--backends``, ``--shard-capacity``, ``--coordinator`` and
``--wire`` (the sharded executor, remote workers and the wire protocol:
ROADMAP queue A, item 12) and ``--trace`` (item 13) are accepted and raise
a clear error when given. ``--kernel-db`` takes a golden table; a service
journal or a ``tcp://`` store raises naming item 12, which also brings the
store flags.
"""
from __future__ import annotations

import argparse

from repro_torch.models.transformer import SystemConfig

SYSTEM_ARG_NAMES = ("microbatches", "remat", "precision")


def add_kernel_db_arg(ap: argparse.ArgumentParser
                      ) -> argparse.ArgumentParser:
    """``--kernel-db``: prime the process-wide kernel find-db before the
    first step, so tuned configs from a previous ``python -m
    repro_torch.kernels.tune`` run take effect here."""
    ap.add_argument("--kernel-db", default=None, metavar="SPEC",
                    help="prime the kernel config find-db from a golden "
                         "table JSON (`repro_torch.kernels.tune export`); "
                         "a service journal or tcp://HOST:PORT needs the "
                         "service package: ROADMAP item 12")
    return ap


def install_kernel_db_from_args(args: argparse.Namespace) -> int:
    """Apply ``--kernel-db`` (no-op when unset). Returns rows installed."""
    spec = getattr(args, "kernel_db", None)
    if not spec:
        return 0
    from repro_torch.kernels.tune import install_kernel_db
    n = install_kernel_db(spec)
    print(f"kernel find-db: {n} tuned configs from {spec}")
    return n


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


_ITEM12 = "ROADMAP queue A, item 12 (Tuning service and wire protocol)"
_ITEM13 = "ROADMAP queue A, item 13 (Observability and chaos)"
# flags of the reference that the port parses but cannot honour yet: the
# flag, what it needs, and the ROADMAP item that brings it
_UNPORTED_FLAGS = (
    ("backends", "--backends", "the sharded executor", _ITEM12),
    ("shard_capacity", "--shard-capacity", "the sharded executor", _ITEM12),
    ("coordinator", "--coordinator", "the elastic worker roster", _ITEM12),
    ("wire", "--wire", "the wire protocol", _ITEM12),
    ("trace", "--trace", "the event sinks and distributed tracing",
     _ITEM13),
)


def add_executor_args(ap: argparse.ArgumentParser, executor: str = "serial",
                      parallelism: int = 1) -> argparse.ArgumentParser:
    """``--executor/--parallelism/--cluster-nodes/--straggler-prob/
    --workers``: how a scheduler wave's trials execute (serial, host
    thread lanes, simulated cluster nodes, or a pool of local workers)."""
    ap.add_argument("--executor", default=executor,
                    help="executor registry name (serial / parallel / "
                         "cluster / workers / plugin-registered)")
    ap.add_argument("--parallelism", type=int, default=parallelism,
                    help="trials per scheduler wave to run concurrently "
                         "(implies --executor parallel when > 1); on the "
                         "real backend the lanes share one GIL, so step "
                         "times, energy and PipeTune's config choices "
                         "include the wave-mates' hold-ups")
    ap.add_argument("--cluster-nodes", type=int, default=4,
                    help="simulated nodes for --executor cluster")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-epoch straggler probability for "
                         "--executor cluster")
    ap.add_argument("--workers", default=None,
                    help="comma-separated local trial workers for "
                         "--executor workers (implied when set): 'inproc' "
                         "or a backend registry name for an in-process "
                         "shard (e.g. 'sim,sim'); tcp:// members are "
                         "ROADMAP item 12")
    for _, flag, needs, item in _UNPORTED_FLAGS:
        ap.add_argument(flag, default=None,
                        help=f"not ported ({needs}: {item})")
    return ap


def executor_from_args(args: argparse.Namespace):
    """Build the executor the flags describe (resolved via the registry).

    Flag combinations that an executor would silently ignore are hard
    errors, as in the reference: ``--parallelism`` belongs to
    serial/parallel (use ``--cluster-nodes`` or more ``--workers`` for the
    others), ``--workers`` to workers (which it implies when the executor
    is left at the default). A flag of an unported executor raises naming
    its ROADMAP item.
    """
    from repro_torch.api import registry
    for dest, flag, needs, item in _UNPORTED_FLAGS:
        if getattr(args, dest, None) is not None:
            raise NotImplementedError(
                f"{flag} needs {needs}, which the port does not have yet: "
                f"{item}")
    name = args.executor
    workers = [w.strip() for w in args.workers.split(",") if w.strip()] \
        if getattr(args, "workers", None) else None
    if workers and name == "serial":
        name = "workers"                # the flag implies the pool executor
    if args.parallelism > 1 and name not in ("serial", "parallel"):
        raise ValueError(
            f"--parallelism {args.parallelism} conflicts with --executor "
            f"{name}: thread parallelism only applies to serial/parallel "
            "executors and would be silently ignored — use --cluster-nodes "
            "(cluster) or more --workers (workers) instead")
    if workers and name != "workers":
        raise ValueError(
            f"--workers conflicts with --executor {name}: worker lists "
            "only apply to the workers executor (or the default serial, "
            "which --workers upgrades); the flag would be silently ignored")
    if name == "parallel" or (name == "serial" and args.parallelism > 1):
        return registry.make_executor("parallel",
                                      parallelism=args.parallelism)
    if name == "cluster":
        return registry.make_executor(
            "cluster", n_nodes=args.cluster_nodes,
            straggler_prob=args.straggler_prob)
    if name == "workers":
        if not workers:
            raise ValueError("--executor workers needs --workers "
                             "inproc[,BACKEND...]")
        return registry.make_executor("workers", workers=workers)
    return registry.make_executor(name)
