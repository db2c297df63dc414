"""Command-line flags for the system parameters, the trial executor and the
kernel find-db: the counterpart of ``add_system_args``/
``system_config_from_args``, ``add_executor_args``/``executor_from_args``
and ``add_kernel_db_arg``/``install_kernel_db_from_args`` in
``repro.launch.sysargs``, with the reference's defaults. The executor flags
resolve through ``repro_torch.api.registry``: ``--executor parallel`` (or
``--parallelism N > 1``) runs a wave's trials on N thread lanes,
``--executor cluster`` drops the job onto the discrete-event simulated
cluster, ``--executor sharded --backends sim,sim`` fans its waves across
backend shards, ``--workers`` composes a pool of local and remote members
(``tcp://`` workers of ``python -m repro_torch.worker``) and
``--coordinator`` follows the live roster of a ``python -m
repro_torch.coordinator``. ``--wire`` picks the payload codec of every TCP
connection the process dials. ``add_store_args``/``store_client_from_args``
(``--store``/``--gt-store``/``--store-reset``) place the ground-truth
store in process or behind a ``python -m repro_torch.service``.
``--kernel-db`` takes a golden table, a service journal or a live store.
``--trace PATH`` sinks the run's events to a JSONL file and, on an executor
that dials peers, collects their events into it (``repro_torch.obs``).
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
                    help="prime the kernel config find-db from SPEC: a "
                         "golden table JSON (`repro_torch.kernels.tune "
                         "export`), a service journal (JSONL), or "
                         "tcp://HOST:PORT of a running `python -m "
                         "repro_torch.service`")
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


# flags of the reference that the port parses but cannot honour yet: the
# flag, what it needs, and the ROADMAP item that brings it (none today)
_UNPORTED_FLAGS: tuple = ()


def add_executor_args(ap: argparse.ArgumentParser, executor: str = "serial",
                      parallelism: int = 1) -> argparse.ArgumentParser:
    """``--executor/--parallelism/--cluster-nodes/--straggler-prob/
    --backends/--shard-capacity/--workers/--coordinator/--wire``: how a
    scheduler wave's trials execute (serial, host thread lanes, simulated
    cluster nodes, backend shards, or a pool of local and remote
    workers)."""
    ap.add_argument("--executor", default=executor,
                    help="executor registry name (serial / parallel / "
                         "cluster / sharded / workers / plugin-registered)")
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
                         "--executor cluster / sharded")
    ap.add_argument("--backends", default=None,
                    help="comma-separated backend registry names for "
                         "--executor sharded (e.g. 'sim,sim'); each becomes "
                         "one shard of the wave fan-out")
    ap.add_argument("--shard-capacity", type=int, default=1,
                    help="simulated nodes per backend shard for "
                         "--executor sharded")
    ap.add_argument("--workers", default=None,
                    help="comma-separated trial workers for --executor "
                         "workers (implied when set): tcp://HOST:PORT of a "
                         "running `python -m repro_torch.worker`, or a "
                         "backend registry name for a local in-process shard "
                         "(e.g. 'tcp://10.0.0.1:7078,sim')")
    ap.add_argument("--coordinator", default=None,
                    help="tcp://HOST:PORT of a running `python -m "
                         "repro_torch.coordinator` (implies --executor "
                         "workers): the pool follows the live roster of "
                         "announced workers — joins are picked up between "
                         "waves, leaves/missed heartbeats retire the worker "
                         "and re-place its trials; combine with --workers "
                         "for static members")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append the run's structured events (dispatches, "
                         "epoch completions, worker joins/retires, reshards) "
                         "to PATH as JSONL; requires an executor that can "
                         "attach an event bus (serial / parallel / cluster / "
                         "sharded / workers / --coordinator)")
    for _, flag, needs, item in _UNPORTED_FLAGS:
        ap.add_argument(flag, default=None,
                        help=f"not ported ({needs}: {item})")
    _add_wire_arg(ap)
    return ap


def _add_wire_arg(ap: argparse.ArgumentParser) -> None:
    """``--wire``: payload codec for every TCP connection this process
    dials (workers, coordinator, store). Shared between the executor and
    store flag groups, so adding is idempotent."""
    if any(action.dest == "wire" for action in ap._actions):
        return
    ap.add_argument("--wire", default="auto",
                    choices=["auto", "json", "binary", "msgpack", "tlv"],
                    help="wire codec for TCP connections: 'auto' (default) "
                         "negotiates the best binary codec and falls back "
                         "to JSON on old peers; 'json' forces the readable "
                         "legacy encoding (debugging with tcpdump/netcat); "
                         "'binary'/'msgpack'/'tlv' demand that codec and "
                         "fail if the peer can't speak it")


def executor_from_args(args: argparse.Namespace):
    """Build the executor the flags describe (resolved via the registry).

    Flag combinations that an executor would silently ignore are hard
    errors, as in the reference: ``--parallelism`` belongs to
    serial/parallel (use ``--cluster-nodes`` / ``--shard-capacity`` / more
    ``--workers`` for the others), ``--backends`` to sharded, ``--workers``
    to workers (which it implies when the executor is left at the default).
    ``--trace`` on an executor that cannot attach an event bus is one too.
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
    coordinator = getattr(args, "coordinator", None)
    if (workers or coordinator) and name == "serial":
        name = "workers"                # both flags imply the pool executor
    if args.parallelism > 1 and name not in ("serial", "parallel"):
        raise ValueError(
            f"--parallelism {args.parallelism} conflicts with --executor "
            f"{name}: thread parallelism only applies to serial/parallel "
            "executors and would be silently ignored — use --cluster-nodes "
            "(cluster), --shard-capacity (sharded), or more --workers "
            "(workers) instead")
    if getattr(args, "backends", None) and name != "sharded":
        raise ValueError(
            f"--backends {args.backends!r} conflicts with --executor "
            f"{name}: only the sharded executor fans waves across backend "
            "shards; the flag would be silently ignored")
    if workers and name != "workers":
        raise ValueError(
            f"--workers conflicts with --executor {name}: worker lists "
            "only apply to the workers executor (or the default serial, "
            "which --workers upgrades); the flag would be silently ignored")
    if coordinator and name != "workers":
        raise ValueError(
            f"--coordinator conflicts with --executor {name}: the live "
            "worker roster only feeds the workers executor (or the default "
            "serial, which --coordinator upgrades); the flag would be "
            "silently ignored")
    if name == "parallel" or (name == "serial" and args.parallelism > 1):
        ex = registry.make_executor("parallel",
                                    parallelism=args.parallelism)
    elif name == "cluster":
        ex = registry.make_executor(
            "cluster", n_nodes=args.cluster_nodes,
            straggler_prob=args.straggler_prob)
    elif name == "sharded":
        backends = args.backends.split(",") if args.backends else None
        ex = registry.make_executor(
            "sharded", backends=backends, capacity=args.shard_capacity,
            straggler_prob=args.straggler_prob)
    elif name == "workers":
        if not workers and not coordinator:
            raise ValueError("--executor workers needs --workers "
                             "tcp://HOST:PORT[,...] (or local shard names) "
                             "and/or --coordinator tcp://HOST:PORT")
        # the runner spec (tuner/backend/store recipe for the remote ends)
        # is filled in by Experiment.run via configure_runner_spec
        ex = registry.make_executor("workers", workers=workers,
                                    coordinator=coordinator,
                                    wire=getattr(args, "wire", "auto"))
    else:
        ex = registry.make_executor(name)
    return _maybe_attach_trace(ex, args, name)


def _maybe_attach_trace(ex, args: argparse.Namespace, name: str):
    """``--trace PATH``: sink the run's event stream to a JSONL file. An
    executor with no ``attach_bus`` would produce a silently empty trace —
    that combination is a hard error, like the other ignored-flag cases.
    The port's serial and parallel executors attach a bus (their pool's
    dispatches and completions), where the reference's refuse the flag."""
    trace = getattr(args, "trace", None)
    if not trace:
        return ex
    if getattr(ex, "attach_bus", None) is None:
        raise ValueError(
            f"--trace conflicts with --executor {name}: "
            f"{type(ex).__name__} cannot attach an event bus, so the trace "
            "would stay silently empty — use an executor that emits events "
            "(serial / parallel / cluster / sharded / workers / "
            "--coordinator)")
    from repro_torch.obs.events import EventBus
    from repro_torch.obs.sinks import attach_trace
    bus = EventBus()
    attach_trace(bus, trace)
    ex.attach_bus(bus)
    if getattr(ex, "enable_trace", None) is not None:
        # cross-process collection rides along automatically: start a
        # collector on an ephemeral port and handshake every peer the
        # executor dials (--workers / --coordinator); purely local
        # executors skip this (no enable_trace) and trace as before
        from repro_torch.obs.forward import start_collector
        collector = start_collector(bus)
        ex.enable_trace(collector=collector.address)
        ex._trace_collector = collector     # closed with the executor
    return ex


def _add_wire_arg(ap: argparse.ArgumentParser) -> None:
    """``--wire``: payload codec for every TCP connection this process
    dials (workers, coordinator, store). Shared between the executor and
    store flag groups, so adding is idempotent."""
    if any(action.dest == "wire" for action in ap._actions):
        return
    ap.add_argument("--wire", default="auto",
                    choices=["auto", "json", "binary", "msgpack", "tlv"],
                    help="wire codec for TCP connections: 'auto' (default) "
                         "negotiates the best binary codec and falls back "
                         "to JSON on old peers; 'json' forces the readable "
                         "legacy encoding (debugging with tcpdump/netcat); "
                         "'binary'/'msgpack'/'tlv' demand that codec and "
                         "fail if the peer can't speak it")


def add_store_args(ap: argparse.ArgumentParser,
                   store: str = "inproc") -> argparse.ArgumentParser:
    """``--store/--gt-store/--store-reset``: where the ground-truth store
    lives — in this process, or a shared ``python -m
    repro_torch.service``."""
    ap.add_argument("--store", default=store,
                    help="'inproc' (own store, optionally journaled via "
                         "--gt-store) or tcp://HOST:PORT of a running "
                         "`python -m repro_torch.service`")
    ap.add_argument("--gt-store", default=None,
                    help="JSONL journal path for the in-proc store; persists "
                         "profile->config optima across runs")
    ap.add_argument("--store-reset", action="store_true",
                    help="escape hatch for a corrupt/unwanted journal: "
                         "delete it and start from an empty store")
    _add_wire_arg(ap)
    return ap


def store_client_from_args(args: argparse.Namespace):
    """Build the ground-truth ``StoreClient`` the flags describe."""
    from repro_torch.service import (GroundTruthService, InprocTransport,
                                     SocketTransport, StoreClient)
    spec = args.store
    if spec.startswith("tcp://"):
        if getattr(args, "store_reset", False):
            raise ValueError(
                "--store-reset only applies to the in-proc store; to reset "
                "a remote one, restart it with `python -m "
                "repro_torch.service --reset`")
        from repro_torch.service.dispatch import parse_tcp_address
        host, port = parse_tcp_address(spec)
        return StoreClient(SocketTransport(
            host, port, wire=getattr(args, "wire", "auto")))
    if spec != "inproc":
        raise ValueError(f"--store {spec!r}: expected 'inproc' or "
                         "tcp://HOST:PORT")
    service = GroundTruthService(path=args.gt_store,
                                 reset=args.store_reset)
    return StoreClient(InprocTransport(service))
