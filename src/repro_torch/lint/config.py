"""Repo-aware knowledge that parameterises the lint passes.

The passes themselves are generic AST analyses; everything they need to
know about *this* codebase — which modules promise determinism, which
client class talks to which server class, which attribute holds what type
for lock-order edges — lives in one :class:`LintConfig` value so tests can
swap in fixture-sized configs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Tuple

__all__ = ["LintConfig", "default_config"]


@dataclasses.dataclass(frozen=True)
class LintConfig:
    # --- determinism pass -------------------------------------------------
    # Modules that promise bit-identical replay (parallel == serial ==
    # sharded == remote).  Files can also opt in with a header comment
    # ``# repro-lint: deterministic``.
    deterministic_modules: Tuple[str, ...] = (
        "cluster/engine.py",
        "cluster/executor.py",
        "cluster/perfmodel.py",
        "cluster/sim.py",
        "cluster/worker.py",
        "core/groundtruth.py",
        "core/pipetune.py",
        "core/schedulers.py",
        "core/seeding.py",
        "core/worker.py",
        "distributed/sharding.py",
        "service/sharded.py",
    )
    # time.* attributes that do not observe the wall clock.
    allowed_clocks: FrozenSet[str] = frozenset(
        {"monotonic", "monotonic_ns", "perf_counter", "perf_counter_ns", "sleep"}
    )
    # Seeded entropy helpers (calls to these are always fine).
    seed_helpers: FrozenSet[str] = frozenset({"stable_hash", "seed_for", "derive_seed"})

    # --- wire-protocol pass -----------------------------------------------
    # client class -> server classes whose handle() must accept every op the
    # client sends (and, in reverse, should not serve ops nobody sends).
    clients: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {
            "StoreClient": ("GroundTruthService",),
            "SocketTransport": ("JsonRPCServer",),
            "RemoteWorker": ("TrialWorkerService",),
            "CoordinatorClient": ("CoordinatorService",),
            "WorkerAnnouncer": ("CoordinatorService",),
            "ObsClient": ("ObsService",),
            "ForwardingSink": ("TraceCollector",),
        }
    )
    # module-level functions that fan one op out to several server kinds.
    broadcast_senders: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {
            "propagate_trace": (
                "GroundTruthService",
                "CoordinatorService",
                "TrialWorkerService",
            ),
        }
    )
    # Servers that dispatch by comparing the op against string literals in
    # their handler instead of (or in addition to) ``_op_*`` methods.
    literal_dispatch_servers: Tuple[str, ...] = ("JsonRPCServer", "TraceCollector")
    # server class -> module-level ops-gate tuple that must mirror its
    # ``_op_*`` methods.
    ops_tables: Dict[str, str] = dataclasses.field(
        default_factory=lambda: {"GroundTruthService": "_OPS"}
    )

    # --- lock-discipline pass ---------------------------------------------
    # Attribute names that hold the class's mutual-exclusion lock; classes
    # assigning any of these in __init__ are analysed.
    lock_attrs: Tuple[str, ...] = ("_lock",)
    # Methods exempt from the guarded-write rule (object not yet / no longer
    # shared).
    lock_exempt_methods: FrozenSet[str] = frozenset(
        {"__init__", "__del__", "__repr__"}
    )
    # (class, attribute) -> classes the attribute may hold, for lock-order
    # edges: a call through the attribute while holding our lock acquires
    # the target's lock.
    attr_types: Dict[Tuple[str, str], Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {
            ("EventBus", "_sinks"): ("ForwardingSink",),
            ("EventBus", "_forward_sink"): ("ForwardingSink",),
            ("GroundTruthService", "bus"): ("EventBus",),
            ("CoordinatorService", "bus"): ("EventBus",),
            ("TrialWorkerService", "bus"): ("EventBus",),
            ("ForwardingSink", "_transport"): ("SocketTransport",),
            ("StoreClient", "transport"): ("SocketTransport",),
        }
    )

    # --- event-schema pass ------------------------------------------------
    event_module: str = "obs/events.py"
    event_base: str = "Event"
    event_registry: str = "EVENT_TYPES"
    # Paths where string literals compared against an event ``kind`` must
    # name a registered kind (typo guard for sink/trace dispatch).
    kind_check_paths: Tuple[str, ...] = ("obs/",)
    # symbol -> exempt kinds: dispatchers listed here must reference every
    # registered kind except the exemptions (EVT005).
    kind_dispatchers: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict
    )

    # --- serve-loop exception-safety pass ----------------------------------
    # class -> methods that run on I/O / handler-pool threads, where an
    # escaping exception kills the loop instead of one request.
    serve_scopes: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {
            "JsonRPCServer": (
                "serve_forever",
                "_accept",
                "_drain_wake",
                "_apply_dirty",
                "_close_conn",
                "_on_readable",
                "_on_request",
                "_on_writable",
                "_queue_frame",
                "_run_handler",
            ),
            "ForwardingSink": ("_run", "_flush_once", "_send"),
            "RemoteWorker": ("_loop", "_run_one", "_run_batch"),
            "WorkerAnnouncer": ("_loop",),
            "TraceCollector": ("handle",),
        }
    )
    # Paths where EXC002 (broad except swallowing transport/codec errors)
    # applies.
    serve_paths: Tuple[str, ...] = ("service/", "obs/")


def default_config() -> LintConfig:
    return LintConfig()
