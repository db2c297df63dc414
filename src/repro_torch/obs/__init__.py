"""Observability of the port: the typed telemetry events and the
process-local ``EventBus`` (``events``), which the worker pool and the
cluster engine emit. The reference's sinks, metrics endpoint, trace,
forwarding and chaos modules are ROADMAP queue A, item 13.
"""
from repro_torch.obs.events import (  # noqa: F401
    DEFAULT_BUS, EVENT_TYPES, ClockSync, EpochCompleted, Event, EventBus,
    ForwardDropped, HeartbeatMissed, Resharded, RpcCompleted, StoreRefit,
    TrialCompleted, TrialDispatched, TrialStarted, WorkerJoined,
    WorkerRetired, event_from_dict, get_bus, new_trace_id, set_bus,
    worker_label)
