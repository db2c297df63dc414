"""Observability + chaos subsystem of the port, the counterpart of
``repro.obs``: the typed telemetry events and the process-local
``EventBus`` (``events``), sinks (JSONL trace, ``MetricsStore`` bridge), a
scrapeable metrics/tail endpoint over the service's RPC framing
(``metrics``), distributed tracing (``forward``: cross-process trace
propagation and event forwarding; ``trace``: merged timelines, wall-time
breakdown, critical path) and a fault-injecting chaos orchestrator that
asserts recovery SLOs (``chaos`` + ``scenarios``). ``python -m
repro_torch.obs`` is the CLI (tail a live run, scrape metrics, analyze a
trace, run a chaos scenario).

This ``__init__`` resolves lazily (PEP 562), as the reference's does:
``repro_torch.core.worker`` and ``repro_torch.cluster.engine`` import
``repro_torch.obs.events`` (stdlib-only), while the sinks and metrics
modules reach ``repro_torch.core`` and ``repro_torch.service``, which
import torch. So ``import repro_torch.obs`` loads no torch, and eager
imports here would cycle through ``repro_torch.core``.
"""
from repro_torch.obs.events import (  # noqa: F401 — the always-safe base
    DEFAULT_BUS, EVENT_TYPES, ClockSync, EpochCompleted, Event, EventBus,
    ForwardDropped, HeartbeatMissed, Resharded, RpcCompleted, StoreRefit,
    TrialCompleted, TrialDispatched, TrialStarted, WorkerJoined,
    WorkerRetired, event_from_dict, get_bus, new_trace_id, set_bus,
    worker_label)

_LAZY = {
    "JsonlSink": "repro_torch.obs.sinks",
    "MetricsStoreSink": "repro_torch.obs.sinks",
    "MemorySink": "repro_torch.obs.sinks",
    "read_trace": "repro_torch.obs.sinks",
    "attach_trace": "repro_torch.obs.sinks",
    "render_metrics": "repro_torch.obs.metrics",
    "ObsService": "repro_torch.obs.metrics",
    "ObsServer": "repro_torch.obs.metrics",
    "ObsClient": "repro_torch.obs.metrics",
    "ObsUnreachable": "repro_torch.obs.metrics",
    "serve_obs": "repro_torch.obs.metrics",
    "ForwardingSink": "repro_torch.obs.forward",
    "TraceCollector": "repro_torch.obs.forward",
    "start_collector": "repro_torch.obs.forward",
    "adopt_trace": "repro_torch.obs.forward",
    "propagate_trace": "repro_torch.obs.forward",
    "Segment": "repro_torch.obs.trace",
    "TrialSpan": "repro_torch.obs.trace",
    "load_events": "repro_torch.obs.trace",
    "merge_events": "repro_torch.obs.trace",
    "build_trace": "repro_torch.obs.trace",
    "analyze_trace": "repro_torch.obs.trace",
    "render_report": "repro_torch.obs.trace",
    "ChaosProxy": "repro_torch.obs.chaos",
    "ChaosScenario": "repro_torch.obs.chaos",
    "ChaosReport": "repro_torch.obs.chaos",
    "SLOBudget": "repro_torch.obs.chaos",
    "SLOResult": "repro_torch.obs.chaos",
    "KillWorkers": "repro_torch.obs.chaos",
    "PartitionCoordinator": "repro_torch.obs.chaos",
    "PartitionStore": "repro_torch.obs.chaos",
    "SlowWorker": "repro_torch.obs.chaos",
    "run_scenario": "repro_torch.obs.chaos",
    "SCENARIOS": "repro_torch.obs.scenarios",
}

__all__ = ["Event", "EventBus", "TrialDispatched", "TrialStarted",
           "TrialCompleted", "EpochCompleted", "WorkerJoined",
           "WorkerRetired", "HeartbeatMissed", "Resharded", "StoreRefit",
           "RpcCompleted", "ClockSync", "ForwardDropped", "EVENT_TYPES",
           "DEFAULT_BUS", "get_bus", "set_bus", "event_from_dict",
           "new_trace_id", "worker_label"] + sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
