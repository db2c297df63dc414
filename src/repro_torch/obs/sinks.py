"""Event sinks: where a bus's records land; the counterpart of
``repro.obs.sinks``, writing and reading the same JSONL.

* ``JsonlSink`` — one JSON object per line, line-buffered so records hit
  the file as they happen (``--trace PATH`` on any run; the chaos CI job
  uploads the file as an artifact). ``read_trace`` is the inverse.
* ``MetricsStoreSink`` — bridges events into a ``repro_torch.core.store
  .MetricsStore`` measurement (tags: kind/worker/trial, fields: the rest),
  so event streams are queryable next to any other time series.
* ``MemorySink`` — an in-process list (tests, SLO evaluation).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.obs.events import Event, EventBus, event_from_dict

__all__ = ["JsonlSink", "MetricsStoreSink", "MemorySink", "read_trace",
           "attach_trace"]


class JsonlSink:
    """Append events to ``path`` as JSONL, one record per line.

    The file is opened line-buffered and every write is flushed, so a
    crashing (or SIGKILLed) process loses at most the record being written
    — a chaos trace must survive the faults it documents.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def __call__(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class MetricsStoreSink:
    """Write each event into a ``MetricsStore`` measurement (default
    ``"events"``): string-ish identity fields become tags, the rest ride as
    fields — so ``store.query("events", tags={"kind": "worker_retired"})``
    works like any other series."""

    TAG_KEYS = ("kind", "worker", "trial_id")

    def __init__(self, store, measurement: str = "events"):
        self.store = store
        self.measurement = measurement

    def __call__(self, rec: Dict[str, Any]) -> None:
        tags = {k: str(rec[k]) for k in self.TAG_KEYS if rec.get(k)}
        fields = {k: v for k, v in rec.items()
                  if k not in tags and k not in ("ts",)}
        self.store.write(self.measurement, fields, tags=tags, ts=rec["ts"])


class MemorySink:
    """Collect raw records in a list; ``typed()`` decodes them."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def __call__(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)

    def typed(self) -> List[Event]:
        return [event_from_dict(r)[2] for r in self.records]

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]


def read_trace(path: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Load a JSONL trace back into record dicts (optionally one kind).
    A torn final record — the signature of a SIGKILL mid-append — is
    dropped whether or not the tear includes the trailing newline (the
    store journal has the same tolerance); any earlier malformed line
    still raises."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().split("\n")
    last_content = max((i for i, ln in enumerate(lines) if ln.strip()),
                       default=-1)
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == last_content:
                break
            raise
        if kind is None or rec.get("kind") == kind:
            out.append(rec)
    return out


def attach_trace(bus: EventBus, path: str) -> JsonlSink:
    """Enable `bus` and sink it to a JSONL trace at `path`."""
    sink = JsonlSink(path)
    bus.add_sink(sink)
    return sink
