"""File-backed metrics time-series store (the paper's InfluxDB stand-in):
the counterpart of ``repro.core.store``, with its on-disk format, so that a
store written by either package reads back in the other.

Append-only JSONL per measurement with tags + fields + timestamps, and a
query surface good enough for the benchmarks: filter by measurement, tags,
time range.

Writes buffer 64 records before touching disk; the tail of the buffer is
flushed by ``close()`` / the ``with MetricsStore(...) as ms:`` context
manager, and — as a safety net — by a finalizer when the store is
garbage-collected or the interpreter exits, so short-lived processes no
longer lose their last partial batch.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional


def _flush_buffers(root: str, buffers: Dict[str, list],
                   lock: threading.Lock) -> None:
    """Module-level so the weakref finalizer holds no reference to the
    store itself (which would keep it alive forever)."""
    with lock:
        for measurement in list(buffers):
            # drain before writing: each record leaves the buffer exactly
            # once, so overlapping flush triggers (close + GC + atexit, or
            # a write that raised mid-batch) can never duplicate rows
            buf, buffers[measurement] = buffers.get(measurement, []), []
            if not buf:
                continue
            path = os.path.join(root, f"{measurement}.jsonl")
            with open(path, "a") as f:
                for rec in buf:
                    f.write(json.dumps(rec) + "\n")


class MetricsStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._buffers: Dict[str, list] = {}
        # fires on GC of the store and at interpreter exit (atexit),
        # whichever comes first — the __del__/atexit flush in one hook
        self._finalizer = weakref.finalize(
            self, _flush_buffers, self.root, self._buffers, self._lock)

    def _path(self, measurement: str) -> str:
        return os.path.join(self.root, f"{measurement}.jsonl")

    def write(self, measurement: str, fields: Dict[str, Any],
              tags: Optional[Dict[str, str]] = None,
              ts: Optional[float] = None):
        rec = {"ts": time.time() if ts is None else ts,
               "tags": tags or {}, "fields": fields}
        with self._lock:
            self._buffers.setdefault(measurement, []).append(rec)
            if len(self._buffers[measurement]) >= 64:
                self._flush(measurement)

    def _flush(self, measurement: str):
        # drain-before-write (see _flush_buffers): never duplicate a row
        buf, self._buffers[measurement] = \
            self._buffers.get(measurement, []), []
        if not buf:
            return
        with open(self._path(measurement), "a") as f:
            for rec in buf:
                f.write(json.dumps(rec) + "\n")

    def flush(self):
        with self._lock:
            for m in list(self._buffers):
                self._flush(m)

    def close(self):
        """Flush and detach the exit-time finalizer."""
        self.flush()
        self._finalizer.detach()

    def __enter__(self) -> "MetricsStore":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def query(self, measurement: str, tags: Optional[Dict[str, str]] = None,
              t0: float = 0.0, t1: float = float("inf")) -> List[dict]:
        self.flush()
        path = self._path(measurement)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if not (t0 <= rec["ts"] <= t1):
                    continue
                if tags and any(rec["tags"].get(k) != v
                                for k, v in tags.items()):
                    continue
                out.append(rec)
        return out
