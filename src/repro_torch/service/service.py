"""GroundTruthService: the shared tuning store behind a wire protocol, the
counterpart of ``repro.service.service``.

Wraps a ``repro_torch.core.GroundTruth`` behind a small request/response
protocol so tuning state can be shared by concurrent trials, sharded
backends, and whole separate processes (the paper's §5.4-5.5 sharing economy; in the
spirit of MLtuner's shared tuning state and the self-tuning parameter
server). Every request is a JSON-serializable dict ``{"op": ...}``; every
response carries ``ok`` plus op-specific fields and the current store
``version``:

    version   -> {ok, version}
    lookup    -> {ok, version, score, config}      (counts a server-side
                                                    hit/miss)
    add       -> {ok, version, n_entries}          (journaled, then refit)
    refit     -> {ok, version}
    snapshot  -> {ok, version, n_entries, hits, misses, model}
    batch     -> {ok, version, results: [...]}     (sub-requests in order;
                                                    one journal flush)
    kernel_db -> {ok, version, n_kernel_entries,   (batched find-db op:
                  configs: [...], entries?: [...]}  puts then queries then
                                                    optional export, one
                                                    journal flush)

``kernel_db`` is the kernel find-db protocol (MITuna-style): one request
carries any mix of ``puts`` (tuned configs keyed by ``(kernel, shape,
hardware)``, journaled write-ahead like ``add``), ``queries`` (answered
in order with the best-known config or None), and ``export`` (dump every
row for a golden table). Batching puts+queries into one op keeps a
tuning sweep's store traffic to one round-trip and its journal cost to
one write + flush.

``batch`` runs a list of sub-requests (any op but ``batch``) atomically
under the service lock and answers each with its own ``{ok, version,
...}`` result; a failed sub-request is reported in place and does not
abort the rest. Journal writes from the batch's ``add``s are pipelined:
buffered in order and written + flushed **once** before the batch
returns, so a wave of adds pays one fsync-able flush instead of one per
entry — and nothing is acknowledged before its journal line is durable,
preserving the write-ahead recovery story.

``model`` is the ``CentroidModel`` payload — the pure lookup state —
which is what lets clients cache it and serve hot-path lookups locally,
re-fetching only when ``version`` bumps (every refit is monotonically
versioned).

Persistence is a JSONL *journal*: each accepted ``add`` is appended (and
flushed) before it mutates the store, so a crashed service recovers by
replay. A partially-written final line — the signature of a crash mid
append — is tolerated and dropped; any other malformed line raises
``GroundTruthError`` (truncating someone's store silently would re-probe
every recurring job).

Replies, versions and journal lines are the reference's byte for byte, so
either package replays the other's journal. ``obs_trace`` (the
distributed-tracing hello) needs ``obs.forward``, which the port does not
have yet (ROADMAP queue A, item 13): it answers ``ok: False`` naming the
item, which the reference's ``propagate_trace`` reads as a legacy peer, so
a traced reference driver still runs against this service, untraced.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.groundtruth import (GroundTruth, GroundTruthError,
                                          KernelConfigDB)
from repro_torch.obs.events import StoreRefit, get_bus

__all__ = ["GroundTruthService"]

_OPS = ("version", "lookup", "add", "refit", "snapshot", "batch",
        "obs_trace", "kernel_db")


class GroundTruthService:
    """Request/response façade over one ``GroundTruth`` + its journal.

    ``handle`` is the whole protocol: transports (in-proc, TCP) differ only
    in how a request dict reaches it. All ops run under one lock; the store
    itself is never touched concurrently.
    """

    def __init__(self, store: Optional[GroundTruth] = None,
                 path: Optional[str] = None, reset: bool = False, **gt_kw):
        self.store = store if store is not None else GroundTruth(**gt_kw)
        self.kernel_db = KernelConfigDB()
        self.path = path
        self.bus = get_bus()
        self._lock = threading.RLock()
        self._journal = None
        self._journal_buffer = None     # non-None inside a batch: lines
                                        # pipelined into one write + flush
        if path:
            if reset and os.path.exists(path):
                os.remove(path)
            if os.path.exists(path):
                self._replay(path)
            self._journal = open(path, "a")

    # ------------------------------------------------------------- protocol
    def handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        try:
            op = request.get("op")
            if op not in _OPS:
                raise ValueError(f"unknown op {op!r}; supported: {_OPS}")
            with self._lock:
                out = getattr(self, "_op_" + op)(request)
                out["ok"] = True
                out["version"] = self.store.version
                return out
        except Exception as e:                  # noqa: BLE001 — wire boundary
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _op_version(self, req) -> dict:
        return {}

    def _op_obs_trace(self, req) -> dict:
        raise NotImplementedError(
            "distributed tracing is not ported yet: ROADMAP queue A, item "
            "13 (Observability and chaos)")

    def _op_lookup(self, req) -> dict:
        score, cfg = self.store.lookup(
            np.asarray(req["profile"], np.float64))
        return {"score": score, "config": cfg}

    def _op_add(self, req) -> dict:
        profile = np.asarray(req["profile"], np.float64)
        rec = {"op": "add", "profile": profile.tolist(),
               "workload": str(req["workload"]),
               "sys_config": dict(req["sys_config"]),
               "objective": float(req["objective"])}
        if self._journal is not None:           # write-ahead, then apply
            line = json.dumps(rec) + "\n"
            if self._journal_buffer is not None:  # inside a batch: pipeline
                self._journal_buffer.append(line)
            else:
                self._journal.write(line)
                self._journal.flush()
        self.store.add(profile, rec["workload"], rec["sys_config"],
                       rec["objective"], refit=bool(req.get("refit", True)))
        if req.get("refit", True) and self.bus.enabled:
            self.bus.emit(StoreRefit(version=self.store.version,
                                     n_entries=len(self.store.entries)))
        return {"n_entries": len(self.store.entries)}

    def _op_refit(self, req) -> dict:
        self.store.refit()
        if self.bus.enabled:
            self.bus.emit(StoreRefit(version=self.store.version,
                                     n_entries=len(self.store.entries)))
        return {}

    def _op_snapshot(self, req) -> dict:
        model = self.store.centroid_model()
        return {"n_entries": len(self.store.entries),
                "hits": self.store.hits, "misses": self.store.misses,
                "model": None if model is None else model.to_payload()}

    def _op_kernel_db(self, req) -> dict:
        """Kernel find-db: apply ``puts``, answer ``queries``, optionally
        ``export`` every row — one op, one journal write + flush.

        All puts are validated and journaled (write-ahead, like ``add``)
        before any is applied, so a request that dies on a malformed put
        mutates nothing and journals nothing.
        """
        recs = []
        for p in (req.get("puts") or []):
            recs.append({"op": "kernel_put",
                         "kernel": str(p["kernel"]),
                         "shape": str(p["shape"]),
                         "hardware": str(p.get("hardware", "any")),
                         "config": dict(p["config"]),
                         "objective": None if p.get("objective") is None
                         else float(p["objective"])})
        if recs and self._journal is not None:
            lines = [json.dumps(r) + "\n" for r in recs]
            if self._journal_buffer is not None:  # inside a batch: pipeline
                self._journal_buffer.extend(lines)
            else:
                self._journal.write("".join(lines))
                self._journal.flush()
        for r in recs:
            self.kernel_db.put(r["kernel"], r["shape"], r["config"],
                               hardware=r["hardware"],
                               objective=r["objective"])
        configs = [self.kernel_db.get(str(q["kernel"]), str(q["shape"]),
                                      str(q.get("hardware", "any")))
                   for q in (req.get("queries") or [])]
        out = {"n_kernel_entries": len(self.kernel_db), "configs": configs}
        if req.get("export"):
            out["entries"] = self.kernel_db.rows()
        return out

    def _op_batch(self, req) -> dict:
        """Run sub-requests in order with one journal flush at the end.

        Nothing is acknowledged until the whole batch (and its single
        journal flush) completes, so buffering the write-ahead lines is
        exactly as safe as flushing each: a crash mid-batch loses only
        un-acked work and the journal never records it.
        """
        if self._journal_buffer is not None:
            raise ValueError("nested batch requests are not supported")
        subs = req.get("requests")
        if not isinstance(subs, list):
            raise ValueError("batch needs a 'requests' list")
        results = []
        self._journal_buffer = []
        try:
            for sub in subs:
                op = sub.get("op") if isinstance(sub, dict) else None
                try:
                    if op not in _OPS or op == "batch":
                        raise ValueError(
                            f"unknown batch sub-op {op!r}; supported: "
                            f"{tuple(o for o in _OPS if o != 'batch')}")
                    out = getattr(self, "_op_" + op)(sub)
                    out["ok"] = True
                    out["version"] = self.store.version
                    results.append(out)
                except Exception as e:  # noqa: BLE001 — wire boundary
                    results.append(
                        {"ok": False, "error": f"{type(e).__name__}: {e}"})
        finally:
            lines, self._journal_buffer = self._journal_buffer, None
            if lines and self._journal is not None:
                self._journal.write("".join(lines))
                self._journal.flush()
        return {"results": results}

    # -------------------------------------------------------------- journal
    def _replay(self, path: str):
        with open(path) as f:
            raw = f.read()
        tail_open = not raw.endswith("\n")      # crash mid-append
        records = [line for line in raw.split("\n") if line.strip()]
        applied = []
        applied_adds = False

        def corrupt(i, why, hint=""):
            return GroundTruthError(
                f"corrupt ground-truth journal at {path!r} (record "
                f"{i + 1}: {why}){hint}; fix or delete the file, or "
                "relaunch with --store-reset to start from an empty store")

        for i, line in enumerate(records):
            try:
                rec = json.loads(line)
            except ValueError as e:
                # a record that is not even JSON is either a torn final
                # append (tolerated, dropped) or real corruption; a record
                # that *parses* but has the wrong shape is never torn and
                # always a hard error — e.g. a GroundTruth.save() store
                # pointed at the journal flag must not be "recovered" into
                # an empty store
                if i == len(records) - 1 and tail_open:
                    break
                raise corrupt(i, e) from None
            try:
                op = rec.get("op") if isinstance(rec, dict) else None
                if op == "kernel_put":
                    # replay runs in __init__ (uncontended), but the find-db
                    # is written under the lock everywhere else — keep the
                    # discipline uniform
                    with self._lock:
                        self.kernel_db.put(
                            rec["kernel"], rec["shape"], dict(rec["config"]),
                            hardware=str(rec.get("hardware", "any")),
                            objective=None if rec.get("objective") is None
                            else float(rec["objective"]))
                    applied.append(line)
                    continue
                if not isinstance(rec, dict) or op != "add":
                    looks_like_save = isinstance(rec, list) or (
                        isinstance(rec, dict) and "entries" in rec)
                    raise corrupt(
                        i, f"unexpected record of type "
                        f"{type(rec).__name__}",
                        " — this looks like a GroundTruth.save() store "
                        "file, not a service journal; load it into a "
                        "GroundTruth and re-add through the service"
                        if looks_like_save else "")
                self.store.add(np.asarray(rec["profile"], np.float64),
                               rec["workload"], dict(rec["sys_config"]),
                               float(rec["objective"]), refit=False)
                applied.append(line)
                applied_adds = True
            except GroundTruthError:
                raise
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                raise corrupt(i, e) from None
        if tail_open:
            # repair before we append again: without the trailing newline
            # the next record would concatenate onto the torn/unterminated
            # line and corrupt the journal for the *next* recovery
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write("".join(line + "\n" for line in applied))
            os.replace(tmp, path)
        if applied_adds:
            self.store.refit()

    def close(self):
        with self._lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None
