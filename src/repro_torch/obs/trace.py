"""Trace analysis: merged timelines, span trees, critical path; the
counterpart of ``repro.obs.trace``, giving its report on the same records.

The input is the record stream a traced run leaves behind (``--trace``
JSONL files; a distributed run's remote events arrive pre-merged through
the ``TraceCollector``). The analysis answers PipeTune's core question —
*where does tuning time go?* — in four steps:

1. **Merge + skew correction.** Records from every process are put on one
   wall clock: each traced peer's ``clock_sync`` sample (NTP-style
   midpoint estimate from the ``obs_trace`` hello) gives its offset, which
   is subtracted from that peer's timestamps; the sample with the smallest
   round-trip wins. Then one total order by corrected time (``seq`` breaks
   ties).

2. **Span reconstruction.** Per trial, dispatches pair with completions in
   order into *segments* — one segment per rung resume — each holding the
   queued → dispatched → started → per-epoch → completed ladder. The
   worker-side ``trial_started`` / ``epoch_completed`` events slot into
   the open segment of their trial, so driver and worker views of one
   execution land in one span. Events for a trial nobody dispatched are
   *orphans* — a merged trace from a healthy run has none.

3. **Wall-time breakdown.** Epoch compute (measured wall between
   ``trial_started`` and the last epoch where the worker reported it,
   summed durations otherwise), queue wait (dispatch → start), RPC+codec
   overhead (the ``rpc_completed`` receipts' ``overhead_s``), store waits,
   and per-worker idle — the capacity the run left on the table.

4. **Critical path + stragglers.** Walking back from the last completion,
   each segment is gated by the latest completion at or before its
   dispatch (wave-barrier causality); the resulting chain is the run's
   lower bound, and the share of it each worker holds is the straggler
   attribution (PipeDream's stage-level blame, applied to tuning).

``python -m repro_torch.obs analyze TRACE...`` renders the report as a human
table or JSON.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.sinks import read_trace

__all__ = ["Segment", "TrialSpan", "load_events", "merge_events",
           "build_trace", "analyze_trace", "render_report"]

_TRIAL_KINDS = ("trial_dispatched", "trial_started", "epoch_completed",
                "trial_completed")


@dataclasses.dataclass
class Segment:
    """One dispatch → completion execution of a trial (rung resumes make
    several per trial). Timestamps are skew-corrected wall seconds."""

    trial_id: str
    worker: str = ""
    dispatched_ts: Optional[float] = None
    started_ts: Optional[float] = None
    completed_ts: Optional[float] = None
    epochs: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    score: Optional[float] = None
    error: Optional[str] = None

    @property
    def orphan(self) -> bool:
        return self.dispatched_ts is None

    @property
    def queue_wait_s(self) -> float:
        if self.dispatched_ts is None or self.started_ts is None:
            return 0.0
        return max(0.0, self.started_ts - self.dispatched_ts)

    @property
    def compute_s(self) -> float:
        """Wall seconds spent in epochs: measured (start → last epoch
        stamp) when the worker reported its own stream; otherwise the
        summed epoch durations, capped at the segment's wall span (sim
        backends report simulated seconds that can exceed wall)."""
        if self.started_ts is not None and self.epochs:
            return max(0.0, self.epochs[-1]["ts"] - self.started_ts)
        total = sum(float(e.get("duration_s", 0.0)) for e in self.epochs)
        if self.dispatched_ts is not None and self.completed_ts is not None:
            return min(total, max(0.0, self.completed_ts
                                  - self.dispatched_ts))
        return total

    @property
    def span_s(self) -> float:
        if self.dispatched_ts is None or self.completed_ts is None:
            return 0.0
        return max(0.0, self.completed_ts - self.dispatched_ts)

    def to_payload(self) -> Dict[str, Any]:
        return {"trial_id": self.trial_id, "worker": self.worker,
                "dispatched_ts": self.dispatched_ts,
                "started_ts": self.started_ts,
                "completed_ts": self.completed_ts,
                "n_epochs": len(self.epochs),
                "queue_wait_s": self.queue_wait_s,
                "compute_s": self.compute_s, "span_s": self.span_s,
                "score": self.score, "error": self.error,
                "orphan": self.orphan}


@dataclasses.dataclass
class TrialSpan:
    """All segments of one trial, in dispatch order."""

    trial_id: str
    segments: List[Segment] = dataclasses.field(default_factory=list)

    @property
    def complete(self) -> bool:
        return bool(self.segments) and all(
            not s.orphan and s.completed_ts is not None
            for s in self.segments)


def load_events(paths: Sequence[str]) -> List[Dict[str, Any]]:
    """Concatenate the records of one or more JSONL traces (tolerating a
    torn final line per file, like any crash-surviving reader here)."""
    out: List[Dict[str, Any]] = []
    for p in paths:
        out.extend(read_trace(p))
    return out


def clock_offsets(records: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    """Per-proc wall-clock offset (seconds *ahead* of the driver), from
    the ``clock_sync`` handshake samples; smallest round-trip wins."""
    best: Dict[str, tuple] = {}
    for r in records:
        if r.get("kind") != "clock_sync":
            continue
        proc = str(r.get("proc") or "")
        rtt = float(r.get("rtt_s", 0.0))
        if proc and (proc not in best or rtt < best[proc][0]):
            best[proc] = (rtt, float(r.get("offset_s", 0.0)))
    return {proc: off for proc, (_, off) in best.items()}


def merge_events(records: Sequence[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """One skew-corrected, totally ordered stream: subtract each traced
    peer's clock offset from its records' ``ts``, then sort by corrected
    time (``seq`` breaks ties). Input records are not mutated."""
    offsets = clock_offsets(records)
    merged = []
    for r in records:
        off = offsets.get(str(r.get("proc") or ""), 0.0)
        if off:
            r = {**r, "ts": float(r.get("ts", 0.0)) - off}
        merged.append(r)
    merged.sort(key=lambda r: (float(r.get("ts", 0.0)),
                               int(r.get("seq", 0))))
    return merged


class Trace:
    """The reconstructed run: spans per trial + run-level event lists."""

    def __init__(self) -> None:
        self.trials: Dict[str, TrialSpan] = {}
        self.rpcs: List[Dict[str, Any]] = []
        self.refits: List[Dict[str, Any]] = []
        self.syncs: List[Dict[str, Any]] = []
        self.drops = 0
        self.procs: List[str] = []
        self.n_events = 0
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None

    # ------------------------------------------------------------ helpers
    @property
    def segments(self) -> List[Segment]:
        return [s for span in self.trials.values() for s in span.segments]

    @property
    def orphans(self) -> List[Segment]:
        return [s for s in self.segments if s.orphan]

    @property
    def wall_s(self) -> float:
        if self.t0 is None or self.t1 is None:
            return 0.0
        return max(0.0, self.t1 - self.t0)

    def workers(self) -> List[str]:
        return sorted({s.worker for s in self.segments if s.worker})


def build_trace(records: Sequence[Dict[str, Any]]) -> Trace:
    """Reconstruct spans from raw records (any order, any number of
    processes — ``merge_events`` runs first).

    Two passes. The driver's lifecycle events (``trial_dispatched`` /
    ``trial_completed``) come from ONE process, so their order is exact:
    they define the segments. Worker-side events (``trial_started`` /
    ``epoch_completed``) carry another host's clock — even after skew
    correction the residual error is bounded only by the handshake's
    round-trip — so they are slotted into the segment of their trial
    whose dispatch→completion window they fall in (nearest window when
    the residual pushes them just outside). Only events for a trial
    nobody dispatched become orphans.
    """
    merged = merge_events(records)
    tr = Trace()
    tr.n_events = len(merged)
    procs = []
    open_seg: Dict[str, Segment] = {}       # trial -> segment awaiting close
    worker_side: List[Dict[str, Any]] = []

    def span(tid: str) -> TrialSpan:
        if tid not in tr.trials:
            tr.trials[tid] = TrialSpan(tid)
        return tr.trials[tid]

    # -- pass 1: driver lifecycle -> segments; bucket the rest --------------
    for r in merged:
        kind = r.get("kind")
        ts = float(r.get("ts", 0.0))
        proc = str(r.get("proc") or "")
        if proc and proc not in procs:
            procs.append(proc)
        if kind in _TRIAL_KINDS:
            tr.t0 = ts if tr.t0 is None else min(tr.t0, ts)
            tr.t1 = ts if tr.t1 is None else max(tr.t1, ts)
        if kind == "trial_dispatched":
            tid = str(r.get("trial_id"))
            seg = Segment(trial_id=tid, worker=str(r.get("worker") or ""),
                          dispatched_ts=ts)
            span(tid).segments.append(seg)
            open_seg[tid] = seg
        elif kind == "trial_completed":
            tid = str(r.get("trial_id"))
            seg = open_seg.pop(tid, None)
            if seg is None:                 # completion without a dispatch
                seg = Segment(trial_id=tid,
                              worker=str(r.get("worker") or ""))
                span(tid).segments.append(seg)
            seg.completed_ts = ts
            seg.score = r.get("score")
            seg.error = r.get("error")
        elif kind in ("trial_started", "epoch_completed"):
            worker_side.append(r)
        elif kind == "rpc_completed":
            tr.rpcs.append(r)
        elif kind == "store_refit":
            tr.refits.append(r)
        elif kind == "clock_sync":
            tr.syncs.append(r)
        elif kind == "forward_dropped":
            tr.drops += int(r.get("dropped", 0))
    tr.procs = procs

    # -- pass 2: slot worker events into their trial's segments -------------
    orphan_seg: Dict[str, Segment] = {}

    def slot(tid: str, worker: str, ts: float) -> Segment:
        candidates = [s for s in tr.trials.get(tid, TrialSpan(tid)).segments
                      if not s.orphan]
        best, best_d = None, None
        for s in candidates:
            lo = s.dispatched_ts
            hi = s.completed_ts if s.completed_ts is not None \
                else float("inf")
            d = max(0.0, lo - ts, ts - hi)
            if best_d is None or d < best_d:
                best, best_d = s, d
        if best is not None:
            return best
        seg = orphan_seg.get(tid)
        if seg is None:                     # a trial nobody dispatched
            seg = Segment(trial_id=tid, worker=worker)
            span(tid).segments.append(seg)
            orphan_seg[tid] = seg
        return seg

    for r in worker_side:
        tid = str(r.get("trial_id"))
        ts = float(r.get("ts", 0.0))
        seg = slot(tid, str(r.get("worker") or ""), ts)
        if r.get("kind") == "trial_started":
            seg.started_ts = ts if seg.started_ts is None \
                else min(seg.started_ts, ts)
        else:
            seg.epochs.append({"epoch": int(r.get("epoch", 0)),
                               "duration_s": float(r.get("duration_s",
                                                         0.0)),
                               "ts": ts})
    for seg in tr.segments:
        seg.epochs.sort(key=lambda e: e["ts"])
    return tr


# ---------------------------------------------------------------------------
# analysis: breakdown, utilization, critical path
# ---------------------------------------------------------------------------

def _critical_path(segments: List[Segment]) -> List[Segment]:
    """Walk back from the last completion; each hop lands on the latest
    completion at or before the current segment's dispatch (the completion
    that gated it under wave-barrier scheduling)."""
    done = [s for s in segments
            if s.completed_ts is not None and s.dispatched_ts is not None]
    if not done:
        return []
    cur = max(done, key=lambda s: s.completed_ts)
    chain = [cur]
    while True:
        gate = None
        for s in done:
            if s is cur or s.completed_ts > cur.dispatched_ts + 1e-9:
                continue
            if gate is None or s.completed_ts > gate.completed_ts:
                gate = s
        if gate is None:
            break
        chain.append(gate)
        cur = gate
    chain.reverse()
    return chain


def analyze_trace(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The full report as a JSON-safe dict (see module docstring for the
    four analysis layers). ``render_report`` turns it into the table."""
    tr = build_trace(records)
    segments = [s for s in tr.segments if not s.orphan]
    wall = tr.wall_s
    workers = tr.workers()

    # -- per-worker occupancy ------------------------------------------------
    # busy time is the UNION of the worker's dispatch->completion intervals:
    # a run_many batch dispatches several trials to one worker at once, so
    # summing spans would count the same wall seconds once per trial
    per_worker: Dict[str, Dict[str, Any]] = {
        w: {"worker": w, "trials": 0, "epochs": 0, "busy_s": 0.0,
            "compute_s": 0.0} for w in workers}
    intervals: Dict[str, List[tuple]] = {w: [] for w in workers}
    for s in segments:
        if not s.worker:
            continue
        row = per_worker[s.worker]
        row["trials"] += 1
        row["epochs"] += len(s.epochs)
        row["compute_s"] += s.compute_s
        if s.dispatched_ts is not None and s.completed_ts is not None:
            intervals[s.worker].append((s.dispatched_ts, s.completed_ts))
    for w, spans in intervals.items():
        busy, hi = 0.0, None
        for lo, end in sorted(spans):
            if hi is None or lo > hi:
                busy += max(0.0, end - lo)
                hi = end
            elif end > hi:
                busy += end - hi
                hi = end
        per_worker[w]["busy_s"] = busy
    for row in per_worker.values():
        row["util"] = (row["busy_s"] / wall) if wall > 0 else 0.0
        row["idle_s"] = max(0.0, wall - row["busy_s"])

    # -- wall-time breakdown -------------------------------------------------
    compute = sum(s.compute_s for s in segments)
    queue_wait = sum(s.queue_wait_s for s in segments)
    rpc_overhead = sum(float(r.get("overhead_s", 0.0)) for r in tr.rpcs
                       if str(r.get("op")) in ("run", "run_many"))
    store_wait = sum(float(r.get("duration_s", 0.0)) for r in tr.rpcs
                     if str(r.get("peer", "")).startswith("store@"))
    idle = sum(row["idle_s"] for row in per_worker.values())
    capacity = wall * max(1, len(workers))
    breakdown = {"epoch_compute_s": compute, "queue_wait_s": queue_wait,
                 "rpc_overhead_s": rpc_overhead, "store_wait_s": store_wait,
                 "idle_s": idle, "wall_s": wall,
                 "capacity_s": capacity}

    # -- critical path + stragglers -----------------------------------------
    chain = _critical_path(segments)
    path_s = (chain[-1].completed_ts - min(chain[0].dispatched_ts, tr.t0)
              if chain else 0.0)
    blame: Dict[str, float] = {}
    for s in chain:
        blame[s.worker] = blame.get(s.worker, 0.0) + s.span_s
    stragglers = sorted(({"worker": w, "path_s": t,
                          "share": (t / path_s) if path_s > 0 else 0.0}
                         for w, t in blame.items()),
                        key=lambda d: -d["path_s"])

    trace_ids = sorted({str(r.get("trace")) for r in records
                        if r.get("trace")})
    return {
        "trace_ids": trace_ids,
        "n_events": tr.n_events,
        "procs": tr.procs,
        "n_trials": len(tr.trials),
        "n_segments": len(tr.segments),
        "n_orphans": len(tr.orphans),
        "orphan_trials": sorted({s.trial_id for s in tr.orphans}),
        "forward_dropped": tr.drops,
        "clock_offsets": clock_offsets(records),
        "breakdown": breakdown,
        "workers": [per_worker[w] for w in workers],
        "critical_path": {
            "length_s": max(0.0, path_s),
            "n_segments": len(chain),
            "segments": [s.to_payload() for s in chain],
        },
        "stragglers": stragglers,
        "trials": {tid: [s.to_payload() for s in span.segments]
                   for tid, span in sorted(tr.trials.items())},
        "store_refits": len(tr.refits),
    }


def _pct(part: float, whole: float) -> str:
    return f"{100.0 * part / whole:5.1f}%" if whole > 0 else "    —"


def render_report(report: Dict[str, Any]) -> str:
    """The human table (the JSON is the machine interface)."""
    b = report["breakdown"]
    wall, cap = b["wall_s"], b["capacity_s"]
    tids = ",".join(report["trace_ids"]) or "untraced"
    lines = [
        f"trace {tids} — {len(report['procs']) or 1} proc(s), "
        f"{report['n_events']} events, {report['n_trials']} trials / "
        f"{report['n_segments']} segments ({report['n_orphans']} orphans), "
        f"wall {wall:.3f}s",
    ]
    if report["clock_offsets"]:
        offs = ", ".join(f"{p} {o * 1e3:+.1f}ms"
                         for p, o in sorted(report["clock_offsets"].items()))
        lines.append(f"clock offsets: {offs}")
    if report["forward_dropped"]:
        lines.append(f"WARNING: {report['forward_dropped']} forwarded "
                     "record(s) dropped (bounded queue overflow)")
    lines += [
        "",
        "wall-time breakdown (of "
        f"{len(report['workers']) or 1} worker(s) x {wall:.3f}s = "
        f"{cap:.3f}s capacity)",
        f"  epoch compute  {b['epoch_compute_s']:9.3f}s  "
        f"{_pct(b['epoch_compute_s'], cap)}",
        f"  queue wait     {b['queue_wait_s']:9.3f}s  "
        f"{_pct(b['queue_wait_s'], cap)}",
        f"  rpc + codec    {b['rpc_overhead_s']:9.3f}s  "
        f"{_pct(b['rpc_overhead_s'], cap)}",
        f"  store waits    {b['store_wait_s']:9.3f}s  "
        f"{_pct(b['store_wait_s'], cap)}",
        f"  idle           {b['idle_s']:9.3f}s  {_pct(b['idle_s'], cap)}",
    ]
    if report["workers"]:
        lines += ["", "workers",
                  f"  {'worker':<28} {'trials':>6} {'epochs':>6} "
                  f"{'busy':>9} {'util':>7}"]
        for row in report["workers"]:
            lines.append(
                f"  {row['worker']:<28} {row['trials']:>6} "
                f"{row['epochs']:>6} {row['busy_s']:>8.3f}s "
                f"{_pct(row['busy_s'], wall)}")
    cp = report["critical_path"]
    if cp["segments"]:
        lines += ["",
                  f"critical path: {cp['length_s']:.3f}s across "
                  f"{cp['n_segments']} segment(s) "
                  f"({_pct(cp['length_s'], wall).strip()} of wall)"]
        t_base = cp["segments"][0]["dispatched_ts"]
        for s in cp["segments"]:
            lines.append(
                f"  {s['trial_id']:<12} @ {s['worker']:<28} "
                f"{s['dispatched_ts'] - t_base:8.3f} -> "
                f"{s['completed_ts'] - t_base:8.3f}s  "
                f"({s['span_s']:.3f}s, {s['n_epochs']} epochs)")
    if report["stragglers"]:
        top = report["stragglers"][0]
        lines.append(f"straggler: {top['worker']} holds "
                     f"{100.0 * top['share']:.1f}% of the critical path")
    if report["orphan_trials"]:
        lines.append("ORPHAN spans (events without a dispatch): "
                     + ", ".join(report["orphan_trials"]))
    return "\n".join(lines) + "\n"
