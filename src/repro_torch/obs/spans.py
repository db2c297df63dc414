"""Spans and counters inside the program: the train step, the model's
layers, the optimizer and PipeTune's loop, on the host's clock and, on a
CUDA device, on the card's.

Off by default and near-free when off, as ``events``' bus is: ``span(name)``
then returns one shared null context after a flag read, no autograd marker
is inserted and no CUDA event is made. The table is live

* while a ``torch.profiler`` session records in this process (torch's own
  flag, ``torch.autograd.profiler._is_profiler_enabled``). Each span is
  then also a ``record_function("repro.<name>")`` range (a backward one
  ``repro.<name>.bwd``), so the program's layers sit on the profiler's
  timeline, on the clock of the card's activity;
* inside ``enabled()``, the operator's switch (no profiler ranges then).

When the table goes from off to live (as a span, a counter, ``live()``,
``table()`` or the end of ``enabled()`` sees it) it clears itself: it holds
one traced window. This module imports no torch until its first live use, so
``import repro_torch.obs`` still loads none.

A span records its name, its parent (a per-thread stack: executors may run
trials on lanes), its host start and end (``time.perf_counter_ns``) and,
where CUDA is initialised, a device start and end from a pair of timing
events on the current stream; on the CPU the host times stand in. Nothing
synchronises while work runs: a ``step`` span's close resolves the pairs
whose end event has completed (the step before's), and ``table()``
resolves the rest (one synchronise). Per name the table keeps the count, host ms, device ms and
self device ms (the span's device time less what its children cover), and
the last ``RING`` records.

A forward ``with`` block cannot hold its backward. ``Span.input(...)`` and
``Span.output(...)`` pass tensors through an identity autograd node (a
view: no kernel); the output's node opens the span's backward record when
its gradient arrives, the input's closes it once every input's gradient is
computed. The backward record takes the forward span's parent. DTensor
leaves get no marker: the sharded step's spans have forward records only.

    with spans.span("block") as sp:
        lp, x = sp.input(lp, x)
        x = sp.output(body(lp, x))

``counter(name, n)`` counts only while the table is live.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import threading
import time

__all__ = ["RING", "Span", "counter", "enabled", "live", "span", "table"]

RING = 65536              # raw records kept; the totals count every one


class _Null:
    """The span while the table is off: does nothing, marks nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def input(self, *trees):
        return trees[0] if len(trees) == 1 else trees

    output = input

    def outside(self):
        return self


_NULL = _Null()
_FORCED = 0               # depth of ``enabled()`` blocks
_AP = None                # torch.autograd.profiler, once torch is loaded


def _profiling() -> bool:
    global _AP
    if _AP is None:
        _AP = sys.modules.get("torch.autograd.profiler")
        if _AP is None:
            return False        # torch not loaded: nothing records
    return _AP._is_profiler_enabled


class _Table:
    """The process's spans and counters since the table last went live."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.live = False
        self.gen = 0
        self.free = []          # CUDA events to record again
        self._reset()

    def _reset(self):
        self.origin = None      # the window's first CUDA event
        self.t0 = time.perf_counter_ns()
        self.pending = collections.deque()
        self.ring = collections.deque(maxlen=RING)
        self.totals = {}
        self.counters = collections.Counter()

    def clear(self):
        with self.lock:
            self.gen += 1
            self._reset()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self):
        """A timing event recorded on the current stream, or None where
        CUDA is not initialised."""
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return None
        if self.origin is None:
            self.origin = torch.cuda.Event(enable_timing=True)
            self.origin.record()
        try:
            ev = self.free.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def close(self, rec: "Span"):
        with self.lock:
            if rec.gen == self.gen:
                self.pending.append(rec)

    def poll(self, wait: bool = False):
        """Resolve the closed records in order, up to the first whose end
        event has not completed (with ``wait``: all, after one
        synchronise)."""
        with self.lock:
            if wait and any(r.ev1 is not None for r in self.pending):
                sys.modules["torch"].cuda.synchronize()
            while self.pending:
                r = self.pending[0]
                if r.ev1 is not None and not r.ev1.query():
                    break
                self.pending.popleft()
                self._resolve(r)

    def _resolve(self, r: "Span"):
        h0, h1 = (r.t0 - self.t0) / 1e6, (r.t1 - self.t0) / 1e6
        if r.ev1 is not None and self.origin is not None:
            d0 = self.origin.elapsed_time(r.ev0)
            d1 = self.origin.elapsed_time(r.ev1)
            self.free += (r.ev0, r.ev1)
        else:
            d0, d1 = h0, h1
        kids, r.kids = r.kids, None
        parent, r.parent = r.parent, None
        if parent is not None and parent.kids is not None:
            parent.kids.append((d0, d1))
        tot = self.totals.get(r.name)
        if tot is None:
            tot = self.totals[r.name] = [0, 0.0, 0.0, 0.0]
        tot[0] += 1
        tot[1] += h1 - h0
        tot[2] += d1 - d0
        tot[3] += d1 - d0 - _covered(kids, d0, d1)
        self.ring.append({"id": r.id, "parent": r.parent_id, "name": r.name,
                          "phase": r.phase, "host_ms": (h0, h1),
                          "device_ms": (d0, d1)})


def _covered(intervals, a, b) -> float:
    """Length of the union of ``intervals`` clipped to [a, b]."""
    total, end = 0.0, a
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, b)
        if e > s:
            total += e - s
            end = e
    return total


_TABLE = _Table()


def live() -> bool:
    """Whether spans record now; clears the table when it goes live."""
    on = _FORCED > 0 or _profiling()
    if on != _TABLE.live:
        _TABLE.live = on
        if on:
            _TABLE.clear()
    return on


def span(name: str):
    """A context that records ``name`` while the table is live (module
    docstring), else the shared null context."""
    return Span(name) if live() else _NULL


def counter(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` while the table is live."""
    if live():
        with _TABLE.lock:
            _TABLE.counters[name] += n


@contextlib.contextmanager
def enabled():
    """The operator's switch: the table is live inside (without profiler
    ranges unless a profiler records too)."""
    global _FORCED
    _FORCED += 1
    try:
        live()
        yield
    finally:
        _FORCED -= 1
        live()


def table() -> dict:
    """The window's spans and counters, every closed record resolved:
    ``totals`` ({name: {"n", "host_ms", "device_ms", "self_device_ms"}}),
    ``counters`` ({name: n}) and ``records`` (the last ``RING``: id,
    parent id, name, phase "fwd" or "bwd", host and device (start, end) in
    ms from the window's start). Read once the window has closed, it
    leaves the table off, to clear when it next goes live."""
    live()
    if "torch" in sys.modules:
        _TABLE.poll(wait=True)
    with _TABLE.lock:
        return {"totals": {k: {"n": v[0], "host_ms": v[1], "device_ms": v[2],
                               "self_device_ms": v[3]}
                           for k, v in _TABLE.totals.items()},
                "counters": dict(_TABLE.counters),
                "records": list(_TABLE.ring)}


class Span:
    """One live span: a forward record, and the backward record its
    ``input``/``output`` markers open and close."""

    __slots__ = ("name", "phase", "id", "parent", "parent_id", "gen", "t0",
                 "t1", "ev0", "ev1", "kids", "rf", "bwd")

    def __init__(self, name: str, phase: str = "fwd", parent=None):
        self.name, self.phase = name, phase
        self.id = next(_TABLE.ids)
        self.parent = parent
        self.gen = _TABLE.gen
        self.t0 = self.t1 = 0
        self.ev0 = self.ev1 = None
        self.kids = []
        self.rf = None
        self.bwd = None

    # -- the host's side ---------------------------------------------------
    def _open(self):
        self.parent_id = self.parent.id if self.parent is not None else None
        if _profiling():
            from torch.autograd.profiler import record_function
            suffix = "" if self.phase == "fwd" else "." + self.phase
            self.rf = record_function("repro." + self.name + suffix)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        self.ev0 = _TABLE.event()

    def _shut(self):
        self.ev1 = _TABLE.event()
        self.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        _TABLE.close(self)

    def __enter__(self):
        stack = _TABLE.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._open()
        return self

    def __exit__(self, *exc):
        self._shut()
        if self.name == "step":     # the step boundary, while the card
            _TABLE.poll()           # still runs the step's tail
        stack = _TABLE.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False

    @contextlib.contextmanager
    def outside(self):
        """Off this thread's stack for the block (a generator's ``yield``
        inside the span: what runs meanwhile is not its child)."""
        stack = _TABLE.stack()
        if self in stack:
            stack.remove(self)
        try:
            yield
        finally:
            _TABLE.stack().append(self)

    # -- the backward ------------------------------------------------------
    def input(self, *trees):
        """``trees`` with their tensors through a marker whose backward
        closes this span's backward record."""
        out = _marked(trees, self._bwd_close)
        return out[0] if len(out) == 1 else out

    def output(self, *trees):
        """``trees`` with their tensors through a marker whose backward
        opens this span's backward record."""
        out = _marked(trees, self._bwd_open)
        return out[0] if len(out) == 1 else out

    def _bwd_open(self):
        if self.bwd is None and self.gen == _TABLE.gen:
            self.bwd = Span(self.name, "bwd", self.parent)
            self.bwd._open()

    def _bwd_close(self):
        b, self.bwd = self.bwd, None
        if b is not None:
            b._shut()


_MARK = None


def _mark_fn():
    """The identity autograd node, built on first use (torch loaded)."""
    global _MARK
    if _MARK is None:
        import torch

        class Mark(torch.autograd.Function):
            @staticmethod
            def forward(ctx, hook, *xs):
                ctx.hook = hook
                ctx.set_materialize_grads(False)
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *grads):
                ctx.hook()
                return (None,) + grads

        _MARK = Mark
    return _MARK


def _marked(trees, hook) -> tuple:
    """``trees`` (tensors, or dicts and lists of them) with every plain
    tensor that needs a gradient passed through one marker node."""
    torch = sys.modules["torch"]
    if not torch.is_grad_enabled():
        return trees
    from repro_torch.tree import tree_leaves, tree_map
    from torch.distributed.tensor import DTensor
    leaves = {id(t): t for t in tree_leaves(list(trees))
              if isinstance(t, torch.Tensor) and t.requires_grad
              and not isinstance(t, DTensor)}
    if not leaves:
        return trees
    swap = dict(zip(leaves, _mark_fn().apply(hook, *leaves.values())))
    return tuple(tree_map(lambda t: swap.get(id(t), t), list(trees)))
