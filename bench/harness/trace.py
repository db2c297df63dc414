"""The traced run's records: torch.profiler over the whole window,
reduced to kernel classes, device busy time and the breakdown.

Kernel classes, by name (``CLASSES``, first match wins):

* ``b1``: B1, the flash-attention forward (``fa_fwd_*``);
* ``b2``: B2, its dq backward (``fa_bwd_dq_*``);
* ``b3``: B3, its dk/dv backward (``fa_bwd_dkv_*``);
* ``gemm``: cuBLAS and CUTLASS matrix products (``gemm``, ``nvjet``,
  ``xmma``, ``cutlass``, ``gemv``, ``splitKreduce``);
* ``optim``: any other kernel launched inside a ``bench.optim`` range
  (the optimizer's update call);
* ``other``: the rest (norms, RoPE, casts, softmax and loss, MoE gathers
  and scatters, the attention's delta, the parameter update's add).

Kernels launched inside a ``bench.check`` range are the correctness
check's own reading, which the window does not count: they go to the
class ``check`` and out of the busy time, and no idle gap inside such a
range is listed.

A kernel is tied to its launch through the profiler's correlation id: the
CUDA runtime call that launched it (``cudaLaunchKernel`` and kin) or, if
that is missing, the operator it is linked to; the launch's host time says
whether it fell in a benchmark range.
"""
from __future__ import annotations

import bisect
import collections
import re

from bench.harness.yardstick import busy_union_ns

CLASSES = (("b1", re.compile(r"fa_fwd_")),
           ("b2", re.compile(r"fa_bwd_dq_")),
           ("b3", re.compile(r"fa_bwd_dkv_")),
           ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass|gemv|splitKreduce",
                               re.I)))

RANGE_PREFIX = "bench."
# device activities that occupy the card; its timeline also carries the
# host's ranges ("gpu_user_annotation") and synchronisations ("cuda_sync")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


def short(name: str, n: int = 96) -> str:
    """A kernel's name without its return type and argument list, at most
    ``n`` chars."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return base.split("(")[0][:n]


class Ranges:
    """Sorted (start, end, name) host intervals of one kind."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def containing(self, t):
        """The innermost span containing host time ``t``, or None."""
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, name in reversed(self.spans[max(0, i - 64):i]):
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best


def activity(e) -> str:
    """The event's kineto activity type; where this torch's events do not
    say, a device event named as a benchmark range is the host's range on
    the card's timeline, and one with no name a synchronisation."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if not name:
        return "cuda_sync"
    if name.startswith(RANGE_PREFIX) or getattr(
            e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    return "kernel"


def reduce(prof, window_ns: int) -> dict:
    """Kernel time by class, busy time, the ten largest device operations
    and the ten longest idle gaps named by the host's work."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    cpu, launch, linked = [], {}, {}
    device, kinds = [], collections.Counter()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            kind = activity(e)
            kinds[kind] += (e.end_ns() - e.start_ns()) / 1e9
            if kind in DEVICE_KINDS:
                device.append(e)
            continue
        cid, name = e.correlation_id(), e.name()
        kind = getattr(e, "activity_type", lambda: "")()
        if kind in LAUNCH_KINDS or name.startswith(("cudaLaunch",
                                                    "cuLaunch")):
            launch[cid] = e.start_ns()
        else:
            linked[cid] = e.start_ns()
            cpu.append((e.start_ns(), e.end_ns(), name))
    bench_ranges = Ranges([s for s in cpu if s[2].startswith(RANGE_PREFIX)])
    optim = Ranges([s for s in cpu if s[2] == "bench.optim"])
    check = Ranges([s for s in cpu if s[2] == "bench.check"])
    ops = Ranges([s for s in cpu if not s[2].startswith(RANGE_PREFIX)])
    by_class = collections.Counter()
    counts = collections.Counter()
    by_name = collections.Counter()
    spans = []
    for e in device:
        s, t = e.start_ns(), e.end_ns()
        if t <= s:
            continue
        name = e.name()
        dur = (t - s) / 1e9
        cls = kernel_class(name)
        at = launch.get(e.correlation_id())
        if at is None:
            at = linked.get(e.linked_correlation_id())
        if at is not None and check.containing(at) is not None:
            by_class["check"] += dur
            counts["check"] += 1
            continue
        spans.append((s, t))
        if cls == "other" and at is not None and \
                optim.containing(at) is not None:
            cls = "optim"
        by_class[cls] += dur
        counts[cls] += 1
        by_name[short(name)] += dur
    busy = busy_union_ns(spans) / 1e9
    return {"class_s": dict(by_class), "class_n": dict(counts),
            "device_kinds": dict(kinds),
            "busy_s": busy, "window_s": window_ns / 1e9,
            "device_ops": [[k, v] for k, v in by_name.most_common(10)],
            "idle_gaps": _gaps(spans, bench_ranges, ops, check)}


def _gaps(spans, bench_ranges, ops, check, n=10):
    """The ``n`` longest gaps between device activity, each named by the
    benchmark range and the host operator running at the gap's middle;
    none inside a ``check`` range."""
    gaps, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end and \
                check.containing((a + end) // 2) is None:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    out = []
    for dur, a, b in gaps[:n]:
        mid = (a + b) // 2
        r = bench_ranges.containing(mid)
        o = ops.containing(mid)
        name = "/".join(x[2] for x in (r, o) if x is not None) or "host"
        out.append([name, dur / 1e9])
    return out


def profile():
    """A profiler of the host and the card, recording no shapes or
    stacks."""
    from torch.profiler import ProfilerActivity, profile as prof
    return prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str):
    from torch.profiler import record_function
    return record_function(RANGE_PREFIX + name)
