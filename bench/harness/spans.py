"""The program's own spans and counters (``repro_torch.obs.spans``), as the
traced window left them: the benchmark's only reader of that table. The
table is live while torch.profiler records, so the ``--trace 1`` run's
window fills it. Where the run was not traced, the program has no such
table, or it holds nothing, every reader finds None."""
from __future__ import annotations


def table(rec):
    """``repro_torch.obs.spans.table()`` after the traced run ``rec``, or
    None where it is missing or empty."""
    if not rec.get("trace"):
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    t = spans.table()
    return t if t["totals"] or t["counters"] else None


def device_ms_per_step(rec, *names):
    """The device ms of the spans ``names`` (forward and backward), over
    the ``step`` spans the table holds; None where it holds none of them."""
    t = table(rec)
    steps = t and t["totals"].get("step", {}).get("n")
    if not steps or not any(n in t["totals"] for n in names):
        return None
    return sum(t["totals"][n]["device_ms"] for n in names
               if n in t["totals"]) / steps


def host_ms(rec, *names):
    """The host ms of the spans ``names``; None where there is none."""
    t = table(rec)
    if not t or not any(n in t["totals"] for n in names):
        return None
    return sum(t["totals"][n]["host_ms"] for n in names if n in t["totals"])


def counters(rec, prefix: str) -> dict:
    """{name: n} of the counters under ``prefix``, the prefix cut off."""
    t = table(rec)
    if not t:
        return {}
    return {k[len(prefix):]: v for k, v in t["counters"].items()
            if k.startswith(prefix)}
