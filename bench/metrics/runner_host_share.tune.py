"""Share of the window's wall time the host spends in PipeTune's runner
and the scheduler: the program's ``tune.policy`` (the per-epoch config,
the lookups, the probe plans, the store) and ``tune.schedule`` spans."""
from bench.harness import spans


def read(rec):
    t = rec.get("tune")
    ms = spans.host_ms(rec, "tune.policy", "tune.schedule")
    if not t or ms is None or t["window_s"] <= 0:
        return None
    return ms / 1e3 / t["window_s"]
