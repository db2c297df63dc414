"""Share of the window's wall time outside the train-step calls: trial
set-up, step builds, ground-truth lookups, the scheduler (host clock
around each call)."""


def read(rec):
    t = rec.get("tune")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["step_s"] / t["window_s"]
