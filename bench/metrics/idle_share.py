"""Share of the traced window in which no operation ran on the card (the
union of every device activity's interval)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
