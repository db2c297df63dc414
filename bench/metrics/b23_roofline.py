"""B2 and B3's share of their roofline, in %: the summed ``kernel_bound``
of the window's B2 and B3 calls over their device time."""


def read(rec):
    t = rec.get("trace")
    busy = t and t["class_s"].get("b2", 0.0) + t["class_s"].get("b3", 0.0)
    if not busy:
        return None
    return 100.0 * t["b23_bound_s"] / busy
