"""B1's share of its roofline, in %: the summed ``kernel_bound`` of the
window's B1 calls over B1's device time."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["class_s"].get("b1"):
        return None
    return 100.0 * t["b1_bound_s"] / t["class_s"]["b1"]
