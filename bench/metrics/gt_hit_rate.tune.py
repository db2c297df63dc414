"""PipeTune's ground-truth hits over its lookups in the window."""


def read(rec):
    t = rec.get("tune")
    n = t and t["gt_hits"] + t["gt_misses"]
    if not n:
        return None
    return t["gt_hits"] / n
