"""Device ms a step of the kernels launched in the optimizer's update
call (the ``bench.optim`` range)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"] or not t["class_n"].get("optim"):
        return None
    return 1e3 * t["class_s"]["optim"] / t["steps"]
