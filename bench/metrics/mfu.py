"""The window's model FLOPs (6·N_active·tokens plus attention's
visible-pair work, no recomputation) over the traced window at the bf16
peak, in %."""
from bench.harness.yardstick import PEAK_FLOPS


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    return 100.0 * t["model_flops"] / (t["window_s"] * PEAK_FLOPS)
