"""Device ms a step in the program's ``block`` spans: every decoder block,
forward and backward (a remat recompute inside its block's backward)."""
from bench.harness import spans


def read(rec):
    return spans.device_ms_per_step(rec, "block")
