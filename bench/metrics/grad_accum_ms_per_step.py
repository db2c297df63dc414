"""Device ms a step in the program's ``grad_accum`` spans: the fp32
gradient sums over microbatches and their mean (none at 1 microbatch),
over every step of the window."""
from bench.harness import spans


def read(rec):
    return spans.device_ms_per_step(rec, "grad_accum")
