"""Device ms a step in the program's ``cast`` spans: the fp32 masters cast
to the compute dtype once a microbatch (the stacked layers unbound), and
in the backward the gradients stacked and cast back to fp32."""
from bench.harness import spans


def read(rec):
    return spans.device_ms_per_step(rec, "cast")
