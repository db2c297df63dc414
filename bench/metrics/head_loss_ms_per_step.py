"""Device ms a step in the program's ``head_loss`` spans: final norm, the
fp32 LM head, logsumexp and loss, forward and backward."""
from bench.harness import spans


def read(rec):
    return spans.device_ms_per_step(rec, "head_loss")
