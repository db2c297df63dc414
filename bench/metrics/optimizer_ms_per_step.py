"""Device ms a step of the optimizer as the program draws it: its
``optim.clip`` (global norm), ``optim.update`` (moments and update) and
``apply`` (the update added to the parameters) spans."""
from bench.harness import spans


def read(rec):
    return spans.device_ms_per_step(rec, "optim.clip", "optim.update",
                                    "apply")
