"""Share of the epochs PipeTune began in the window that probe a system
config: the program's ``tune.epochs.probe`` counter over the sum of
``tune.epochs.profile``, ``.probe`` and ``.locked``."""
from bench.harness import spans


def read(rec):
    n = spans.counters(rec, "tune.epochs.")
    total = sum(n.values())
    return n.get("probe", 0) / total if total else None
