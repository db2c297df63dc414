"""The card's energy over the window (NVML's total-energy counter), over
the window's tokens."""


def read(rec):
    e = rec.get("energy_j")
    return e / rec["tokens"] if e and rec["tokens"] else None
