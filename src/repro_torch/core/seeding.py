"""Process-stable seeding helpers: a copy of ``repro.core.seeding``.

``builtins.hash`` on strings is salted per process (PYTHONHASHSEED), so any
RNG seeded from it gives every invocation of the same experiment different
data/noise. Everything that derives a seed from a workload name goes through
``stable_hash`` instead.
"""
from __future__ import annotations

import zlib


def stable_hash(s: str) -> int:
    """Deterministic non-negative 32-bit hash of a string."""
    return zlib.crc32(s.encode())
