"""The kernel find-db store of ``repro.core.groundtruth``: ``KernelConfigDB``
and the golden table (``export_golden`` / ``load_golden``).

The golden JSON is the reference's format byte for byte
(``repro.kernel-golden/1``, ``json.dump(..., indent=1, sort_keys=True)``),
so a table written by either package loads in the other: it is the state
this slice carries across, as ``weights.from_jax`` is for the models.
``GroundTruth``, ``CentroidModel`` and ``KMeans`` wait for the tuning-loop
slice (ROADMAP queue A, 2b).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple


class GroundTruthError(RuntimeError):
    """A persisted ground-truth store could not be read back."""


GOLDEN_FORMAT = "repro.kernel-golden/1"


class KernelConfigDB:
    """Kernel find-db: ``(kernel, shape_key, hardware_key) -> best config``.

    The MIOpen/MITuna find-db story for the port's own CUDA kernels: a tuner
    measures kernel variants once per workload shape, the winning config is
    persisted here, and every later call resolves it with a plain dict read
    (``lookup_or_default`` — never a trial, never a network round-trip).
    Pure store, no policy: stdlib only.

    ``hardware="any"`` entries are wildcard fallbacks: an exact hardware
    match wins, then ``"any"``, then the caller's default. Rows are plain
    JSON-able dicts (``{kernel, shape, hardware, config, objective}``) so
    they ride the wire codecs and the golden export format unchanged.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str, str], dict] = {}

    @staticmethod
    def _row(kernel: str, shape: str, hardware: str, config: dict,
             objective: Optional[float]) -> dict:
        return {"kernel": str(kernel), "shape": str(shape),
                "hardware": str(hardware), "config": dict(config),
                "objective": None if objective is None else float(objective)}

    def put(self, kernel: str, shape: str, config: dict, *,
            hardware: str = "any",
            objective: Optional[float] = None) -> None:
        row = self._row(kernel, shape, hardware, config, objective)
        with self._lock:
            self._entries[(row["kernel"], row["shape"],
                           row["hardware"])] = row

    def get(self, kernel: str, shape: str,
            hardware: str = "any") -> Optional[dict]:
        """Best-known config or None. Exact hardware match wins over the
        ``"any"`` wildcard; a miss is just None (callers fall back to their
        built-in defaults — a cold db never blocks anything)."""
        with self._lock:
            row = self._entries.get((str(kernel), str(shape), str(hardware)))
            if row is None and hardware != "any":
                row = self._entries.get((str(kernel), str(shape), "any"))
        return None if row is None else dict(row["config"])

    def lookup_or_default(self, kernel: str, shape: str, default: dict,
                          hardware: str = "any") -> dict:
        """``default`` overlaid with any tuned entry — the kernel-call fast
        path. Always returns a complete config, immediately."""
        cfg = self.get(kernel, shape, hardware)
        merged = dict(default)
        if cfg:
            merged.update(cfg)
        return merged

    def rows(self) -> List[dict]:
        """Every entry as a JSON-able row, in a stable (sorted-key) order."""
        with self._lock:
            items = sorted(self._entries.items())
        return [dict(row, config=dict(row["config"])) for _, row in items]

    def merge_rows(self, rows) -> int:
        """Bulk-apply rows (golden import / journal replay); returns the
        number applied. Later rows win on key collision, matching replay
        order semantics."""
        n = 0
        for row in rows:
            self.put(row["kernel"], row["shape"], dict(row["config"]),
                     hardware=row.get("hardware", "any"),
                     objective=row.get("objective"))
            n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def export_golden(rows: List[dict], path: str) -> int:
    """Write a golden config table (MITuna's shippable known-good db).
    Atomic replace; returns the row count."""
    payload = {"format": GOLDEN_FORMAT, "entries": list(rows)}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return len(payload["entries"])


def load_golden(path: str) -> List[dict]:
    """Read a golden config table back; hard error on anything malformed
    (shipping a truncated golden table would silently untune a fleet)."""
    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or \
                payload.get("format") != GOLDEN_FORMAT:
            raise ValueError(
                f"not a {GOLDEN_FORMAT} file "
                f"(format={payload.get('format')!r})"
                if isinstance(payload, dict) else
                f"unexpected top-level {type(payload).__name__}")
        rows = []
        for i, row in enumerate(payload["entries"]):
            rows.append(KernelConfigDB._row(
                row["kernel"], row["shape"], row.get("hardware", "any"),
                row["config"], row.get("objective")))
        return rows
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise GroundTruthError(
            f"corrupt kernel golden table at {path!r} ({e}); re-export it "
            "with `python -m repro_torch.kernels.tune export`") from None
