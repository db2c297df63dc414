"""Process-local kernel find-db: tuned configs resolved at every call site.

The port's copy of ``repro.kernels.findb`` (MIOpen's "find-db": a table of
known-best kernel configs keyed by problem shape and hardware, so
production never re-tunes what the fleet already measured):

- ``DEFAULTS`` holds the hand-picked fallback config per kernel, the same
  as the reference's.
- ``lookup_or_default(kernel, shape, default)`` is the fast path that
  ``ops.mlstm``/``ops.rglru`` read: a plain dict read against the active
  :class:`~repro_torch.core.groundtruth.KernelConfigDB`. A miss returns the
  default immediately — it never times anything, never blocks.
- ``shape_key``/``mlstm_shape_key``/... build the canonical shape keys,
  the reference's byte for byte. The tuner (``repro_torch.kernels.tune``)
  writes entries under these keys.
- ``hardware_key()`` names the device: ``cuda/<device name>`` (lower case,
  spaces as ``_``) with a card, ``cpu/cpu`` without one — the reference's
  CPU key. The reference's ``default_interpret`` has no counterpart: the
  device of the tensors decides between kernel and plain version.

The active db defaults to an empty in-process store; ``set_find_db``
points it at one primed from a golden table (``tune.install_kernel_db``).
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.groundtruth import KernelConfigDB

__all__ = ["DEFAULTS", "attention_shape_key", "get_find_db", "hardware_key",
           "lookup_or_default", "mlstm_shape_key", "rglru_shape_key",
           "set_find_db", "shape_key", "train_step_shape_key"]

# hand-picked defaults the call sites used before autotuning; the miss-path
# answer of every lookup
DEFAULTS = {
    "flash_attention": {"q_block": 128, "kv_block": 128},
    "flash_attention_bwd": {"q_block": 128, "kv_block": 128},
    "mlstm": {"chunk": 128},
    "rglru": {"chunk": 128, "r_block": 128},
    "train_step": {},
}

_lock = threading.Lock()
_active_db = KernelConfigDB()


def get_find_db() -> KernelConfigDB:
    """The process-wide active find-db."""
    return _active_db


def set_find_db(db: KernelConfigDB) -> KernelConfigDB:
    """Swap the active find-db (e.g. for one primed from a golden table);
    returns the previous one so callers can restore it."""
    global _active_db
    with _lock:
        prev, _active_db = _active_db, db
    return prev


def hardware_key(device=None) -> str:
    """Stable id of the device kernels run on: ``cuda/<name>`` for a CUDA
    device (the current one by default when a card is present),
    ``cpu/cpu`` for the CPU, ``meta/meta`` for the dry-run's meta device
    (which no tuned row names, so its lookups take the defaults)."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type in ("cpu", "meta"):
        return f"{device.type}/{device.type}"
    name = torch.cuda.get_device_name(device)
    return f"{device.type}/{name}".replace(" ", "_").lower()


def shape_key(**dims) -> str:
    """Canonical shape key: sorted ``k=v`` pairs, so every writer and
    reader agrees independent of argument order."""
    return ",".join(f"{k}={dims[k]}" for k in sorted(dims))


def attention_shape_key(*, B, S, K, G, D, T, causal, window) -> str:
    return shape_key(B=B, S=S, K=K, G=G, D=D, T=T,
                     causal=bool(causal),
                     window="none" if window is None else int(window))


def mlstm_shape_key(*, B, S, H, D) -> str:
    return shape_key(B=B, S=S, H=H, D=D)


def rglru_shape_key(*, B, S, R) -> str:
    return shape_key(B=B, S=S, R=R)


def train_step_shape_key(*, arch, batch) -> str:
    return shape_key(arch=str(arch), batch=int(batch))


def lookup_or_default(kernel: str, shape: str,
                      default: Optional[dict] = None,
                      hardware: Optional[str] = None) -> dict:
    """Tuned config for ``(kernel, shape, hardware)`` overlaid on the
    kernel's built-in default. Pure dict read on the active db; a miss
    returns the default immediately (never blocks, never tunes)."""
    if default is None:
        default = DEFAULTS.get(kernel, {})
    return _active_db.lookup_or_default(
        kernel, shape, default,
        hardware=hardware if hardware is not None else hardware_key())
