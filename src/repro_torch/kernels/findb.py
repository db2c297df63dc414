"""Process-local kernel find-db: tuned configs resolved at every call site.

The port's copy of ``repro.kernels.findb`` (MIOpen's "find-db": a table of
known-best kernel configs keyed by problem shape and hardware, so
production never re-tunes what the fleet already measured):

- ``DEFAULTS`` holds the hand-picked fallback config per kernel, the same
  as the reference's.
- ``lookup_or_default(kernel, shape, default)`` is the fast path that
  every kernel call site reads when its caller leaves a block size None:
  ``kernels.flash_attention`` (B1, row ``"flash_attention"``),
  ``kernels.flash_attention_bwd`` (B2 and B3, row
  ``"flash_attention_bwd"``), through them ``ops.flash_attention`` and so
  the models' attention, ``kernels.mlstm``/``ops.mlstm`` and
  ``kernels.rglru``/``ops.rglru``, and ``TorchRealBackend`` for the
  ``train_step`` sys keys: a plain dict read against the active
  :class:`~repro_torch.core.groundtruth.KernelConfigDB`. A miss returns the
  default immediately — it never times anything, never blocks.
- ``shape_key``/``mlstm_shape_key``/... build the canonical shape keys,
  the reference's byte for byte. The tuner (``repro_torch.kernels.tune``)
  writes entries under these keys.
- The dtype rule of ``attention_shape_key``. The reference's key has no
  dtype, but the port's bf16 and fp32 attention kernels are different
  kernels with different tile plans. So a bf16 call appends
  ``dtype=bf16`` to the key and any other dtype appends nothing: fp32 keys
  stay the reference's byte for byte, and no fp32 call can read a bf16
  row (or the reverse).
- ``flash_attention_plans``/``flash_attention_bwd_plans`` give the
  ``(q_block, kv_block)`` pairs that the attention kernels compile for a
  dtype and head dim; ``flash_attention_defaults`` gives each kernel's
  plan from before the kernels took tiles, the default of a lookup that
  misses. The wrappers, the tuner and the tests share them. ``DEFAULTS``
  keeps the reference's entries for the attention kernels, which are no
  plan here: the wrappers pass these defaults instead.
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

__all__ = ["DEFAULTS", "attention_shape_key", "flash_attention_bwd_plans",
           "flash_attention_defaults", "flash_attention_plans",
           "flash_dtype", "get_find_db", "hardware_key", "lookup_or_default",
           "mlstm_shape_key", "rglru_shape_key", "set_find_db", "shape_key",
           "train_step_shape_key"]

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


def attention_shape_key(*, B, S, K, G, D, T, causal, window,
                        dtype=None) -> str:
    """The reference's key, plus ``dtype=bf16`` for bf16 inputs (see the
    module docstring); ``dtype`` is a torch dtype or its name."""
    dims = dict(B=B, S=S, K=K, G=G, D=D, T=T, causal=bool(causal),
                window="none" if window is None else int(window))
    if dtype is not None and flash_dtype(dtype) == "bf16":
        dims["dtype"] = "bf16"
    return shape_key(**dims)


def flash_dtype(dtype) -> str:
    """``"bf16"`` for bfloat16 (a torch dtype or a name such as
    ``"bf16"``), else ``"fp32"``: the attention kernels' two variants."""
    name = str(dtype).replace("torch.", "")
    return "bf16" if name in ("bf16", "bfloat16") else "fp32"


def _padded_dim(D: int) -> int:
    """The head dim class of the kernels' plans: up to 128 (the bf16
    kernels' D = 64 and 128 instantiations have the same plans) or 256."""
    return 128 if D <= 128 else 256


# (q_block, kv_block) pairs each kernel compiles, by dtype and padded head
# dim (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu). B1 counts
# q_block in flattened (position, head) rows; the backward's pairs are
# those both B2 and B3 compile.
_PLANS = {
    ("flash_attention", "bf16", 128): ((64, 64), (64, 128), (128, 64),
                                       (128, 128)),
    ("flash_attention", "bf16", 256): ((64, 32), (64, 64)),
    ("flash_attention", "fp32", 128): ((32, 16), (32, 32)),
    ("flash_attention", "fp32", 256): ((32, 16),),
    ("flash_attention_bwd", "bf16", 128): ((64, 64), (128, 64)),
    ("flash_attention_bwd", "bf16", 256): ((64, 64),),
    ("flash_attention_bwd", "fp32", 128): ((32, 32),),
    ("flash_attention_bwd", "fp32", 256): ((16, 16),),
}

# the plan each kernel ran before the kernels took tiles: B1, B2 (dq) and
# B3 (dkv) by dtype and padded head dim
_TODAY = {
    ("B1", "bf16", 128): (128, 128), ("B1", "bf16", 256): (64, 64),
    ("B1", "fp32", 128): (32, 32), ("B1", "fp32", 256): (32, 16),
    ("B2", "bf16", 128): (128, 64), ("B2", "bf16", 256): (64, 64),
    ("B2", "fp32", 128): (32, 32), ("B2", "fp32", 256): (16, 16),
    ("B3", "bf16", 128): (64, 64), ("B3", "bf16", 256): (64, 64),
    ("B3", "fp32", 128): (32, 32), ("B3", "fp32", 256): (16, 16),
}


def flash_attention_plans(dtype, head_dim: int) -> tuple:
    """B1's ``(q_block, kv_block)`` pairs for a dtype and head dim."""
    return _PLANS[("flash_attention", flash_dtype(dtype),
                   _padded_dim(head_dim))]


def flash_attention_bwd_plans(dtype, head_dim: int) -> tuple:
    """The backward's pairs (those B2 and B3 both compile)."""
    return _PLANS[("flash_attention_bwd", flash_dtype(dtype),
                   _padded_dim(head_dim))]


def flash_attention_defaults(kernel: str, dtype, head_dim: int) -> dict:
    """``{"q_block", "kv_block"}`` of kernel ``"B1"``, ``"B2"`` or ``"B3"``
    before the kernels took tiles: the default of a lookup that misses."""
    qb, kb = _TODAY[(kernel, flash_dtype(dtype), _padded_dim(head_dim))]
    return {"q_block": qb, "kv_block": kb}


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
