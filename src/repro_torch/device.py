"""Device and dtype policy of the port.

* The default device is ``cuda``. Without a GPU, :func:`resolve` raises unless
  the caller asked for ``"cpu"``: nothing carries on quietly on the CPU.
* On the card, float32 products run in full float32: :func:`resolve` sets
  ``torch.backends.cuda.matmul.allow_tf32 = False`` and
  ``torch.backends.cudnn.allow_tf32 = False`` (TF32 keeps about three decimal
  digits, which the fp32 parity checks against the JAX reference cannot take).
* The compute dtype is bf16 for ``precision="bf16"`` and fp32 for ``"fp32"``,
  as ``SystemConfig.compute_dtype`` in the reference.
"""
from __future__ import annotations

import time
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(precision: str) -> torch.dtype:
    if precision == "bf16":
        return torch.bfloat16
    if precision == "fp32":
        return torch.float32
    raise ValueError(f"unknown precision {precision!r} (bf16 | fp32)")


class Timer:
    """Elapsed ms of a ``with`` block: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
