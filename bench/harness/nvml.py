"""The card's energy counter, read through NVML with ctypes from the
driver's ``libnvidia-ml`` (nothing installed): total energy in mJ since
the driver loaded (``nvmlDeviceGetTotalEnergyConsumption``)."""
from __future__ import annotations

import ctypes
from typing import Optional

_VP, _P = ctypes.c_void_p, ctypes.POINTER
_SIGNATURES = (
    ("nvmlInit_v2", []),
    ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, _P(_VP)]),
    ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, _P(_VP)]),
    ("nvmlDeviceGetTotalEnergyConsumption", [_VP, _P(ctypes.c_ulonglong)]),
    ("nvmlDeviceGetEnforcedPowerLimit", [_VP, _P(ctypes.c_uint)]),
)


class Energy:
    """``read()`` gives the card's energy counter in joules, or None where
    the library or the counter is missing."""

    def __init__(self, device_index: int = 0, uuid: Optional[str] = None):
        self.lib = self.handle = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            for name, args in _SIGNATURES:
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = ctypes.c_int
        except (OSError, AttributeError):
            return
        if lib.nvmlInit_v2() != 0:
            return
        handle = _VP()
        rc = 1
        if uuid:
            rc = lib.nvmlDeviceGetHandleByUUID(uuid.encode(),
                                               ctypes.byref(handle))
        if rc != 0:
            rc = lib.nvmlDeviceGetHandleByIndex_v2(device_index,
                                                   ctypes.byref(handle))
        if rc != 0:
            return
        self.lib, self.handle = lib, handle
        if self.read() is None:
            self.lib = None

    def read(self) -> Optional[float]:
        if self.lib is None:
            return None
        mj = ctypes.c_ulonglong()
        if self.lib.nvmlDeviceGetTotalEnergyConsumption(
                self.handle, ctypes.byref(mj)) != 0:
            return None
        return mj.value / 1e3

    def power_limit_w(self) -> Optional[float]:
        if self.lib is None:
            return None
        mw = ctypes.c_uint()
        if self.lib.nvmlDeviceGetEnforcedPowerLimit(self.handle,
                                                    ctypes.byref(mw)) != 0:
            return None
        return mw.value / 1e3


def card_uuid(device) -> Optional[str]:
    import torch
    u = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return None if u is None else f"GPU-{u}"
