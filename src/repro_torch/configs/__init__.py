"""Architecture registry of the port.

``get_config(name)`` returns the full published config and
``get_reduced(name)`` the family-preserving smoke-test config, as in the
reference; every arch of the reference's ``ARCH_IDS`` resolves. The
paper's own workloads (``PAPER_WORKLOADS``, Table 3) return their
``SmallConfig`` from both, as in the reference.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "mixtral-8x22b", "qwen2-moe-a2.7b", "yi-34b", "qwen2-1.5b", "qwen3-0.6b",
    "deepseek-coder-33b", "internvl2-26b", "whisper-small",
    "recurrentgemma-9b", "xlstm-350m",
]

PAPER_WORKLOADS = ["lenet-mnist", "lenet-fashion", "cnn-news20", "lstm-news20"]

_MODULES = {"qwen3-0.6b": "qwen3_0_6b",
            "qwen2-1.5b": "qwen2_1_5b",
            "yi-34b": "yi_34b",
            "deepseek-coder-33b": "deepseek_coder_33b",
            "mixtral-8x22b": "mixtral_8x22b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "recurrentgemma-9b": "recurrentgemma_9b",
            "internvl2-26b": "internvl2_26b",
            "whisper-small": "whisper_small",
            "xlstm-350m": "xlstm_350m",
            **{name: "paper_workloads" for name in PAPER_WORKLOADS}}


def _mod(name: str):
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")


def get_config(name: str):
    m = _mod(name)
    if name in PAPER_WORKLOADS:
        return m.CONFIGS[name]
    return m.CONFIG


def get_reduced(name: str):
    m = _mod(name)
    if name in PAPER_WORKLOADS:
        return m.CONFIGS[name]
    return m.REDUCED


def get(name: str):
    """``get_config(name)``; ``get_reduced`` for an ``<arch>-reduced`` name."""
    if name.endswith("-reduced"):
        return get_reduced(name[:-len("-reduced")])
    return get_config(name)
