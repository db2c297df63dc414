"""Architecture registry of the port.

``get_config(name)`` returns the full published config and
``get_reduced(name)`` the family-preserving smoke-test config, as in the
reference. The dense, moe and hybrid archs resolve; the others (ssm, vlm,
audio) raise, naming the ROADMAP.md item (queue A) that brings them. The
paper's own workloads (``PAPER_WORKLOADS``, Table 3) return their
``SmallConfig`` from both, as in the reference.
"""
from __future__ import annotations

import importlib

PAPER_WORKLOADS = ["lenet-mnist", "lenet-fashion", "cnn-news20", "lstm-news20"]

_MODULES = {"qwen3-0.6b": "qwen3_0_6b",
            "qwen2-1.5b": "qwen2_1_5b",
            "yi-34b": "yi_34b",
            "deepseek-coder-33b": "deepseek_coder_33b",
            "mixtral-8x22b": "mixtral_8x22b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "recurrentgemma-9b": "recurrentgemma_9b",
            **{name: "paper_workloads" for name in PAPER_WORKLOADS}}

_NOT_PORTED = {   # arch -> (ROADMAP.md queue A item, its title)
    "internvl2-26b": ("7", "Encoder-decoder and VLM"),
    "whisper-small": ("7", "Encoder-decoder and VLM"),
    "xlstm-350m": ("5", "xLSTM (ssm) family"),
}


def _mod(name: str):
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if name in _NOT_PORTED:
        num, title = _NOT_PORTED[name]
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP.md queue A, item "
            f"{num} '{title}'")
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")


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
