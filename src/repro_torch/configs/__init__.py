"""Architecture registry of the port.

``get_config(name)`` returns the full published config and
``get_reduced(name)`` the family-preserving smoke-test config, as in the
reference. Only the archs whose family is ported resolve; the others raise,
naming the ROADMAP.md item (queue A) that brings them.
"""
from __future__ import annotations

import importlib

_MODULES = {"qwen3-0.6b": "qwen3_0_6b"}

_NOT_PORTED = {
    "mixtral-8x22b": "MoE and sliding window",
    "qwen2-moe-a2.7b": "MoE and sliding window",
    "yi-34b": "Other dense archs",
    "qwen2-1.5b": "Other dense archs",
    "deepseek-coder-33b": "Other dense archs",
    "internvl2-26b": "Encoder-decoder and VLM",
    "whisper-small": "Encoder-decoder and VLM",
    "recurrentgemma-9b": "Griffin (hybrid) family with B5",
    "xlstm-350m": "xLSTM (ssm) family with B4",
}


def _mod(name: str):
    if name in _MODULES:
        return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP.md queue A, item "
            f"'{_NOT_PORTED[name]}'")
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_reduced(name: str):
    return _mod(name).REDUCED


def get(name: str):
    """``get_config(name)``; ``get_reduced`` for an ``<arch>-reduced`` name."""
    if name.endswith("-reduced"):
        return get_reduced(name[:-len("-reduced")])
    return get_config(name)
