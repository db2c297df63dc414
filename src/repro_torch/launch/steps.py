"""Serve step builders: the counterpart of ``repro.launch.steps``, dense only.

``make_prefill_step`` and ``make_decode_step`` keep the reference's
signatures. PyTorch runs eagerly, so the returned functions need no ``jit``;
both run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.transformer import SystemConfig


def make_prefill_step(cfg, sys: SystemConfig, max_len: Optional[int] = None
                      ) -> Callable:
    """prefill(params, batch) -> (last-token logits, decode cache).

    max_len sizes the (full-attention) decode cache; default = prompt length.
    """
    transformer.require_dense(cfg)

    @torch.inference_mode()
    def prefill(params, batch):
        S = batch["tokens"].shape[1]
        logits, _, cache = transformer.forward(
            params, batch, cfg, sys, collect_cache=True, last_only=True,
            max_cache=max_len or S)
        return logits, cache
    return prefill


def make_decode_step(cfg, sys: SystemConfig) -> Callable:
    """decode(params, cache, tokens, pos) -> (logits, cache)."""
    transformer.require_dense(cfg)

    @torch.inference_mode()
    def decode(params, cache, tokens, pos):
        return transformer.decode_step(params, cache, tokens, pos, cfg, sys)
    return decode
