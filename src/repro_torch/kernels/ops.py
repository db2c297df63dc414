"""Public kernel ops: the counterpart of ``repro.kernels.ops``, forward only.

The backward kernels (B2 ``_dq_kernel`` and B3 ``_dkv_kernel``) come with the
training slice; until then a differentiable call raises rather than quietly
differentiating through the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa_kernel


def flash_attention(q, k, v, causal=True, window=None):
    """q: (B, S, K, G, D); k, v: (B, T, K, D) -> (B, S, K, G, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the kernels B2/B3 come with "
            "the training slice (ROADMAP.md queue A, item 'Training slice')")
    return fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
