"""Public kernel ops: the counterpart of ``repro.kernels.ops`` for attention.

``flash_attention_fused`` differentiates through the kernels both ways, as
the reference's op of that name does: the forward is B1
(``kernels.flash_attention``, which also returns the per-row LSE) and the
backward is B2 and B3 (``kernels.flash_attention_bwd``), recomputing the
probabilities from the saved LSE, so no score-shaped tensor is kept.

The reference's ``flash_attention`` differentiates by recomputing through
its jnp oracle. On the card that would be autograd through the plain
version, so the port routes ``flash_attention`` through the fused op too:
the gradient is the same function.

Without autograd (``torch.no_grad``, ``torch.inference_mode``, or no input
that requires grad) the op calls B1 alone and saves nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import flash_attention_bwd as fa_bwd_kernel


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = fa_kernel.flash_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa_bwd_kernel.flash_attention_bwd(
            q, k, v, out, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_fused(q, k, v, causal=True, window=None):
    """q: (B, S, K, G, D); k, v: (B, T, K, D) -> (B, S, K, G, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return fa_kernel.flash_attention(q, k, v, causal=causal, window=window)


def flash_attention(q, k, v, causal=True, window=None):
    """The fused op under the reference's name (see the module docstring)."""
    return flash_attention_fused(q, k, v, causal, window)
