"""Public kernel ops with autograd: the counterpart of ``repro.kernels.ops``.

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

``mlstm`` (B4) and ``rglru`` (B5) are the reference's ops of those names:
the forward is the kernel, the backward recomputes the plain version
(``mlstm_chunkwise_reference``, ``rglru_reference``) under autograd and
takes its vector-Jacobian product, exactly as the reference recomputes
through its jnp oracle (``repro/kernels/ops.py`` ``_rglru_bwd``,
``_mlstm_bwd``); the reference has no backward kernel for either. Block
sizes left as None resolve through the find-db (``kernels.findb``) for the
inputs' device; mlstm's chunk resolves *before* the autograd boundary, so
its backward recomputes at the chunk the forward ran. The rglru backward
does not depend on ``chunk`` or ``r_block``, so they pass through to
``rglru_scan``, which resolves them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import flash_attention_bwd as fa_bwd_kernel
from repro_torch.kernels import mlstm as mlstm_kernel
from repro_torch.kernels import rglru as rglru_kernel


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


# ------------------------------------------------------------------- rglru

class _Rglru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, b, h0, chunk, r_block):
        ctx.save_for_backward(log_a, b, h0)
        return rglru_kernel.rglru_scan(log_a, b, h0, chunk=chunk,
                                       r_block=r_block)

    @staticmethod
    def backward(ctx, g_h, g_last):
        log_a, b, h0 = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in (log_a, b, h0)]
        with torch.enable_grad():
            outs = rglru_kernel.rglru_reference(*leaves)
            grads = torch.autograd.grad(
                outs, [t for t in leaves if t is not None], (g_h, g_last))
        grads = iter(grads)
        return (*(None if t is None else next(grads) for t in leaves),
                None, None)


def rglru(log_a, b, h0, chunk=None, r_block=None):
    """log_a, b: (B, S, R); h0: (B, R) or None -> (h, h_last), fp32."""
    return _Rglru.apply(log_a, b, h0, chunk, r_block)


# ------------------------------------------------------------------- mlstm

class _Mlstm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, chunk):
        ctx.save_for_backward(q, k, v, i_gate, f_gate)
        ctx.chunk = chunk
        return mlstm_kernel.mlstm_chunkwise(q, k, v, i_gate, f_gate,
                                            chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            h = mlstm_kernel.mlstm_chunkwise_reference(
                *leaves, chunk=ctx.chunk)[0]
            grads = torch.autograd.grad(h, leaves, g)
        return (*grads, None)


def mlstm(q, k, v, i_gate, f_gate, chunk=None):
    """q, k, v: (B, S, H, D); gates: (B, S, H) -> h (B, S, H, D)."""
    return _Mlstm.apply(q, k, v, i_gate, f_gate,
                        mlstm_kernel.resolve_chunk(q, chunk))
