"""Griffin/RecurrentGemma-style recurrent block: temporal conv + RG-LRU.

PyTorch counterpart of ``repro.models.recurrent``, with its names:

    r_t = sigmoid(W_a x_t + b_a)                      # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)                      # input gate
    log a_t = -c * softplus(Lambda) * r_t             # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence path is the reference's associative scan, run as
``kernels.rglru.rglru_reference`` (the same combine in Hillis-Steele form,
plain PyTorch): the reference's model never calls the RG-LRU kernel (B5),
and neither does this one. Decode is one step carrying (h, conv state).
As in the reference: the gates and the scan run in fp32 whatever the
compute dtype, ``Lambda`` is drawn in fp32, GELU is the tanh approximation
(``jax.nn.gelu``'s default), and exp is taken in float64 on the CPU
(``kernels.rglru.exp_cpu_f64``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import exp_cpu_f64, rglru_reference
from repro_torch.models import layers

RG_LRU_C = 8.0
CONV_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    d_model: int
    d_rnn: int


def init_recurrent(gen: torch.Generator, cfg: RecurrentConfig,
                   dtype=torch.float32):
    d, r = cfg.d_model, cfg.d_rnn
    dev = gen.device
    return {
        "w_in_x": layers.dense_init(gen, (d, r), dtype=dtype),
        "w_in_gate": layers.dense_init(gen, (d, r), dtype=dtype),
        "conv_w": layers.dense_init(gen, (CONV_WIDTH, r),
                                    in_axis_size=CONV_WIDTH, dtype=dtype),
        "conv_b": torch.zeros((r,), dtype=dtype, device=dev),
        "w_a": layers.dense_init(gen, (r, r), dtype=dtype),
        "b_a": torch.zeros((r,), dtype=dtype, device=dev),
        "w_x": layers.dense_init(gen, (r, r), dtype=dtype),
        "b_x": torch.zeros((r,), dtype=dtype, device=dev),
        # Lambda ~ U[2, 6] in fp32 whatever dtype is, as the reference
        "Lambda": torch.rand((r,), generator=gen, dtype=torch.float32,
                             device=dev) * 4.0 + 2.0,
        "w_out": layers.dense_init(gen, (r, d), in_axis_size=r, dtype=dtype),
    }


def _gates(params, x):
    """x: (..., r) post-conv activations -> (log_a, gated input) in fp32.

    softplus(Lambda) and its product with -c stay in Lambda's dtype (bf16
    in a bf16 forward), as in the reference."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"].float())
    log_a = -RG_LRU_C * F.softplus(params["Lambda"]) * r
    a2 = exp_cpu_f64(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, b


def rglru_scan(params, x, h0=None):
    """The linear-recurrence scan. x: (B, S, r) -> (h (B, S, r) in x's
    dtype, h_last (B, r) fp32); h0 (B, r) is folded into the first step."""
    log_a, b = _gates(params, x)
    h, h_last = rglru_reference(log_a, b, h0)
    return h.to(x.dtype), h_last


def rglru_step(params, x_t, h_prev):
    """One decode step. x_t: (B, r), h_prev: (B, r) fp32 -> (h in x_t's
    dtype, h fp32)."""
    log_a, b = _gates(params, x_t)
    h = exp_cpu_f64(log_a) * h_prev + b
    return h.to(x_t.dtype), h


def _causal_conv(params, x, conv_state=None):
    """Depthwise width-4 causal conv in fp32. x: (B, S, r) -> (out in x's
    dtype, the last CONV_WIDTH - 1 inputs in fp32: the new state)."""
    w = params["conv_w"].float()                       # (W, r)
    if conv_state is None:
        pad = torch.zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)                   # (B, W-1, r)
    xp = torch.cat([pad, x], dim=1).float()
    S = x.shape[1]
    out = sum(w[i] * xp[:, i:i + S] for i in range(CONV_WIDTH))
    new_state = xp[:, -(CONV_WIDTH - 1):]
    return (out + params["conv_b"].float()).to(x.dtype), new_state


def apply_recurrent(params, x, cfg: RecurrentConfig):
    """Full-sequence recurrent block. x: (B, S, d) -> (B, S, d)."""
    gate = F.gelu(x @ params["w_in_gate"], approximate="tanh")
    u = x @ params["w_in_x"]
    u, _ = _causal_conv(params, u)
    h, _ = rglru_scan(params, u)
    return (h * gate) @ params["w_out"]


def apply_recurrent_decode(params, x, cfg: RecurrentConfig, state):
    """x: (B, 1, d); state: {"h": (B, r) fp32, "conv": (B, W-1, r)} ->
    (out (B, 1, d), new state, the conv state in its own dtype)."""
    gate = F.gelu(x @ params["w_in_gate"], approximate="tanh")
    u = x @ params["w_in_x"]
    u, conv_state = _causal_conv(params, u, state["conv"])
    h_t, h_new = rglru_step(params, u[:, 0], state["h"])
    out = (h_t[:, None] * gate) @ params["w_out"]
    return out, {"h": h_new, "conv": conv_state.to(state["conv"].dtype)}


def init_recurrent_state(cfg: RecurrentConfig, batch: int,
                         dtype=torch.bfloat16, device=None):
    return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.d_rnn),
                                dtype=dtype, device=device)}
