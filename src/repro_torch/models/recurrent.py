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

On DTensors (the sharded step) the rules of ``distributed.sharding`` split
the channels r over "model": ``w_in_x``/``w_in_gate`` are column-split, so
u and the gate arrive split on r; the conv and the scan run on each rank's
own channels (channels are independent); W_a and W_x keep their output
columns split, so the conv's output is gathered over "model" once a call
and each rank computes its own columns of the gates; ``w_out`` is
row-parallel, one partial sum reduced once (``spmd.contract``). A decode
state arrives split on r as ``cache_specs`` places it and leaves so.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import spmd
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


def _gates(params, x, x_own=None):
    """x: (..., r) post-conv activations -> (log_a, gated input) in fp32.

    softplus(Lambda) and its product with -c stay in Lambda's dtype (bf16
    in a bf16 forward), as in the reference. On a rank of the sharded step
    W_a, W_x, the biases and Lambda hold the rank's own output channels, x
    the whole r and ``x_own`` the rank's own channels of it (default x)."""
    xf = x.float()
    xo = xf if x_own is None or x_own is x else x_own.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"].float())
    log_a = -RG_LRU_C * F.softplus(params["Lambda"]) * r
    a2 = exp_cpu_f64(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xo)
    return log_a, b


def rglru_scan(params, x, h0=None, x_own=None):
    """The linear-recurrence scan. x: (B, S, r) -> (h (B, S, r) in x's
    dtype, h_last (B, r) fp32); h0 is folded into the first step. With
    ``x_own`` (``_gates``) h is of its channels."""
    log_a, b = _gates(params, x, x_own)
    h, h_last = rglru_reference(log_a, b, h0)
    return h.to(x.dtype), h_last


def rglru_step(params, x_t, h_prev, x_own=None):
    """One decode step. x_t: (B, r), h_prev: (B, r) fp32 -> (h in x_t's
    dtype, h fp32)."""
    log_a, b = _gates(params, x_t, x_own)
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


_GATE_LEAVES = ("w_a", "b_a", "w_x", "b_x", "Lambda")


def _split(params, pl):
    """(the leaves the conv and the gates take, their placements) against
    activations (B, S, r) placed ``pl``: per-channel vectors and the
    conv's (W, r) split as the channels, W_a/W_x (r, r) by output
    column."""
    ch = spmd.channels(pl, 3)
    cols = spmd.channels(pl, 3, dim=1)
    names = ("conv_w", "conv_b") + _GATE_LEAVES
    return ([params[n] for n in names],
            [cols if n in ("conv_w", "w_a", "w_x") else ch for n in names])


def _local(leaves):
    return dict(zip(("conv_w", "conv_b") + _GATE_LEAVES, leaves))


def _own(x, pl):
    """A function of a rank's local x whole over r: (x, its own channels
    as ``pl`` splits them). Whole on one rank: x itself, so the gradient
    meets in one tensor, as the plain path's."""
    lo, n = spmd.piece(x.device_mesh, pl, x.shape[-1], x.ndim - 1)
    return lambda t: t if n == t.shape[-1] else t[..., lo:lo + n]


def _mix_sharded(params, u, gate):
    """h * gelu(gate) of the sequence path on DTensors u, gate (B, S, r):
    the conv on each rank's channels, its output gathered over "model",
    the gates and the scan on the rank's own channels."""
    pl = u.placements
    leaves, lpl = _split(params, pl)
    cu = spmd.local_apply(
        lambda a, *w: _causal_conv(_local(w), a)[0], (u, *leaves[:2]),
        (pl, *lpl[:2]), pl, u.shape)

    own = _own(cu, pl)

    def mix(whole, g, *w):
        h, _ = rglru_scan(_local((None, None) + w), whole, x_own=own(whole))
        return h * F.gelu(g, approximate="tanh")
    return spmd.local_apply(mix, (cu, gate, *leaves[2:]),
                            (spmd.rows_only(pl), pl, *lpl[2:]), pl, u.shape)


def apply_recurrent(params, x, cfg: RecurrentConfig):
    """Full-sequence recurrent block. x: (B, S, d) -> (B, S, d)."""
    gate = spmd.contract(x, params["w_in_gate"], 1)
    u = spmd.contract(x, params["w_in_x"], 1)
    if spmd.is_dtensor(u):
        y = _mix_sharded(params, u, spmd.placed(gate, u.placements))
    else:
        gate = F.gelu(gate, approximate="tanh")
        u, _ = _causal_conv(params, u)
        h, _ = rglru_scan(params, u)
        y = h * gate
    return spmd.contract(y, params["w_out"], 1)


def _decode_sharded(params, u, gate, state):
    """One token on DTensors: u, gate (B, 1, r) and the state ("h" (B, r),
    "conv" (B, W-1, r)) split as ``cache_specs`` split the state ->
    (h * gelu(gate) (B, 1, r), the new state placed as the old)."""
    pl = state["conv"].placements
    u, gate = spmd.placed(u, pl), spmd.placed(gate, pl)
    leaves, lpl = _split(params, pl)
    conv_dtype = state["conv"].dtype

    def conv(a, cs, *w):
        out, new = _causal_conv(_local(w), a, cs)
        return out, new.to(conv_dtype)
    cu, conv_state = spmd.local_apply(
        conv, (u, state["conv"], *leaves[:2]), (pl, pl, *lpl[:2]),
        (pl, pl), (u.shape, state["conv"].shape))

    own = _own(cu, pl)

    def step(whole, g, h_prev, *w):
        h_t, h_new = rglru_step(_local((None, None) + w), whole[:, 0],
                                h_prev, x_own=own(whole)[:, 0])
        return h_t[:, None] * F.gelu(g, approximate="tanh"), h_new
    hp = state["h"].placements
    y, h_new = spmd.local_apply(
        step, (cu, gate, state["h"], *leaves[2:]),
        (spmd.rows_only(pl), pl, hp, *lpl[2:]), (pl, hp),
        (u.shape, state["h"].shape))
    return y, {"h": h_new, "conv": conv_state}


def apply_recurrent_decode(params, x, cfg: RecurrentConfig, state):
    """x: (B, 1, d); state: {"h": (B, r) fp32, "conv": (B, W-1, r)} ->
    (out (B, 1, d), new state, the conv state in its own dtype)."""
    gate = spmd.contract(x, params["w_in_gate"], 1)
    u = spmd.contract(x, params["w_in_x"], 1)
    if spmd.is_dtensor(u):
        y, new = _decode_sharded(params, u, gate, state)
        return spmd.contract(y, params["w_out"], 1), new
    gate = F.gelu(gate, approximate="tanh")
    u, conv_state = _causal_conv(params, u, state["conv"])
    h_t, h_new = rglru_step(params, u[:, 0], state["h"])
    out = spmd.contract(h_t[:, None] * gate, params["w_out"], 1)
    return out, {"h": h_new, "conv": conv_state.to(state["conv"].dtype)}


def init_recurrent_state(cfg: RecurrentConfig, batch: int,
                         dtype=torch.bfloat16, device=None):
    return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, cfg.d_rnn),
                                dtype=dtype, device=device)}
