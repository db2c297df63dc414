"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

PyTorch counterpart of ``repro.models.xlstm``, with its names. The mLSTM
recurrence per head (head dim D):

    m_t = max(f~_t + m_{t-1}, i~_t)                     # stabilizer
    f'_t = exp(f~_t + m_{t-1} - m_t);  i'_t = exp(i~_t - m_t)
    C_t = f'_t C_{t-1} + i'_t v_t k_t^T                 # (D, D) matrix memory
    n_t = f'_t n_{t-1} + i'_t k_t
    h_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))

The sequence path is the reference's chunkwise-parallel form, run as
``kernels.mlstm.mlstm_chunkwise_reference`` (plain PyTorch, fp32 inside,
the carried state in and out). The reference's model calls its jnp
``mlstm_chunkwise`` (xlstm.py:211), never the mLSTM kernel (B4), and
neither does this one. The sLSTM keeps a scalar memory with recurrent
gates, so it is a loop over time, as the reference's ``lax.scan`` is.

As in the reference: the gate projection ``w_if`` is drawn in fp32 (and
cast like every other leaf in the model) and multiplies ``u`` in fp32;
``b_if`` is ``[0, linspace(3, 6, H)]``; the sLSTM's recurrent product runs
in the input's dtype and only its gates go to fp32; the sLSTM state starts
at ``m = -30`` with ``n`` floored at 1e-6, the mLSTM state at ``m = -1e30``;
the causal conv pads with zeros in u's dtype, sums in fp32 and keeps its
last ``conv_width - 1`` fp32 inputs as the decode state.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm import mlstm_chunkwise_reference
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self):
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self):
        return self.d_inner // self.n_heads


def init_mlstm(gen: torch.Generator, cfg: MLSTMConfig, dtype=torch.float32):
    d, di, H, D = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.head_dim
    dev = gen.device
    return {
        "w_up": layers.dense_init(gen, (d, di), dtype=dtype),
        "w_gate": layers.dense_init(gen, (d, di), dtype=dtype),
        "conv_w": layers.dense_init(gen, (cfg.conv_width, di),
                                    in_axis_size=cfg.conv_width, dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": layers.dense_init(gen, (di, H, D), in_axis_size=di,
                                dtype=dtype),
        "wk": layers.dense_init(gen, (di, H, D), in_axis_size=di,
                                dtype=dtype),
        "wv": layers.dense_init(gen, (di, H, D), in_axis_size=di,
                                dtype=dtype),
        "w_if": layers.dense_init(gen, (di, H, 2), in_axis_size=di,
                                  dtype=torch.float32),
        "b_if": torch.stack(
            [torch.zeros((H,), device=dev),
             torch.linspace(3.0, 6.0, H, device=dev)], dim=-1),
        "out_norm": layers.init_rmsnorm(D, dtype, dev),
        "w_down": layers.dense_init(gen, (di, d), in_axis_size=di,
                                    dtype=dtype),
    }


def mlstm_parallel(q, k, v, i_gate, f_gate):
    """Stabilized quadratic parallel form for one chunk.

    q, k, v: (B, S, H, D); i_gate, f_gate: (B, S, H) pre-activations.
    Returns h (B, S, H, D) fp32 and the chunk's final state pieces
    (C_last (B, H, D, D), n_last (B, H, D), m_last (B, H)).
    """
    B, S, H, D = q.shape
    ig = i_gate.float()
    logf = F.logsigmoid(f_gate.float())                         # (B,S,H)
    Fc = torch.cumsum(logf, dim=1)
    logw = Fc[:, :, None, :] - Fc[:, None, :, :] + ig[:, None]  # (B,s,t,H)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=q.device))
    logw = logw.masked_fill(~causal[None, :, :, None], float("-inf"))
    m = logw.amax(dim=2).clamp(min=-1e30)                       # (B,S,H)
    w = torch.exp(logw - m[:, :, None, :])
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bshd,bthd->bsth", q.float(), k.float()) * scale
    a = scores * w
    num = torch.einsum("bsth,bthd->bshd", a, v.float())
    den = a.sum(dim=2).abs()
    h = num / torch.maximum(den, torch.exp(-m))[..., None]

    tail = Fc[:, -1:, :] - Fc + ig                               # F_S - F_t + i
    m_last = tail.amax(dim=1)                                    # (B,H)
    wS = torch.exp(tail - m_last[:, None])
    ks = k.float() * scale
    C_last = torch.einsum("bthd,bthe->bhde", wS[..., None] * v.float(), ks)
    n_last = torch.einsum("bth,bthd->bhd", wS, ks)
    return h, (C_last, n_last, m_last)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=256, state=None):
    """Chunkwise-parallel mLSTM over (B, S, H, D): (h in q's dtype, final
    state (C, n, m) fp32). ``state``: optional (C (B,H,D,D), n (B,H,D),
    m (B,H)) fp32 carry. ``kernels.mlstm.mlstm_chunkwise_reference``."""
    return mlstm_chunkwise_reference(q, k, v, i_gate, f_gate, chunk=chunk,
                                     state=state)


def mlstm_decode_step(q, k, v, i_gate, f_gate, state):
    """One-token recurrent step. q, k, v: (B, H, D); gates: (B, H)."""
    C, n, m = state
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    logf = F.logsigmoid(f_gate.float())
    ig = i_gate.float()
    m_new = torch.maximum(logf + m, ig)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(ig - m_new)
    kf = k.float() * scale
    C_new = fw[..., None, None] * C + iw[..., None, None] * (
        v.float()[..., :, None] * kf[..., None, :])
    n_new = fw[..., None] * n + iw[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhde,bhe->bhd", C_new, qf)
    den = torch.einsum("bhd,bhd->bh", n_new, qf)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


def _mlstm_qkv(params, u, cfg: MLSTMConfig):
    q = layers._proj(u, params["wq"])
    k = layers._proj(u, params["wk"])
    v = layers._proj(u, params["wv"])
    gates = (layers._proj(u.float(), params["w_if"].float())
             + params["b_if"].float())
    return q, k, v, gates[..., 0], gates[..., 1]


def apply_mlstm(params, x, cfg: MLSTMConfig):
    """Full-sequence mLSTM block. x: (B, S, d)."""
    B, S, d = x.shape
    u = x @ params["w_up"]
    gate = x @ params["w_gate"]
    u, _ = _conv(params, u, cfg)
    u = F.silu(u)
    q, k, v, ig, fg = _mlstm_qkv(params, u, cfg)
    h, _ = mlstm_chunkwise(q, k, v, ig, fg, chunk=min(cfg.chunk, S))
    h = layers.rmsnorm(params["out_norm"], h)
    h = h.reshape(B, S, cfg.d_inner)
    return (h * F.silu(gate)) @ params["w_down"]


def apply_mlstm_decode(params, x, cfg: MLSTMConfig, state):
    """x: (B, 1, d); state {"C", "n", "m", "conv"} -> (out, new state, the
    conv state in its own dtype)."""
    u = x @ params["w_up"]
    gate = x @ params["w_gate"]
    u, conv_state = _conv(params, u, cfg, state["conv"])
    u = F.silu(u)
    q, k, v, ig, fg = _mlstm_qkv(params, u, cfg)
    h, (C, n, m) = mlstm_decode_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                     fg[:, 0],
                                     (state["C"], state["n"], state["m"]))
    h = layers.rmsnorm(params["out_norm"], h)[:, None]
    h = h.reshape(x.shape[0], 1, cfg.d_inner)
    out = (h * F.silu(gate)) @ params["w_down"]
    return out, {"C": C, "n": n, "m": m,
                 "conv": conv_state.to(state["conv"].dtype)}


def _conv(params, u, cfg: MLSTMConfig, conv_state=None):
    """Depthwise causal conv in fp32. u: (B, S, di) -> (out in u's dtype,
    the last conv_width - 1 inputs in fp32)."""
    w = params["conv_w"].float()
    width = cfg.conv_width
    if conv_state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                          dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1).float()
    S = u.shape[1]
    out = sum(w[i] * up[:, i:i + S] for i in range(width))
    return ((out + params["conv_b"].float()).to(u.dtype),
            up[:, -(width - 1):])


def init_mlstm_state(cfg: MLSTMConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    H, D = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, D, D), **f32),
            "n": torch.zeros((batch, H, D), **f32),
            "m": torch.full((batch, H), -1e30, **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent gates -> a loop over time)
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: MLSTMConfig, dtype=torch.float32):
    d, di = cfg.d_model, cfg.d_inner
    dev = gen.device
    return {
        "w_in": layers.dense_init(gen, (d, 4 * di), dtype=dtype),
        "w_rec": layers.dense_init(gen, (di, 4 * di), dtype=dtype),
        "b": torch.zeros((4 * di,), dtype=dtype, device=dev),
        "out_norm": layers.init_rmsnorm(di, dtype, dev),
        "w_down": layers.dense_init(gen, (di, d), in_axis_size=di,
                                    dtype=dtype),
    }


def slstm_steps(params, zx, state):
    """The sLSTM's loop over time. zx: (B, S, 4 di) input pre-activations
    -> (hs (B, S, di) fp32, final (c, n, h, m))."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    w_rec = params["w_rec"]
    hs = []
    for z_t in zx.unbind(1):
        z = z_t + h.to(z_t.dtype) @ w_rec
        zi, zf, zz, zo = z.float().chunk(4, dim=-1)
        logf_m = F.logsigmoid(zf) + m
        m_new = torch.maximum(logf_m, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(logf_m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def apply_slstm(params, x, cfg: MLSTMConfig, state=None):
    """Sequential sLSTM with exponential gating. x: (B, S, d) -> (out,
    new state {"c", "n", "h", "m"} fp32)."""
    B = x.shape[0]
    zx = x @ params["w_in"] + params["b"]
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    hs, carry = slstm_steps(params, zx, state)
    hs = layers.rmsnorm(params["out_norm"], hs.to(x.dtype))
    out = hs @ params["w_down"]
    return out, dict(zip(("c", "n", "h", "m"), carry))


def init_slstm_state(cfg: MLSTMConfig, batch: int, device=None):
    di = cfg.d_inner
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **f32),
            "n": torch.zeros((batch, di), **f32),
            "h": torch.zeros((batch, di), **f32),
            "m": torch.full((batch, di), -30.0, **f32)}
