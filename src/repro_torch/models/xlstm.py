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

On DTensors (the sharded step) the rules of ``distributed.sharding``
place the leaves, and the cells follow them:

* mLSTM: u and the gate come out of column-split ``w_up``/``w_gate``
  split on d_inner, so the conv and the SiLU run on each rank's channels.
  ``wq``/``wk``/``wv`` and ``w_if`` contract that split dim, so q, k, v and
  the gates are partial sums, each reduced once (``spmd.contract``). H = 4
  heads do not divide "model": the chunkwise form and the per-head norm
  run on each rank's own batch rows, the same on every model rank. Each
  rank gates its own d_inner columns of h, and ``w_down`` is
  row-parallel. Decode takes C (B, H, D, D) split on its last dim and n
  (B, H, D) on D, as ``cache_specs`` places them: C q and n . q are
  partial sums over "model", reduced once a step.
* sLSTM: ``w_in``, ``w_rec`` and ``b`` are column-split, and a rank's
  contiguous columns of the 4 d_inner pre-activations do not hold the
  four gates of the same channels. So each time step gathers z whole over
  "model" (``spmd.gather_last``) and every rank computes c, n, h and m
  whole: one all-gather of (rows, 4 d_inner) a step, and h is whole for
  the next step's ``h @ w_rec``. The loop runs in one ``spmd.local_apply``
  on local tensors. Its output is each rank's own d_inner columns of the
  normed h (the norm taken over the whole row), which the row-parallel
  ``w_down`` contracts; a decode state keeps ``cache_specs``' layout (c
  and m whole, n and h split on d_inner).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch import spmd
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


def _chunkwise_h(q, k, v, i_gate, f_gate, chunk):
    """``mlstm_chunkwise``'s h; on DTensors on each rank's own batch rows
    (every other split gathered)."""
    if not spmd.is_dtensor(q):
        return mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=chunk)[0]
    pl = spmd.rows_only(q.placements)
    return spmd.local_apply(
        lambda *a: mlstm_chunkwise(*a, chunk=chunk)[0],
        (q, k, v, i_gate, f_gate), (pl,) * 5, pl, q.shape)


def mlstm_decode_step(q, k, v, i_gate, f_gate, state):
    """One-token recurrent step. q, k, v: (B, H, D); gates: (B, H)."""
    C, n, m, num, den = _decode_update(q, k, v, i_gate, f_gate, *state,
                                       scale=1.0 / math.sqrt(q.shape[-1]))
    return _decode_h(num, den, m, q.dtype), (C, n, m)


def _decode_update(q, k, v, i_gate, f_gate, C, n, m, scale):
    """The decode step's new state and C q, n . q (sums over the columns
    of C and n that q and k here hold)."""
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
    return C_new, n_new, m_new, num, den


def _decode_h(num, den, m, dtype):
    return (num / torch.maximum(den.abs(), torch.exp(-m))[..., None]).to(
        dtype)


def _mlstm_qkv(params, u, cfg: MLSTMConfig):
    q = layers._proj(u, params["wq"])
    k = layers._proj(u, params["wk"])
    v = layers._proj(u, params["wv"])
    gates = layers._proj(u.float(), params["w_if"].float())
    if not spmd.is_dtensor(gates):
        return (q, k, v) + _split_gates(gates, params["b_if"])
    pl, b_if = gates.placements, params["b_if"]
    return (q, k, v) + spmd.local_apply(
        _split_gates, (gates, b_if),
        (pl, (Replicate(),) * b_if.device_mesh.ndim), (pl, pl),
        (gates.shape[:-1],) * 2)


def _split_gates(gates, b_if):
    gates = gates + b_if.float()
    return gates[..., 0], gates[..., 1]


def _conv_silu(params, u, cfg: MLSTMConfig, conv_state=None):
    """silu(conv(u)) and the conv's new state (in ``conv_state``'s dtype,
    fp32 without one); on DTensors on each rank's own channels, the state
    placed as ``conv_state`` (as u without one)."""
    def run(a, w, b, *cs):
        out, new = _conv({"conv_w": w, "conv_b": b}, a, cfg,
                         cs[0] if cs else None)
        return F.silu(out), new.to(cs[0].dtype) if cs else new
    if not spmd.is_dtensor(u):
        return run(u, params["conv_w"], params["conv_b"],
                   *(() if conv_state is None else (conv_state,)))
    pl = u.placements if conv_state is None else conv_state.placements
    u = spmd.placed(u, pl)
    ch, cols = spmd.channels(pl, 3), spmd.channels(pl, 3, dim=1)
    width = cfg.conv_width - 1
    state = () if conv_state is None else (conv_state,)
    return spmd.local_apply(
        run, (u, params["conv_w"], params["conv_b"], *state),
        (pl, cols, ch) + (pl,) * len(state), (pl, pl),
        (u.shape, u.shape[:1] + (width,) + u.shape[2:]))


def _gated(h, gate):
    """h (..., d_inner as (H, D) or whole) flattened to the gate's shape,
    times silu(gate). On DTensors each rank gates its own columns of the
    gate's split (h, whole over "model", is cut to them)."""
    if not spmd.is_dtensor(h):
        return h.reshape(gate.shape) * F.silu(gate)
    pl = gate.placements
    lo, n = spmd.piece(gate.device_mesh, pl, gate.shape[-1], gate.ndim - 1)

    def run(a, g):
        a = a.reshape(g.shape[:-1] + (-1,))[..., lo:lo + n]
        return a * F.silu(g)
    return spmd.local_apply(run, (h, gate), (spmd.rows_only(pl), pl), pl,
                            gate.shape)


def apply_mlstm(params, x, cfg: MLSTMConfig):
    """Full-sequence mLSTM block. x: (B, S, d)."""
    S = x.shape[1]
    u = spmd.contract(x, params["w_up"], 1)
    gate = spmd.contract(x, params["w_gate"], 1)
    u, _ = _conv_silu(params, u, cfg)
    q, k, v, ig, fg = _mlstm_qkv(params, u, cfg)
    h = _chunkwise_h(q, k, v, ig, fg, min(cfg.chunk, S))
    h = layers.rmsnorm(params["out_norm"], h)
    return spmd.contract(_gated(h, gate), params["w_down"], 1)


def _decode_sharded(q, k, v, ig, fg, state):
    """``mlstm_decode_step`` on DTensors q, k, v (B, H, D) and gates (B, H),
    replicated over "model", with C split on its last dim and n on D:
    each rank updates its own columns of C and n, and C q and n . q are
    partial sums reduced once. The state keeps its placements."""
    C, n, m = state
    qp, part = [], []
    for p in C.placements:
        qp.append(Shard(2) if p.is_shard(3) else
                  (Shard(0) if p.is_shard(0) else Replicate()))
        part.append(Partial() if p.is_shard(3) else qp[-1])
    rows = spmd.rows_only(qp)
    scale = 1.0 / math.sqrt(q.shape[-1])
    C, n, m, num, den = spmd.local_apply(
        lambda *a: _decode_update(*a, scale=scale),
        (q, k, v, ig, fg, C, n, m),
        (qp, qp, rows, rows, rows, C.placements, n.placements,
         m.placements),
        (C.placements, n.placements, m.placements, part, part),
        (C.shape, n.shape, m.shape, q.shape, q.shape[:-1]))
    num, den = spmd.resolved(num), spmd.resolved(den)
    h = spmd.local_apply(lambda *a: _decode_h(*a, q.dtype), (num, den, m),
                         (rows, rows, rows), rows, q.shape)
    return h, (C, n, m)


def apply_mlstm_decode(params, x, cfg: MLSTMConfig, state):
    """x: (B, 1, d); state {"C", "n", "m", "conv"} -> (out, new state, the
    conv state in its own dtype)."""
    u = spmd.contract(x, params["w_up"], 1)
    gate = spmd.contract(x, params["w_gate"], 1)
    u, conv_state = _conv_silu(params, u, cfg, state["conv"])
    q, k, v, ig, fg = _mlstm_qkv(params, u, cfg)
    args = (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
            (state["C"], state["n"], state["m"]))
    if spmd.is_dtensor(q):
        h, (C, n, m) = _decode_sharded(*args)
    else:
        h, (C, n, m) = mlstm_decode_step(*args)
    h = layers.rmsnorm(params["out_norm"], h)
    out = spmd.contract(_gated(h, gate), params["w_down"], 1)
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


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


def _gather_gates(z, mesh, mesh_dim, size):
    """A rank's columns of the pre-activations z made whole (one
    all-gather; ``spmd.gather_last``)."""
    return spmd.gather_last(z, mesh, mesh_dim, size)


def slstm_steps(params, zx, state, whole=None):
    """The sLSTM's loop over time. zx: (B, S, 4 di) input pre-activations
    -> (hs (B, S, di) fp32, final (c, n, h, m)). ``whole``, where given,
    makes each step's z whole (a rank's columns of a sharded step, whose
    ``w_rec`` holds the same columns)."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    w_rec = params["w_rec"]
    hs = []
    for z_t in zx.unbind(1):
        z = z_t + h.to(z_t.dtype) @ w_rec
        if whole is not None:
            z = whole(z)
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


_SLSTM_STATE = ("c", "n", "h", "m")


def apply_slstm(params, x, cfg: MLSTMConfig, state=None):
    """Sequential sLSTM with exponential gating. x: (B, S, d) -> (out,
    new state {"c", "n", "h", "m"} fp32)."""
    B = x.shape[0]
    zx = spmd.contract(x, params["w_in"], 1)
    if spmd.is_dtensor(zx):
        hs, new = _slstm_sharded(params, zx, cfg, state, x.dtype)
        return spmd.contract(hs, params["w_down"], 1), new
    zx = zx + params["b"]
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    hs, carry = slstm_steps(params, zx, state)
    hs = layers.rmsnorm(params["out_norm"], hs.to(x.dtype))
    out = spmd.contract(hs, params["w_down"], 1)
    return out, dict(zip(_SLSTM_STATE, carry))


def _slstm_sharded(params, zx, cfg: MLSTMConfig, state, dtype):
    """The sLSTM on DTensor pre-activations zx (B, S, 4 di), its columns
    split as ``w_in``'s: (the normed hs (B, S, di) of each rank's own
    columns, the final state). The time loop runs in one ``local_apply``
    on local tensors; each step gathers z over "model"
    (``_gather_gates``). ``state`` (c, m whole; n, h split on di, as
    ``cache_specs`` places them) is gathered whole once and comes back in
    its placements; without it the state starts at ``init_slstm_state``'s
    values and c, m come back whole, n, h split as hs."""
    mesh, pl = zx.device_mesh, zx.placements
    mesh_dim, size = spmd.channel_group(zx, 2)
    di = cfg.d_inner
    rows = spmd.rows_only(pl)
    split = tuple(Shard(1) if p.is_shard(2) else r for p, r in zip(pl, rows))
    if state is None:
        st, st_pl = (), {"c": rows, "n": split, "h": split, "m": rows}
    else:
        st = tuple(state[k] for k in _SLSTM_STATE)
        st_pl = {k: state[k].placements for k in _SLSTM_STATE}
    hs_pl = tuple(Shard(2) if p.is_shard(2) else r for p, r in zip(pl, rows))
    cut = {k: spmd.piece(mesh, st_pl[k], di, 1) for k in _SLSTM_STATE}
    cut["hs"] = spmd.piece(mesh, hs_pl, di, 2)

    def loop(z, b, w_rec, scale, *carry):
        z = z + b
        if carry:
            carry = dict(zip(_SLSTM_STATE, carry))
        else:
            carry = init_slstm_state(cfg, z.shape[0], device=z.device)
        hs, out = slstm_steps(
            {"w_rec": w_rec}, z, carry,
            whole=lambda t: _gather_gates(t, mesh, mesh_dim, size))
        hs = layers.rmsnorm({"scale": scale}, hs.to(dtype))
        lo, n = cut["hs"]
        res = [hs[..., lo:lo + n]]
        for k, t in zip(_SLSTM_STATE, out):
            lo, n = cut[k]
            res.append(t[:, lo:lo + n])
        return tuple(res)
    out_shape = (zx.shape[0], di)
    outs = spmd.local_apply(
        loop, (zx, params["b"], params["w_rec"], params["out_norm"]["scale"],
               *st),
        (pl, spmd.channels(pl, 3), spmd.channels(pl, 3, dim=1),
         (Replicate(),) * mesh.ndim) + tuple(spmd.rows_only(st_pl[k])
                                      for k in _SLSTM_STATE[:len(st)]),
        (hs_pl,) + tuple(st_pl[k] for k in _SLSTM_STATE),
        (tuple(zx.shape[:2]) + (di,),) + (out_shape,) * 4)
    return outs[0], dict(zip(_SLSTM_STATE, outs[1:]))


def init_slstm_state(cfg: MLSTMConfig, batch: int, device=None):
    di = cfg.d_inner
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **f32),
            "n": torch.zeros((batch, di), **f32),
            "h": torch.zeros((batch, di), **f32),
            "m": torch.full((batch, di), -30.0, **f32)}
