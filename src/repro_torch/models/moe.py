"""Mixture-of-Experts FFN: top-k router, routed SwiGLU experts, shared experts.

PyTorch counterpart of ``repro.models.moe``: the same function in both
dispatch modes, with the same parameters and dtype points.

* ``dropless=True`` (the model default, ``ModelConfig.moe_cfg``): capacity
  is the token count T, so no (token, choice) pair is dropped and the FFN
  stays a per-token function.
* ``dropless=False``: capacity C = ceil(top_k * T * capacity_factor / E)
  per batch row and expert. Within a row, pairs claim their expert's slots
  in (token, choice) order and the ones past C are dropped (the residual
  carries the token).

The reference dispatches through one-hot einsums into (B, E, C, d) buffers
and combines through a (B, T, E, C) fp32 tensor, so its expert products
cover E * C rows per batch row where only top_k * T are live. Here each
expert gathers just its kept (row, token, choice) entries, runs its SwiGLU
on them with ``torch.matmul``, and the weighted outputs are scatter-added in
fp32: the same sums, in another order. The expert products run in x's
dtype, the combine and the shared branch are added in fp32, and the result
is cast back to x's dtype, as in the reference. There is no kernel here:
the reference computes these products outside any Pallas kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import Partial, Replicate

from repro_torch import spmd
from repro_torch.models import layers

TOKEN_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-active shared experts (qwen2-moe: 4)
    shared_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dropless: bool = False       # capacity = T: exact per-token routing


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32):
    """The router stays fp32 whatever ``dtype`` is, as in the reference."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": layers.dense_init(gen, (d, E), dtype=torch.float32),
        "w_gate": layers.dense_init(gen, (E, d, f), in_axis_size=d,
                                    dtype=dtype),
        "w_up": layers.dense_init(gen, (E, d, f), in_axis_size=d,
                                  dtype=dtype),
        "w_down": layers.dense_init(gen, (E, f, d), in_axis_size=f,
                                    dtype=dtype),
    }
    if cfg.n_shared:
        p["shared"] = layers.init_swiglu(gen, d, shared_d_ff(cfg), dtype)
    return p


def shared_d_ff(cfg: MoEConfig) -> int:
    return cfg.shared_d_ff or cfg.d_ff * cfg.n_shared


def _top_k_gating(logits, cfg: MoEConfig):
    """logits (B, T, E) fp32 -> (weights (B, T, k), indices (B, T, k), aux
    (B,)), each batch row gated on its own as the reference's vmap does."""
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    # load-balance aux loss (Switch): E * sum_e f_e * P_e, per row
    B, T, E = logits.shape
    counts = torch.zeros((B, E), dtype=torch.float32, device=logits.device)
    counts.scatter_add_(1, idx.reshape(B, -1),
                        torch.ones((B, T * cfg.top_k), device=logits.device))
    f_e = counts / (T * cfg.top_k)
    p_e = probs.mean(dim=1)
    aux = cfg.n_experts * (f_e * p_e).sum(-1)
    return weights, idx, aux


def _expert(params, e, x):
    g = x @ params["w_gate"][e]
    u = x @ params["w_up"][e]
    return (F.silu(g) * u) @ params["w_down"][e]


def _balanced_entries(n: int, E: int, cap: int, dev):
    """The dry-run's routing on meta tensors, where the router's choices
    have no values: a balanced router's. The n (row, token, choice) entries
    spread evenly over the E experts (the first n % E one more), each
    expert keeping at most ``cap`` = B * C of them: expert e keeps entries
    e, e + E, e + 2E, ... Returns (the kept entries, grouped by expert, on
    ``dev``; the kept count per expert).

    This models the work of routed rows. It is not the reference's count,
    whose one-hot einsums cover all E * C capacity slots of every row."""
    per_expert = [min(cap, n // E + (e < n % E)) for e in range(E)]
    return (torch.cat([torch.arange(e, e + E * c, E, device=dev)
                       for e, c in enumerate(per_expert)]), per_expert)


def balanced_route(idx, B: int, T: int, k: int, E: int, C: int):
    """``_route``'s result for a balanced router, whatever ``idx`` holds
    (``_balanced_entries``): what the dry-run routes on meta tensors, and
    what a run on the card puts in place of ``_route`` to hold its memory
    against the dry-run's."""
    return _balanced_entries(B * T * k, E, B * C, idx.device)


def _route(idx, B: int, T: int, k: int, E: int, C: int):
    """(the kept (row, token, choice) entries, grouped by expert, as flat
    indices into ``idx`` (B, T, k); the kept count per expert, a list).

    Entries in the reference's order, grouped by expert and then by row by
    a stable sort; an entry's slot in its (expert, row) buffer is its rank
    within that group, and slots past C are dropped. On meta tensors the
    routing is a balanced router's (``balanced_route``)."""
    n, dev = B * T * k, idx.device
    if dev.type == "meta":
        return balanced_route(idx, B, T, k, E, C)
    e_of = idx.reshape(n)
    row_of = torch.arange(B, device=dev).repeat_interleave(T * k)
    group = e_of * B + row_of
    order = torch.sort(group, stable=True).indices
    sizes = torch.bincount(group, minlength=E * B)
    starts = sizes.cumsum(0) - sizes
    slot = torch.arange(n, device=dev) - starts[group[order]]
    kept = order[slot < C]
    return kept, torch.bincount(e_of[kept], minlength=E).tolist()


def _n_segments(S: int, token_chunk: int) -> int:
    """The routing segments of a sequence of S tokens: ``token_chunk``
    ones where S is longer and a multiple of it, else one."""
    return S // token_chunk if S > token_chunk and S % token_chunk == 0 \
        else 1


def _segments(x, token_chunk: int):
    """(B, S, d) -> its routing rows: each segment (``_n_segments``) a row
    of its own."""
    B, S, d = x.shape
    return x.reshape(B * _n_segments(S, token_chunk), -1, d)


def _gate(x, router, cfg: MoEConfig, token_chunk: int):
    """The router on each routing row: (weights (B, S, k) fp32, expert
    indices (B, S, k), aux loss per row and segment (B, segments))."""
    B, S, _ = x.shape
    logits = _segments(x, token_chunk).float() @ router.float()
    weights, idx, aux = _top_k_gating(logits, cfg)
    k = cfg.top_k
    return (weights.reshape(B, S, k), idx.reshape(B, S, k),
            aux.reshape(B, -1))


def _dispatch(x, weights, idx, w_gate, w_up, w_down, cfg: MoEConfig,
              token_chunk: int):
    """The routed experts' combined output (B, S, d) fp32: each expert
    runs its SwiGLU on its kept entries, whose weighted rows are
    scatter-added. With the experts' hidden dim split (a rank's columns of
    ``w_gate``/``w_up``, rows of ``w_down``) the result is that rank's
    partial sum."""
    B, S, d = x.shape
    xs = _segments(x, token_chunk)
    Bs, T = xs.shape[:2]
    E, k = cfg.n_experts, cfg.top_k
    C = T if cfg.dropless else max(1, int(-(-k * T * cfg.capacity_factor
                                            // E)))
    kept, per_expert = _route(idx, Bs, T, k, E, C)
    token_of = kept // k                        # flat (row, token) index
    rows = xs.reshape(Bs * T, d)[token_of]
    experts = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    parts = enumerate(rows.split(per_expert))
    ys = torch.cat([_expert(experts, e, part) for e, part in parts
                    if len(part)]) if len(kept) else rows
    w = weights.reshape(Bs * T * k)[kept]
    y = torch.zeros((Bs * T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, token_of, ys.float() * w[:, None])
    return y.reshape(B, S, d)


def apply_moe(params, x, cfg: MoEConfig, token_chunk: int = TOKEN_CHUNK):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux_loss fp32 scalar).

    A sequence longer than ``token_chunk`` and a multiple of it is routed in
    ``token_chunk`` segments, each with its own capacity, and the aux loss is
    the mean over segments, as in the reference: here the segments become
    batch rows.

    On meta tensors (the dry-run) the routing is a balanced router's
    (``_balanced_entries``): the experts run on meta rows of those counts,
    and the same ``index_add_`` combines them.

    On DTensors (``_apply_moe_sharded``) each rank routes its own rows.
    """
    if spmd.is_dtensor(x):
        return _apply_moe_sharded(params, x, cfg, token_chunk)
    B, S, d = x.shape
    weights, idx, aux = _gate(x, params["router"], cfg, token_chunk)
    y = _dispatch(x, weights, idx, params["w_gate"], params["w_up"],
                  params["w_down"], cfg, token_chunk)
    if cfg.n_shared:
        y = y + layers.apply_swiglu(params["shared"],
                                    x.reshape(B * S, d)).reshape(
                                        B, S, d).float()
    return y.to(x.dtype), cfg.router_aux_weight * aux.mean()


def _apply_moe_sharded(params, x, cfg: MoEConfig, token_chunk: int):
    """``apply_moe`` on DTensor ``x`` (B, S, d), rows split over the batch
    axes, and DTensor parameters placed by ``distributed.sharding``.

    Routing is per row (per segment), so each rank routes its own rows
    exactly; the ranks of one "model" group hold the same rows and the
    same replicated router and make the same choices. The router runs in
    one ``local_apply`` and the experts in another: the router's gradient
    from the aux loss is whole on every "model" rank, the one from the
    combine a partial sum there, and one call could not say both. The
    experts' weights are gathered over their FSDP dim (E or d, whichever
    the rules gave it) and keep their hidden dim split over "model": gate
    and up column-parallel, down row-parallel. The combine is linear, so
    the "model" partial sums are reduced once after it, not once an
    expert: the expert loop's length and row counts differ between data
    ranks, and a collective inside it would pair the wrong tensors. The
    aux loss is the mean over all rows (``spmd.batch_mean``), replicated.
    """
    rows = [p if p.is_shard(0) else Replicate() for p in x.placements]
    names = x.device_mesh.mesh_dim_names
    if "model" in names:
        rows[names.index("model")] = Replicate()
    whole = [Replicate()] * len(rows)
    B, S, _ = x.shape
    weights, idx, aux = spmd.local_apply(
        lambda a, r: _gate(a, r, cfg, token_chunk), (x, params["router"]),
        (rows, whole), (rows, rows, rows),
        ((B, S, cfg.top_k), (B, S, cfg.top_k),
         (B, _n_segments(S, token_chunk))))

    def hidden_split(w, f_dim):
        """``w`` gathered but for its hidden dim (``f_dim``) on "model"."""
        return [p if p.is_shard(f_dim) else Replicate()
                for p in w.placements]
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    pg, pu, pd = hidden_split(wg, 2), hidden_split(wu, 2), hidden_split(wd, 1)
    out = [Partial() if g.is_shard() else r for g, r in zip(pg, rows)]
    y = spmd.local_apply(
        lambda a, w, i, g, u, dn: _dispatch(a, w, i, g, u, dn, cfg,
                                            token_chunk),
        (x, weights, idx, wg, wu, wd), (rows, rows, rows, pg, pu, pd), out,
        x.shape)
    y = spmd.resolved(y)
    dtype = x.dtype
    if cfg.n_shared:
        shared = layers.apply_swiglu(params["shared"], x)
        y = spmd.local_apply(lambda a, b: (a + b.float()).to(dtype),
                             (y, shared), (y.placements, y.placements),
                             y.placements, x.shape)
    else:
        y = spmd.local_apply(lambda a: a.to(dtype), (y,), (y.placements,),
                             y.placements, x.shape)
    return y, cfg.router_aux_weight * spmd.batch_mean(aux)
