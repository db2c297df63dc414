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
    expert keeping at most ``cap`` = B * C of them. Returns (the kept
    entries as a meta index tensor, the kept count per expert).

    This models the work of routed rows. It is not the reference's count,
    whose one-hot einsums cover all E * C capacity slots of every row."""
    per_expert = [min(cap, n // E + (e < n % E)) for e in range(E)]
    return (torch.empty(sum(per_expert), dtype=torch.long, device=dev),
            per_expert)


def apply_moe(params, x, cfg: MoEConfig, token_chunk: int = TOKEN_CHUNK):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux_loss fp32 scalar).

    A sequence longer than ``token_chunk`` and a multiple of it is routed in
    ``token_chunk`` segments, each with its own capacity, and the aux loss is
    the mean over segments, as in the reference: here the segments become
    batch rows.

    On meta tensors (the dry-run) the routing is a balanced router's
    (``_balanced_entries``): the experts run on meta rows of those counts,
    and the same ``index_add_`` combines them.
    """
    B, S, d = x.shape
    if S > token_chunk and S % token_chunk == 0:
        y, aux = apply_moe(params, x.reshape(-1, token_chunk, d), cfg,
                           token_chunk)
        return y.reshape(B, S, d), aux
    E, k, T = cfg.n_experts, cfg.top_k, S
    C = T if cfg.dropless else max(1, int(-(-k * T * cfg.capacity_factor
                                            // E)))
    logits = x.float() @ params["router"].float()
    weights, idx, aux = _top_k_gating(logits, cfg)

    n = B * T * k
    dev = x.device
    if dev.type == "meta":
        kept, per_expert = _balanced_entries(n, E, B * C, dev)
    else:
        # Entries (row, token, choice) in the reference's order, grouped by
        # expert and then by row by a stable sort; an entry's slot in its
        # (expert, row) buffer is its rank within that group.
        e_of = idx.reshape(n)
        row_of = torch.arange(B, device=dev).repeat_interleave(T * k)
        group = e_of * B + row_of
        order = torch.sort(group, stable=True).indices
        sizes = torch.bincount(group, minlength=E * B)
        starts = sizes.cumsum(0) - sizes
        slot = torch.arange(n, device=dev) - starts[group[order]]
        kept = order[slot < C]
        per_expert = torch.bincount(e_of[kept], minlength=E).tolist()

    token_of = kept // k                        # flat (row, token) index
    xs = x.reshape(B * T, d)[token_of]
    parts = enumerate(xs.split(per_expert))
    ys = torch.cat([_expert(params, e, part) for e, part in parts
                    if len(part)]) if len(kept) else xs
    w = weights.reshape(n)[kept]
    y = torch.zeros((B * T, d), dtype=torch.float32, device=dev)
    y.index_add_(0, token_of, ys.float() * w[:, None])
    if cfg.n_shared:
        y = y + layers.apply_swiglu(params["shared"],
                                    x.reshape(B * T, d)).float()
    return (y.reshape(B, S, d).to(x.dtype),
            cfg.router_aux_weight * aux.mean())
