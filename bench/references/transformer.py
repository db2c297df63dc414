"""Plain PyTorch reference of a decoder-only transformer train step: the
dense (llama) block, in float32, and adamw by hand. It imports only
``torch``: nothing of the program.

The function, as the configuration files state it:

* tokens -> embedding rows; per layer: RMSNorm (``rms_norm_eps``), q/k/v
  projections, RoPE on adjacent pairs (2i, 2i+1) with theta
  ``rope_theta``, causal attention (softmax scale 1/sqrt(head_dim);
  within ``sliding_window`` where set) with grouped kv heads, the output
  projection, a residual; RMSNorm, then a SwiGLU MLP and a residual; a
  final RMSNorm and the LM head over the padded vocabulary; mean cross
  entropy.
* The gradient is clipped to a global norm of 1, then adamw (b1 0.9,
  b2 0.95, eps 1e-8, bias-corrected, decoupled weight decay on the
  parameter before the update) at the step's learning rate.

Memory: each layer is recomputed in the backward (``checkpoint``) and
attention runs over blocks of 512 queries, each recomputed, so a 16k-token
row fits beside the weights and adamw's state.

Modes (``mode``):

* ``"fp32"``: every product in float32 with TF32 off;
* ``"tf32"``: the same, with the products' operands rounded to TF32 by
  the card (10 bits of mantissa, against the program's bf16 with 7) and
  accumulated in float32; everything else as ``"fp32"``;
* ``"fp8"``, the control: the same function computed in float8 e4m3
  where the program computes in its bf16: every matrix product's
  operands, and every activation the program keeps in its compute dtype
  (the embedding rows, the residual stream, the norms' outputs, q, k, v,
  the attention's output, the MLP's products), are rounded to float8
  e4m3 with one scale a tensor, the power of two at or above amax / 448;
  the products' operands are then exact in TF32, and the products
  accumulate in float32. The logits and the loss stay in float32, as the
  program's do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512


def _fp8(x):
    """x rounded to float8 e4m3 with one power-of-two scale
    (straight-through)."""
    amax = x.detach().abs().amax()
    if amax == 0:
        return x
    s = torch.exp2(torch.ceil(torch.log2(amax / 448.0)))
    r = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (r - x.detach())


MODES = ("fp32", "tf32", "fp8")


class Ops:
    """The products and the compute-dtype rounding of one mode."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        self.tf32 = mode != "fp32"
        self.q = _fp8 if mode == "fp8" else (lambda x: x)
        self.act = self.q

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, S, ..., D): adjacent pairs rotated by position."""
    B, S, D = x.shape[0], x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    shape = (1, S) + (1,) * (x.ndim - 3) + (D // 2,)
    cos, sin = ang.cos().view(shape), ang.sin().view(shape)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(x.shape)


def _attn_block(ops, qb, k, v, s0, window):
    """Queries [s0, s0 + len) against the keys they can see."""
    n, D = qb.shape[1], qb.shape[-1]
    hi = s0 + n
    lo = max(0, s0 - window + 1) if window else 0
    kk, vv = k[:, lo:hi], v[:, lo:hi]
    s = ops.einsum("bskgd,btkd->bkgst", qb, kk) / math.sqrt(D)
    qpos = torch.arange(s0, hi, device=qb.device)[:, None]
    kpos = torch.arange(lo, hi, device=qb.device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), -1)
    return ops.einsum("bkgst,btkd->bskgd", p, vv)


def attention(ops, q, k, v, window):
    S = q.shape[1]
    return torch.cat([checkpoint(_attn_block, ops, q[:, s0:s0 + Q_BLOCK], k,
                                 v, s0, window, use_reentrant=False)
                      for s0 in range(0, S, Q_BLOCK)], 1)


def swiglu(ops, h, w_gate, w_up, w_down):
    a = ops.act(F.silu(ops.act(ops.mm(h, w_gate)))
                * ops.act(ops.mm(h, w_up)))
    return ops.act(ops.mm(a, w_down))


def layer(ops, x, p, cfg):
    """One block."""
    B, S, d = x.shape
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or d // H
    G = H // K
    eps = cfg.get("rms_norm_eps", 1e-6)
    act = ops.act
    h = act(rmsnorm(x, p["attn_norm"]["scale"], eps))
    q = act(ops.mm(h, p["attn"]["wq"].reshape(d, -1))).reshape(B, S, K, G, D)
    kk = act(ops.mm(h, p["attn"]["wk"].reshape(d, -1))).reshape(B, S, K, D)
    vv = act(ops.mm(h, p["attn"]["wv"].reshape(d, -1))).reshape(B, S, K, D)
    q, kk = act(rope(q, cfg["rope_theta"])), act(rope(kk, cfg["rope_theta"]))
    o = act(attention(ops, q, kk, vv, cfg.get("sliding_window")))
    x = act(x + act(ops.mm(o.reshape(B, S, -1),
                           p["attn"]["wo"].reshape(-1, d))))
    h = act(rmsnorm(x, p["mlp_norm"]["scale"], eps))
    m = p["mlp"]
    return act(x + swiglu(ops, h, m["w_gate"], m["w_up"], m["w_down"]))


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _layer_params(tree, i):
    return {k: _layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def loss(ops, flat, batch, cfg):
    """The mean cross entropy over labels >= 0."""
    p = _unflatten(flat)
    x = ops.act(p["embed"][batch["tokens"]])
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(layer, ops, x, _layer_params(p["layers"], i), cfg,
                       use_reentrant=False)
    x = ops.act(rmsnorm(x, p["final_norm"]["scale"],
                        cfg.get("rms_norm_eps", 1e-6)))
    logits = ops.mm(x, p["lm_head"])
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)


def lr_at(step, lr, warmup, total, final_frac=0.1):
    """warmup_cosine: linear warmup from 0, then a cosine to final_frac."""
    if step < warmup:
        return lr * min(1.0, step / max(1, warmup))
    t = min((step - warmup) / max(1, total - warmup), 1.0)
    return lr * (final_frac + (1 - final_frac) * 0.5
                 * (1 + math.cos(math.pi * t)))


def train(flat, batches, cfg, hp, mode="fp32"):
    """Run len(batches) train steps from the fp32 weights ``flat`` (updated
    in place). Returns {"losses": [the loss each step], "grad": {path:
    norm of step 1's clipped gradient}, "raw_grad": {path: norm of step
    1's gradient before clipping}}."""
    ops = Ops(mode)
    matmul = torch.backends.cuda.matmul
    tf32, matmul.allow_tf32 = matmul.allow_tf32, ops.tf32
    try:
        return _train(ops, flat, batches, cfg, hp)
    finally:
        matmul.allow_tf32 = tf32


def _train(ops, flat, batches, cfg, hp):
    b1, b2, eps = 0.9, 0.95, 1e-8
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    out = {"losses": []}
    for step, batch in enumerate(batches):
        leaves = {k: t.detach().requires_grad_() for k, t in flat.items()}
        ce = loss(ops, leaves, batch, cfg)
        grads = torch.autograd.grad(ce, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = dict(zip(leaves, grads))
        out["losses"].append(float(ce.detach()))
        del leaves, ce
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        if step == 0:
            out["raw_grad"] = {k: float(g.norm()) for k, g in grads.items()}
        lr = lr_at(step, hp["lr"], hp["warmup"], hp["total"])
        t = step + 1.0
        with torch.no_grad():
            for k, g in grads.items():
                g = g * scale
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                u = (m[k] / (1 - b1 ** t)) / (
                    torch.sqrt(v2[k] / (1 - b2 ** t)) + eps)
                u = u + hp["weight_decay"] * flat[k]
                flat[k].add_(u, alpha=-lr)
        if step == 0:
            out["grad"] = {k: float(mk.norm()) / (1 - b1)
                           for k, mk in m.items()}
        del grads
    return out
