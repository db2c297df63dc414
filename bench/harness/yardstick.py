"""The yardstick: peaks of one NVIDIA H100 (SXM, dense rates, 700 W) and
the work arithmetic, frozen here so that later changes to the program do
not move it.

``visible_pairs``, ``flash_work`` and ``kernel_bound`` are copies of
``repro_torch.analysis.roofline`` as of the commit that added the
benchmark (a test holds them equal). ``train_flops`` extends that module's
``model_flops`` (6·N·tokens) with attention's visible-pair work.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_FP32_FLOPS = 67e12      # fp32, CUDA cores (TF32 off)
HBM_BW = 3.35e12             # bytes/s


class Work(NamedTuple):
    """One kernel call's work: its operations, the bytes it must move, and
    the peak rate of the operations' type (FLOP/s)."""
    flops: float
    bytes: float
    peak: float


def _peak(itemsize: int) -> float:
    return PEAK_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS


@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, T: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the masks leave visible: query s sees keys
    [max(0, s - window + 1), min(T, s + 1)) when causal."""
    total = 0
    for s in range(S):
        hi = min(T, s + 1) if causal else T
        lo = max(0, s - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


_PRODUCTS = {"B1": 2, "B2": 3, "B3": 4}   # D-long products a visible pair


def flash_work(kernel: str, B: int, S: int, T: int, K: int, G: int, D: int,
               itemsize: int, causal: bool = True,
               window: Optional[int] = None) -> Work:
    """B1 (forward), B2 (dq) or B3 (dk, dv): 2·D flops a product, 2, 3 or
    4 products a visible pair and query head. B1 reads q, k, v and writes
    out and the fp32 lse; B2 and B3 read q, dO, k, v, lse and delta and
    write dq, or dk and dv."""
    pairs = B * K * G * visible_pairs(S, T, causal, window)
    flops = 2.0 * D * _PRODUCTS[kernel] * pairs
    q, kv, rows = B * S * K * G * D, B * T * K * D, B * S * K * G
    io = itemsize * (2 * q + 2 * kv)
    nbytes = {"B1": io + 4 * rows,
              "B2": io + 8 * rows + itemsize * q,
              "B3": io + 8 * rows + itemsize * 2 * kv}[kernel]
    return Work(flops, float(nbytes), _peak(itemsize))


def kernel_bound(work: Work):
    """(least ms the card needs for ``work``, what sets it: "operations"
    or "bytes")."""
    t_ops, t_bytes = work.flops / work.peak, work.bytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def active_params(cfg: dict) -> int:
    """Parameters a token's step multiplies by, from a configuration file:
    every layer's attention, norms and dense MLP, the final norm and the LM
    head over the padded vocabulary. The embedding is a lookup and is not
    counted."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = head_dim(cfg)
    attn = d * H * D * 2 + d * K * D * 2 + 2 * d
    mlp = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + mlp) + d + d * padded_vocab(cfg)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def padded_vocab(cfg: dict) -> int:
    """The embedding's rows: the vocabulary padded to a multiple of 256,
    as the program lays it out."""
    return -(-cfg["vocab_size"] // 256) * 256


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of ``batch`` rows of ``seq`` tokens:
    6·N_active·tokens, plus 12·D a visible (query, key) pair and query
    head for attention's two products, forward and backward. No
    recomputation is counted."""
    pairs = visible_pairs(seq, seq, True, cfg.get("sliding_window"))
    attn = 12.0 * head_dim(cfg) * cfg["num_attention_heads"] * pairs
    return (6.0 * active_params(cfg) * batch * seq
            + attn * batch * cfg["num_hidden_layers"])


def attention_bounds_ms(cfg: dict, batch: int, seq: int) -> dict:
    """kernel_bound ms of B1, B2 and B3 over one layer's attention of
    ``batch`` rows in bf16 (linear in ``batch``)."""
    K = cfg["num_key_value_heads"]
    G = cfg["num_attention_heads"] // K
    return {k: kernel_bound(flash_work(k, batch, seq, seq, K, G, head_dim(cfg),
                                       2, True, cfg.get("sliding_window")))[0]
            for k in ("B1", "B2", "B3")}


def busy_union_ns(spans) -> int:
    """Device busy time: the union of the (start, end) intervals of every
    device activity, so that overlapping activities count once (a copy of
    ``chip_smoke.busy_union_ms``'s arithmetic)."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy
