"""Roofline terms, model-FLOPs and kernel bounds on one NVIDIA H100: the
counterpart of ``repro.analysis.roofline``.

Three terms per (arch, shape, mesh) cell, all in seconds:
    compute    = flops            / peak of their type
    memory     = bytes            / HBM_BW
    collective = collective_bytes / NVLINK_BW

Hardware model: the card as ``nvidia-smi`` names it, "NVIDIA H100 80GB
HBM3" at its 700 W limit. The rates are the data sheet's dense peaks, not
readings: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 on the
CUDA cores (the port turns TF32 off, ``device.resolve``, so fp32 products
run there too), 3.35 TB/s HBM3, 450 GB/s NVLink a direction, 80 GB of HBM.

The compute term puts matrix products and convolutions in fp32 and the
kernels' fp32 work (``Work.peak``) at the fp32 peak and every other flop at
the bf16 peak: an optimistic term, as every term here is, so a measured
step can never be faster than ``RooflineTerms.step_time_s``.

Each kernel's work (``flash_work``, ``mlstm_work``, ``rglru_work``) is the
work of its function on these inputs, whatever implements it: each input
read once, each output written once, the operations of the visible (query,
key) pairs or of the recurrence. ``kernel_bound`` turns it into the least
time the card could take; the kernels' meta branches report the same work
to ``analysis.cost``.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, NamedTuple, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_FP32_FLOPS = 67e12      # fp32, CUDA cores (TF32 off)
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction
HBM_BYTES = 80e9             # the card's memory

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float                  # every op's operands and results
    collective_s: float
    hlo_flops: float                 # global (all chips)
    hlo_bytes: float                 # global
    coll_bytes: float                # global
    chips: int
    model_flops: float = 0.0
    memory_kernelized_s: float = 0.0  # less the score-class traffic that a
    #                                   flash kernel keeps on chip; 0 = same

    @property
    def memory_best_s(self) -> float:
        return self.memory_kernelized_s or self.memory_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_best_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (full-overlap) step time: max of the three terms,
        with the kernelized memory term (kernels are part of the system)."""
        return max(self.compute_s, self.memory_best_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-projected step time."""
        t = self.step_time_s
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t if t else 0.0

    def to_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_kernelized_s": self.memory_kernelized_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "step_time_s": self.step_time_s, "mfu": self.mfu,
        }


def terms_from_cost(cost: dict, coll: Dict[str, int], chips: int,
                    model_flops: float = 0.0) -> RooflineTerms:
    """cost: {"flops", "bytes accessed"} of the per-device program, every
    flop at the bf16 peak; coll: collective bytes with a "total"."""
    per_dev_flops = float(cost.get("flops", 0.0))
    per_dev_bytes = float(cost.get("bytes accessed", 0.0))
    flops = per_dev_flops * chips
    nbytes = per_dev_bytes * chips
    cbytes = float(coll.get("total", 0))
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_FLOPS),
        memory_s=nbytes / (chips * HBM_BW),
        collective_s=cbytes / (chips * NVLINK_BW),
        hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=cbytes, chips=chips,
        model_flops=model_flops)


def terms_from_dispatch(c, chips: int, model_flops: float = 0.0
                        ) -> RooflineTerms:
    """c: ``repro_torch.analysis.cost.Cost`` of the per-device step.

    Collective bytes are per-device payload; every card pushes its share
    over its own links, so the collective term is payload / NVLINK_BW.
    """
    flops = c.flops * chips
    nbytes = c.bytes * chips
    cbytes = c.coll_bytes * chips
    compute = ((c.flops - c.fp32_flops) / PEAK_FLOPS
               + c.fp32_flops / PEAK_FP32_FLOPS)
    return RooflineTerms(
        compute_s=compute,
        memory_s=nbytes / (chips * HBM_BW),
        memory_kernelized_s=c.kernelized_bytes / HBM_BW,
        collective_s=cbytes / (chips * NVLINK_BW),
        hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=cbytes, chips=chips,
        model_flops=model_flops)


# ---------------------------------------------------------------------------
# model-FLOPs estimates (6ND convention)
# ---------------------------------------------------------------------------

def count_params(abstract_params, active_expert_frac: Optional[float] = None):
    """(total, active) param counts of a parameter tree (tensors, meta
    tensors, or shape tuples) under the reference's leaf paths. Expert
    tensors scale by the active fraction (top_k [+ shared] / E) for the MoE
    6*N_active*D convention."""
    from repro_torch import weights
    total = active = 0
    for ps, leaf in weights.flatten(abstract_params).items():
        n = 1
        for d in getattr(leaf, "shape", leaf):
            n *= d
        total += n
        if active_expert_frac is not None and re.search(
                r"moe/w_(gate|up|down)", ps):
            active += int(n * active_expert_frac)
        else:
            active += n
    return total, active


def model_flops(cfg, shape, abstract_params) -> float:
    frac = None
    if getattr(cfg, "n_experts", 0):
        frac = cfg.top_k / cfg.n_experts
    total, active = count_params(abstract_params, frac)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch          # decode: one token/seq


# ---------------------------------------------------------------------------
# kernel work and bounds
# ---------------------------------------------------------------------------

class Work(NamedTuple):
    """One kernel call's work: its operations, the bytes it must move, and
    the peak rate of the operations' type (FLOP/s)."""
    flops: float
    bytes: float
    peak: float


def _peak(itemsize: int) -> float:
    """Tensor cores for 2-byte inputs, the CUDA cores for fp32."""
    return PEAK_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS


@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, T: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the kernels' masks leave visible: query s sees
    keys [max(0, s - window + 1), min(T, s + 1)) when causal."""
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
    4 products a visible pair and query head (4·D, 6·D, 8·D). B1 reads q, k,
    v and writes out and the fp32 lse; B2 and B3 read q, dO, k, v, lse and
    delta and write dq, or dk and dv."""
    pairs = B * K * G * visible_pairs(S, T, causal, window)
    flops = 2.0 * D * _PRODUCTS[kernel] * pairs
    q, kv, rows = B * S * K * G * D, B * T * K * D, B * S * K * G
    io = itemsize * (2 * q + 2 * kv)
    nbytes = {"B1": io + 4 * rows,
              "B2": io + 8 * rows + itemsize * q,
              "B3": io + 8 * rows + itemsize * 2 * kv}[kernel]
    return Work(flops, float(nbytes), _peak(itemsize))


def mlstm_work(B: int, S: int, H: int, D: int, itemsize: int) -> Work:
    """B4: the least work of the function at any chunk size, at chunk 1
    (the recurrent form): per step and head q C and the rank-one update of
    C (4·D²), q k, a v, q n and the update of n (8·D); q, k, v read and h
    written in their dtype, the two fp32 gates read. On the fp32 peak."""
    flops = B * H * S * (4.0 * D * D + 8.0 * D)
    nbytes = 4 * B * S * H * D * itemsize + 2 * B * S * H * 4
    return Work(flops, float(nbytes), PEAK_FP32_FLOPS)


def rglru_work(B: int, S: int, R: int, h0: bool = False) -> Work:
    """B5: h_t = a_t·h_{t-1} + b_t, 2 fp32 flops a step and channel;
    log_a and b read, h and h_last written (12·B·S·R + 4·B·R bytes), h0
    read when given."""
    nbytes = 12 * B * S * R + 4 * B * R + (4 * B * R if h0 else 0)
    return Work(2.0 * B * S * R, float(nbytes), PEAK_FP32_FLOPS)


def kernel_bound(work: Work):
    """(least ms the card needs for ``work``, what sets it: "operations"
    or "bytes")."""
    t_ops, t_bytes = work.flops / work.peak, work.bytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
