"""Epoch-level workload profiles (paper §5.3): ``EpochProfile``, the
58-event vector it is read as, and the ``Profiler`` that builds one per
(trial, epoch), copied from ``repro.core.profiler``.

Like the paper, a profile is a fixed-length event vector
(``PROFILE_EVENTS``) averaged over the epoch window; only execution-level
counters enter it, nothing model- or data-identifying. The vector feeds the
k-means ground-truth store (``core.groundtruth.GroundTruth``). The
reference's memory fraction divides by a TPU's 16 GiB; here it divides by
the device's own memory.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional

import numpy as np

# 58 events, mirroring the paper's counter count. Grouped:
#   hlo.*   — compiled-program counters (per step)
#   coll.*  — collective payloads by kind
#   mem.*   — executable memory analysis
#   rt.*    — measured runtime statistics (per epoch)
#   shape.* — execution-shape descriptors
PROFILE_EVENTS: List[str] = [
    "hlo.flops", "hlo.bytes", "hlo.transcendentals", "hlo.arith_intensity",
    "hlo.dot_flops_frac", "hlo.elem_flops_frac", "hlo.reduce_flops_frac",
    "hlo.conv_flops_frac", "hlo.flops_per_token", "hlo.bytes_per_token",
    "coll.all_reduce", "coll.all_gather", "coll.reduce_scatter",
    "coll.all_to_all", "coll.collective_permute", "coll.total",
    "coll.count", "coll.bytes_per_flop", "coll.ar_frac", "coll.ag_frac",
    "mem.args_bytes", "mem.temp_bytes", "mem.out_bytes", "mem.code_bytes",
    "mem.peak_frac", "mem.params_bytes", "mem.opt_bytes", "mem.acts_bytes",
    "rt.step_time_mean", "rt.step_time_std", "rt.step_time_min",
    "rt.step_time_max", "rt.step_time_p50", "rt.step_time_p90",
    "rt.throughput", "rt.steps_per_epoch", "rt.epoch_time", "rt.power",
    "rt.energy", "rt.util_proxy", "rt.loss_start", "rt.loss_end",
    "rt.loss_delta", "rt.grad_norm_mean", "rt.compile_time", "rt.host_time",
    "shape.batch", "shape.seq_or_dim", "shape.params", "shape.layers",
    "shape.d_model", "shape.vocab", "shape.microbatches", "shape.dp",
    "shape.tp", "shape.remat", "shape.precision_bits", "shape.chips",
]

assert len(PROFILE_EVENTS) == 58


@dataclasses.dataclass
class EpochProfile:
    """``raw=True`` marks events that are already in compressed (log-ish)
    space — e.g. SimBackend's modeled vectors — so ``vector()`` returns
    them verbatim, in insertion order, instead of re-logging."""

    events: Dict[str, float]
    raw: bool = False

    @classmethod
    def from_vector(cls, vec) -> "EpochProfile":
        """Wrap an already-compressed profile vector (raw mode)."""
        return cls({f"ev{i}": float(v) for i, v in enumerate(vec)}, raw=True)

    def vector(self) -> np.ndarray:
        if self.raw:
            return np.asarray(list(self.events.values()), np.float64)
        v = np.zeros(len(PROFILE_EVENTS), np.float64)
        for i, name in enumerate(PROFILE_EVENTS):
            x = float(self.events.get(name, 0.0))
            # compress dynamic range like the paper's per-epoch averaging:
            # counters span 1e0..1e15, log1p keeps k-means distances sane.
            v[i] = math.log1p(abs(x)) * (1 if x >= 0 else -1)
        return v


def device_memory_bytes(device=None) -> int:
    """Total memory of ``device``: the card's ``total_memory`` for a CUDA
    device, the host's physical memory for the CPU."""
    import torch
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class Profiler:
    """Collects one EpochProfile per (trial, epoch)."""

    def __init__(self, device=None):
        self.device = device
        self.records: List[EpochProfile] = []

    def build(self, *, hlo_cost=None, memory: Optional[dict] = None,
              step_times: Optional[List[float]] = None,
              sys_config=None, workload_meta: Optional[dict] = None,
              loss_start: float = 0.0, loss_end: float = 0.0,
              power_w: float = 0.0, compile_time: float = 0.0,
              tokens_per_step: float = 0.0) -> EpochProfile:
        ev: Dict[str, float] = {}
        if hlo_cost is not None:
            f = max(hlo_cost.flops, 1.0)
            ev["hlo.flops"] = hlo_cost.flops
            ev["hlo.bytes"] = hlo_cost.bytes
            ev["hlo.transcendentals"] = hlo_cost.transcendentals
            ev["hlo.arith_intensity"] = hlo_cost.flops / max(hlo_cost.bytes, 1)
            ev["coll.all_reduce"] = hlo_cost.coll.get("all-reduce", 0)
            ev["coll.all_gather"] = hlo_cost.coll.get("all-gather", 0)
            ev["coll.reduce_scatter"] = hlo_cost.coll.get("reduce-scatter", 0)
            ev["coll.all_to_all"] = hlo_cost.coll.get("all-to-all", 0)
            ev["coll.collective_permute"] = hlo_cost.coll.get(
                "collective-permute", 0)
            ev["coll.total"] = hlo_cost.coll_bytes
            ev["coll.count"] = hlo_cost.coll_count
            ev["coll.bytes_per_flop"] = hlo_cost.coll_bytes / f
            ev["coll.ar_frac"] = ev["coll.all_reduce"] / max(ev["coll.total"], 1)
            ev["coll.ag_frac"] = ev["coll.all_gather"] / max(ev["coll.total"], 1)
            if tokens_per_step:
                ev["hlo.flops_per_token"] = hlo_cost.flops / tokens_per_step
                ev["hlo.bytes_per_token"] = hlo_cost.bytes / tokens_per_step
        if memory:
            ev["mem.args_bytes"] = memory.get("argument_size_in_bytes", 0)
            ev["mem.temp_bytes"] = memory.get("temp_size_in_bytes", 0)
            ev["mem.out_bytes"] = memory.get("output_size_in_bytes", 0)
            ev["mem.code_bytes"] = memory.get("generated_code_size_in_bytes", 0)
            total = device_memory_bytes(self.device)
            ev["mem.peak_frac"] = (ev["mem.args_bytes"]
                                   + ev["mem.temp_bytes"]) / total
            ev["mem.params_bytes"] = memory.get("params_bytes", 0)
            ev["mem.opt_bytes"] = memory.get("opt_bytes", 0)
            ev["mem.acts_bytes"] = memory.get("acts_bytes", 0)
        if step_times:
            st = np.asarray(step_times, np.float64)
            ev["rt.step_time_mean"] = st.mean()
            ev["rt.step_time_std"] = st.std()
            ev["rt.step_time_min"] = st.min()
            ev["rt.step_time_max"] = st.max()
            ev["rt.step_time_p50"] = float(np.percentile(st, 50))
            ev["rt.step_time_p90"] = float(np.percentile(st, 90))
            ev["rt.steps_per_epoch"] = len(st)
            ev["rt.epoch_time"] = st.sum()
            if tokens_per_step:
                ev["rt.throughput"] = tokens_per_step / max(st.mean(), 1e-9)
        ev["rt.power"] = power_w
        ev["rt.energy"] = power_w * ev.get("rt.epoch_time", 0.0)
        ev["rt.loss_start"] = loss_start
        ev["rt.loss_end"] = loss_end
        ev["rt.loss_delta"] = loss_start - loss_end
        ev["rt.compile_time"] = compile_time
        if sys_config is not None:
            ev["shape.microbatches"] = sys_config.microbatches
            ev["shape.dp"] = sys_config.dp
            ev["shape.tp"] = sys_config.tp
            ev["shape.remat"] = {"none": 0, "dots": 1, "block": 2}.get(
                sys_config.remat, 0)
            ev["shape.precision_bits"] = (16 if sys_config.precision == "bf16"
                                          else 32)
            ev["shape.chips"] = sys_config.chips
        if workload_meta:
            for k in ("batch", "seq_or_dim", "params", "layers", "d_model",
                      "vocab"):
                ev[f"shape.{k}"] = workload_meta.get(k, 0)
        prof = EpochProfile(ev)
        self.records.append(prof)
        return prof
