#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --lane-probe [REPS]   # the [parallel] lanes only

Phases (any failure raises, and the script exits non-zero):
  1. print the card (nvidia-smi name and power limit); build every kernel of
     ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, all
     started together) and print the build time and ptxas's register report;
  2. run hopper.cuh's self-test (csrc/hopper_selftest.cu, not a port of a
     TPU kernel): a TMA load of a 64 x D and a 128 x D tile, then wgmma
     with B K-major and with B MN-major, at D = 64 and 128, each held
     against an fp32 product of the same bf16 inputs, so that a descriptor
     or swizzle fault fails here under its own name; then, in a cluster of
     8 blocks, a TMA multicast into every block, distributed shared memory
     read and written across blocks, the cluster barrier, remote mbarrier
     arrivals and the blocks' ranks, each checked by name;
     then hold each kernel against its plain PyTorch version on the card: B1
     (the forward) and B2/B3 (the backward: dq, and dk/dv) at the serve or
     train shape and at ragged, windowed, non-causal, fp32 and other
     group-size shapes, the Hopper tiles' edge cases among them (G = 8 with
     ragged S; B1 at G = 64; B3 at G = 80, with out and lse from the plain
     forward), and in fp32 at the LM phase's shapes (8 x 64 tokens in 1, 2
     or 4 microbatches, at full-width qwen3-0.6b and at the LM example's
     width). A planted fault (one kv tile hidden from the later rows in
     the forward; in the backward, the dk/dv contribution of the same rows
     to the same keys left out) must fail each check. The whole autograd op
     (B1 forward, B2 and B3 backward) is held against autograd through fp32
     dense attention at the train shape;
  3. serve full-width qwen3-0.6b (seeded bf16 weights, 8 requests of 2048
     prompt tokens, 32 generated) through ``repro_torch.launch.serve.main``,
     with every launch counter set to 0 just before and read just after; the
     flash kernel must have run 28 times (one per layer) per prefill, the
     backward kernels never. Then recompute the prefill logits on the plain
     attention path (``use_pallas=False``) in bf16 and in fp32, and hold both
     bf16 paths against the fp32 one (``LOGITS_RATIO``); the planted forward
     fault must fail this check;
  4. train full-width qwen3-0.6b (fp32 masters, bf16 compute, 4 x 2048
     tokens, 6 steps) through ``repro_torch.launch.train.main``, counters set
     to 0 just before: B1, B2 and B3 must each have run 28 times a step, and
     every loss must be finite. Then 2 steps with ``--remat block
     --microbatches 2``: B1 runs twice per layer and microbatch (forward and
     recompute), B2 and B3 once, and the first loss must match;
  5. hold the loss gradients of full-width qwen3-0.6b (1 x 2048 tokens) on
     the bf16 kernel path against those of the fp32 plain path: per leaf no
     further than ``GRAD_RATIO`` times the bf16 plain path's distance. The
     planted backward fault must fail this check;
  6. time each kernel at its main path's shape beside its bound, its plain
     version and one PyTorch library call of the same function
     (``scaled_dot_product_attention`` and its backward, with the kv heads
     expanded and the flash backend pinned, timed here only: the port never
     calls it), and B2 + B3 back to back beside SDPA's whole backward. Every
     time is the median of 5 windows after 5 warm-up calls, printed with its
     spread;
  7. hold B4 (mLSTM) against its plain version at the xlstm-350m width
     (B=8, S=2048, H=4, D=512) at each chunk of the tuner's grid (32..256)
     in fp32 and in bf16, and at head dims and chunks that are not
     multiples of the kernel's tiles; and
     B5 (RG-LRU) at the recurrentgemma-9b width (B=8, S=2048, R=4096), at
     ragged S and R, with and without h0, and at the edges of its ring (a
     chunk the plan cuts, S = 2047, R = 4094, r_block 512, the most
     stages), each with the kernel's launch plan (tile depth, stages,
     shared memory, threads). Planted faults (B4
     without the inter-chunk q C term for chunks >= 1; B5 without one
     step's carry) must fail the checks;
  8. run the kernel tuner (``repro_torch.kernels.tune.tune_kernel``: grid,
     3 reps, 1 warm-up, a fresh find-db) on both full-width workloads with
     every launch counter set to 0 just before and read just after: 4 and
     16 trials, the B4 and B5 launches equal to the kernel calls the
     backend timed, no B1-B3 launch, rows under a ``cuda/...h100...``
     hardware key, a golden table under ``build/``; a second call must
     answer from the find-db with 0 trials and 0 launches, and
     ``ops.mlstm``/``ops.rglru`` with ``chunk=None`` must launch with the
     defaults on an empty find-db, the winners' configs on the golden
     table, and on a find-db of configs that are neither, with those;
  9. time B4 and B5 at full width at the default config and at the winner,
     beside their bounds (one per shape: the least work at any chunk) and
     their plain versions (no single PyTorch call computes either: no
     library time), and at every config of the grid, B5's output there
     held against its plain version; each B5 time with its plan and the
     TB/s it reached, beside an elementwise ``torch.add`` that moves the
     same bytes (the memory rate a streaming call reaches);
 10. the tuning loop on the paper's Table-3 workloads (lenet-mnist,
     lenet-fashion, cnn-news20, lstm-news20) through ``TorchRealBackend``,
     with every launch counter set to 0 just before and read just after
     (none of B1-B5 may launch: no TPU kernel is on this path): print the
     energy model's P_IDLE/P_DYN beside the card's idle power.draw; hold
     one fp32 epoch on the card against the same epoch on the CPU, step by
     step (``CARD_CPU_TOL``), where an LSTM without its +1.0 forget bias on
     the card side must fail; train one epoch under each of the 12 configs
     of the "real" sys space on each workload (finite losses, bf16 within
     ``BF16_LOSS_TOL`` of fp32) and print ms/step, compile_s and the final
     loss; profile 3 steps of each (device busy against wall time); run
     Table 2 (``benchmarks/table2.py`` quick: Arbitrary, TuneV1, TuneV2 and
     PipeTune through ``Experiment``; PipeTune's best accuracy within
     ``TABLE2_ACC_TOL`` of TuneV1's); and run ``launch.tune.main`` with its
     defaults on each workload;
 11. trials run concurrently (``[parallel]``), counters set to 0 just
     before and read just after (none of B1-B5 may launch): (a) TuneV1's
     policy at remat none, 1 microbatch, fp32 over random search
     (``PAR_TRIALS`` x ``PAR_EPOCHS``, batch 64, the launcher's sizes) on
     lenet-mnist and lstm-news20, serially and on
     ``ParallelTrialExecutor`` at 2 and 4 thread lanes (one CUDA stream
     each): the same hparams, every step's loss within ``PAR_LOSS_TOL`` of
     the serial run's and eval accuracy within ``PAR_ACC_SAMPLES``; wall
     time, trial time, speedup and ms/step over the waves before the last
     (the trials go one epoch a wave, so they may change lanes between
     epochs), and the device's busy time and idle share over the last
     wave (torch.profiler, device activity only, overlapping activities
     counted once; it runs over the last wave alone); (c) a planted
     lane fault (one trial's batches in a wave-mate's order) must fail
     that check; (b) ``launch.tune.main`` with PipeTune +
     hyperband on lenet-mnist (``PAR_EPOCHS`` epochs), serially and at
     ``--parallelism 4``: hits + misses equal the trials, accuracy within
     ``TABLE2_ACC_TOL``; (d) the sim launcher at ``--parallelism 1``,
     ``4`` and ``--executor cluster``: the same printed numbers, a
     makespan only on the cluster; the phase within
     ``PAR_PHASE_LIMIT_S``;
 12. the Type-III workloads (``[typeiii]``: jacobi, spkmeans and bfs at
     their published sizes through ``TorchNumericBackend``), counters set
     to 0 just before and read just after (none of B1-B5 may launch): four
     fp32 epochs on the card held against the CPU per epoch
     (``TYPEIII_TOL``: jacobi's x, spkmeans' centroids and assignments,
     bfs's visited flags exactly), where an epoch with one sweep or one
     Lloyd step dropped, or bfs's first epoch skipped, must fail; bf16
     accuracy within ``TYPEIII_BF16_ACC`` of fp32; ms per epoch at
     fp32/bf16 x 1/2 microbatches; the idle share of one epoch
     (torch.profiler); the reference's Fig-12 run (TuneV1 against
     PipeTune with a shared ``GroundTruth``, random 3 trials x 6 epochs
     each) with the tuning times and ``tune_ratio_mean``; and
     ``launch.tune.main`` with ``--backend numeric`` on the card's default
     device;
 13. PipeTune over the LM train step (``[lmtune]``,
     ``examples/torch_tune_llm_sysparams.py``'s ``LMBackend``): one epoch
     of its tune-lm width on the card against the CPU (on one thread) per
     step at remat none and block (``LM_CARD_CPU_TOL``; the card trial one
     batch on must fail); its ``main()`` on the card; then PipeTune
     (random 3 trials x 2 epochs) at full-width qwen3-0.6b through a
     subclass overriding ``_cfg()``. In both, every epoch's B1, B2 and
     B3 launches equal what it implies (per step: layers x microbatches
     of B2 and of B3, and of B1 twice that under remat, the recompute),
     printed per sys config
     with ms/step; the launch counters over each run equal the epochs'
     sum; then (``[lmprofile]``) one full-width step at each of those two
     sys configs under torch.profiler (device activity): ms/step, busy
     time, idle share and the three kernels with the most device time;
 14. the kernel tuner's train_step workload (``[trainstep]``):
     ``train-smoke`` runs 6 trials, its winner (or the baseline, if the
     winner does not beat it by more than the baseline's own spread) goes
     to a golden table under the card's hardware key, a warm rerun runs
     none;
     ``launch.tune.main`` and ``launch.train.main`` with ``--kernel-db``
     install its row; a ``TorchRealBackend`` epoch with no sys keys runs
     the tuned config (and a planted find-db's other config); then
     ``examples/torch_quickstart.py`` on the card. The tuner, the tuning
     launcher and the quickstart launch none of B1-B5. Each of the last
     four phases prints its wall time and must end within its 60 s limit.
Then it prints the ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.

``--lane-probe [REPS]`` builds nothing and runs (a) alone, REPS times
(``PAR_PROBE_REPS``) in each of two processes: one with the profiler off
(serial, 2 and 4 lanes), one with the profiler started from another thread
``PAR_MIDWAVE_S`` into a last wave on 4 lanes. It prints each process's
exit code, so a crash is put down to the lanes or to the profiler. Without CUDA, or without the repo's
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # CUDA cores, no tensor cores
PEAK_BYTES = 3.35e12

# The kernel against its plain version on the same inputs. Both accumulate
# in fp32 and round out to the input dtype once, so bf16 out may differ by
# about a bf16 step of |ref| (2**-8 to 2**-7 of it): |err| <= atol + rtol|ref|.
# LSE is fp32 in both and is held at an absolute bound.
OUT_TOL = {"bfloat16": (4e-3, 2.0 ** -7), "float32": (2e-5, 2e-5)}
LSE_TOL = 1e-4
# Prefill logits: the bf16 kernel path and the bf16 plain attention path
# (use_pallas=False) round attention to bf16 at different points in each of
# 28 layers, and random weights carry that difference to the head, so the
# two are not compared with each other at a fixed tolerance. Each is compared
# with the fp32 plain path on the same weights: the kernel path may be at
# most LOGITS_RATIO times as far from it as the bf16 plain path is.
LOGITS_RATIO = 2.0
# A planted fault that both checks must catch: keys 64..127 (one kv tile)
# hidden from query rows >= 1024, as a kernel that skipped a tile would do.
FAULT = (1024, 64, 128)
# B2/B3 against their plain version, per gradient tensor: |err| <= a *
# max|ref| + r * |ref|, r about a bf16 step. Both sum in fp32 and round the
# result to the input dtype once; in bf16 the kernels also round p and dS to
# bf16 as the operands of three of their products (see
# csrc/flash_attention_bwd.cu). On an NVIDIA H100 80GB HBM3 (700 W) the
# smallest a that passes was at most 1.74e-3 in bf16 over the nine shapes
# and 6.2e-7 in fp32; the limits leave about twice (bf16) and thirty times
# (fp32, a sum of up to S*G terms in another order) that.
GRAD_TOL = {"bfloat16": (4e-3, 2.0 ** -7), "float32": (2e-5, 2e-5)}
# The autograd op (bf16 B1 forward, B2/B3 backward) against autograd through
# fp32 dense attention, which rounds nothing: same form as GRAD_TOL, with a
# doubled for the bf16 out of B1 that the backward reads (the smallest a
# that passes read 3.4e-3 at the train shape).
OP_TOL = (8e-3, 2.0 ** -7)
# Full-width loss gradients: the bf16 kernel path may be at most GRAD_RATIO
# times as far from the fp32 plain path's gradients as the bf16 plain path
# is, leaf by leaf (distance max|delta| / max|g_fp32|), as for the logits.
GRAD_RATIO = 2.0

# B4 and B5 against their plain versions, |err| <= a * max|ref| + r * |ref|
# per output tensor as for GRAD_TOL. The kernels sum in fp32 in another
# order than the plain versions (B5 walks the steps one by one, as the
# reference does, where the plain version's associative scan combines them
# in a tree); in bf16 and fp16 both round the
# fp32 result to the output dtype once, so r is one step of it. On an
# NVIDIA H100 80GB HBM3 (700 W) max|err| / max|ref| read at most 8.2e-7
# for B4 in fp32 (eight shapes) and 3.5e-7 for B5 (seven shapes; the
# one-pass kernel read at most 1.9e-7 over twelve); in bf16
# and fp16 B4 was within one step of the output dtype (a ~ 0 at that r).
# The limits leave about 2.4x (B4) and 2.8x (B5) on those readings.
MLSTM_TOL = {"float32": (2e-6, 2e-6), "bfloat16": (1e-4, 2.0 ** -7),
             "float16": (1e-4, 2.0 ** -10)}
RGLRU_TOL = (1e-6, 1e-6)
# The tuner's full-width workloads: xlstm-350m's mLSTM (d_model 1024 x
# proj_factor 2 over 4 heads: D = 512) and recurrentgemma-9b's RG-LRU
# (d_rnn 4096).
MLSTM_WORKLOAD = "mlstm@B=8,S=2048,H=4,D=512"
RGLRU_WORKLOAD = "rglru@B=8,S=2048,R=4096"
MLSTM_SHAPE = (8, 2048, 4, 512)
RGLRU_SHAPE = (8, 2048, 4096)
GOLDEN = Path("build") / "chip_smoke" / "kernel_golden.json"

# hopper.cuh's self-test (csrc/hopper_selftest.cu) against fp32 products of
# the same bf16 inputs: both sum 64 or 128 products that fp32 holds exactly,
# in another order, so |err| <= HOPPER_TOL * max|ref|; a wrong descriptor
# or swizzle puts whole rows or columns out of place, an error of O(1).
HOPPER_TOL = 1e-4

# The tuning loop (paper Table 3 workloads through TorchRealBackend). The
# launcher's backend sizes; a trial's hyperparameters for the checks below.
PAPER_WORKLOADS = ("lenet-mnist", "lenet-fashion", "cnn-news20",
                   "lstm-news20")
LOOP_SIZES = dict(n_train=1024, n_eval=256, steps_per_epoch=8)
LOOP_HPARAMS = {"batch_size": 64, "learning_rate": 0.05, "dropout": 0.0}
LOOP_DEFAULT_SYS = {"remat": "none", "microbatches": 1, "precision": "fp32"}
# Card against CPU, one fp32 epoch from the same weights and batches:
# |loss_card - loss_cpu| <= CARD_CPU_TOL * (1 + |loss_cpu|) at every step;
# step and eval accuracy within 1.5 samples (a tied argmax may flip one).
# On an NVIDIA H100 80GB HBM3 (700 W) the worst step over the four
# workloads read 1.2e-7 (TF32 off); an LSTM without its +1.0 forget bias
# reads 3.7e-3.
CARD_CPU_TOL = 1e-6
# bf16 against fp32 on the card, same remat and microbatches: the epoch's
# last loss within BF16_LOSS_TOL * (1 + |loss_fp32|); the same card read
# at most 1.9e-3 over the four workloads and six configs.
BF16_LOSS_TOL = 1e-2
# Table 2 (benchmarks/table2.py, quick): PipeTune's best accuracy within
# this of TuneV1's (the paper: PipeTune matches V1's accuracy).
TABLE2_ACC_TOL = 0.05

# Concurrent trials (the [parallel] phase): TuneV1's policy (hyperparameters
# only, one fixed system config: LOOP_DEFAULT_SYS, the config [tuneloop]
# profiles) over random search on two Table-3 workloads at the launcher's
# sizes, serially and on 2 and 4 thread lanes, each lane on its own CUDA
# stream. Every trial's per-step loss within PAR_LOSS_TOL * (1 + |loss|) of
# the serial run's (the card against CPU limit above), eval accuracy within
# PAR_ACC_SAMPLES samples. The busy time and idle share come from
# torch.profiler (device activity only) over the end of each run.
PAR_WORKLOADS = ("lenet-mnist", "lstm-news20")
PAR_LANES = (1, 2, 4)
PAR_TRIALS, PAR_EPOCHS = 4, 3
PAR_LOSS_TOL = CARD_CPU_TOL
PAR_ACC_SAMPLES = 1.5
PAR_PHASE_LIMIT_S = 60.0
# torch.profiler holds each (a) run's last epoch (its last wave: the
# random search's trials are released one epoch a wave). It starts between
# waves, when no lane is launching, and stops after the run, so its stop,
# which holds the GIL while it reads the trace back, stalls no lane. A
# whole LSTM run's ~200k device activities take it 6-9 s to read back on
# the card, which the phase's limit cannot hold. Wall time, speedup and
# ms/step are read over the waves before it, which run unprofiled.
# ``--lane-probe`` repeats (a) with the profiler off, and then with it
# started PAR_MIDWAVE_S into a last wave while lanes launch, each mode in
# a process of its own, PAR_PROBE_REPS times.
PAR_MIDWAVE_S = 0.05
PAR_PROBE_REPS = 5
SIM_LAUNCH = ["--backend", "sim", "--system", "pipetune", "--scheduler",
              "hyperband", "--epochs", "9"]

# The Type-III workloads (paper Fig 12, the Rodinia suite) through
# TorchNumericBackend at their published sizes: jacobi 128 x 128, 20 sweeps
# an epoch; spkmeans 2,048 points x 16 dims, k = 8, 5 Lloyd steps; bfs
# 1,024 nodes of average degree 8, 2 levels. Card against CPU, fp32, every
# epoch of TYPEIII_EPOCHS: jacobi's x and spkmeans' centroids within
# TYPEIII_TOL * max|CPU value|, every spkmeans assignment and every bfs
# visited flag equal. The two sides add, roll and divide by 4 alike in IEEE
# fp32 (jacobi), and sum 16 squares and each cluster's points in another
# order (spkmeans); the limit is the CPU parity tolerance against the
# reference.
TYPEIII = ("jacobi-rodinia", "spkmeans-rodinia", "bfs-rodinia")
TYPEIII_EPOCHS = 4
TYPEIII_SYS = {"remat": "none", "microbatches": 1, "precision": "fp32"}
TYPEIII_TOL = 1e-5
TYPEIII_BF16_ACC = 2e-2
TYPEIII_PHASE_LIMIT_S = 60.0
# The reference's Fig-12 run (benchmarks/run.py, bench_fig12_real_typeIII):
# TuneV1 against PipeTune (2 probes, one GroundTruth for all workloads)
# over random search, 3 trials x 6 epochs, on each workload.
FIG12_TRIALS, FIG12_EPOCHS, FIG12_PROBES = 3, 6, 2

# PipeTune over the LM train step (examples/torch_tune_llm_sysparams.py):
# card against CPU, one epoch (6 steps) of the example's tune-lm width from
# the same weights, at one sys config per remat value; every step's loss
# within LM_CARD_CPU_TOL * (1 + |loss_cpu|). fp32 on both sides; the card
# runs B1-B3 in fp32 where the CPU runs their plain versions, summing in
# another order, and adamw's m / sqrt(v) carries those differences into
# the later steps. The CPU side runs on one thread, where its epoch is the
# same in every process; on the default threads it varies within 1.3e-7
# (tools/probe_cpu_exp.py on the card's host: lm-1 24 of 24 runs equal,
# lm 13 distinct sequences in 16 runs). The card's epoch was the same in
# 16 of 16 fresh processes. On an NVIDIA H100 80GB HBM3 (700 W) the worst
# step of six reads 5.859e-7 (none/1) and 2.604e-7 (block/2), lr 2e-3; a
# trial one batch on reads 1.658e-2. One run of an earlier version of the
# phase alone read 1.699e-5: not reproduced, cause unknown.
LM_SYS = ({"remat": "none", "microbatches": 1, "precision": "fp32"},
          {"remat": "block", "microbatches": 2, "precision": "fp32"})
LM_CARD_CPU_TOL = 1e-5
# B1-B3's fp32 shapes on the LM phase's path (8 x 64 tokens, split into 1,
# 2 or 4 microbatches; full-width qwen3-0.6b and tune-lm): (name, B, K, D)
# at S = T = 64, G = 2, causal. Phase 2 holds each against the plain
# versions at OUT_TOL and GRAD_TOL.
LM_ATTN_SHAPES = [(f"lm_{w}_b{b}", b, k, d)
                  for w, k, d in (("full", 8, 128), ("tune", 2, 32))
                  for b in (8, 4, 2)]
LM_FULL_ARCH = "qwen3-0.6b"
LM_FULL_TRIALS, LM_FULL_EPOCHS = 3, 2
LM_PHASE_LIMIT_S = 60.0

# The kernel tuner's train_step workload (train-smoke: lenet-mnist at batch
# 64) and --kernel-db in the launchers.
TRAIN_WORKLOAD = "train-smoke"
TRAIN_GOLDEN = Path("build") / "chip_smoke" / "train_step_golden.json"
TRAINSTEP_PHASE_LIMIT_S = 60.0

ARCH = "qwen3-0.6b"
REQUESTS, PROMPT_LEN, GEN = 8, 2048, 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6
# The kernels' shapes: serve (B1) and train (B2, B3) at full width.
SERVE_SHAPE = (REQUESTS, PROMPT_LEN, 8, 2, 128)
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 8, 2, 128)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def demangled_kernel(mangled):
    """(kernel name, mangled template arguments or "") of a kernel's
    mangled symbol. Each name in it follows its length in digits; the
    anonymous namespace's hash before it may hold any letters and digits,
    so the name is the one whose length prefix fits it exactly."""
    import re
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n = int(mangled[i:run.end()])
            name = mangled[run.end():run.end() + n]
            if re.fullmatch(r"(?:fa|mlstm|rglru|hopper)_\w+_kernel", name):
                rest = re.match(r"I\w+?E", mangled[run.end() + n:])
                return name, rest.group(0) if rest else ""
    return mangled, ""


def ptxas_report(log):
    """[(kernel, "registers ...; spills ...")] from nvcc's -Xptxas -v log."""
    import re
    rows, kernel, spill = [], "?", ""
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, targs = demangled_kernel(m.group(1))
            if targs:                         # template arguments
                args = [{"13__nv_bfloat16": "bf16", "6__half": "half",
                         "f": "float"}.get(t.group(1), t.group(2))
                        for t in re.finditer(r"(13__nv_bfloat16|6__half|f)"
                                             r"|Li(\d+)", targs)]
                kernel += f"<{', '.join(args)}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            rows.append((kernel, f"{line.split(':', 1)[-1].strip()}; "
                                 f"{spill}"))
    return rows


class Timing(float):
    """A kernel time in ms: the median of ``windows`` timed windows, with
    their least and largest."""

    def __new__(cls, times):
        times = sorted(times)
        t = super().__new__(cls, times[len(times) // 2])
        t.lo, t.hi, t.n = times[0], times[-1], len(times)
        return t

    def spread(self):
        return (f"median of {self.n} windows, spread {self.lo:.4f}-"
                f"{self.hi:.4f} ms")


def cuda_ms(fn, iters, warmup=5, windows=5):
    """ms per call of ``fn``: CUDA events around ``windows`` windows of
    ``iters`` calls each, after ``warmup`` calls; the median window."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return Timing(times)


def attention_inputs(B, S, T, K, G, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, K, G, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, T, K, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, T, K, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def visible_pairs(S, T, causal, window):
    """(query, key) pairs the masks leave visible: the work of these inputs."""
    total = 0
    for s in range(S):
        hi = min(T, s + 1) if causal else T
        lo = max(0, s - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def dense_attention(q, k, v, causal, window=None, drop=None):
    """Plain masked attention in fp32: (out in q's dtype, lse (B,S,K,G)).

    ``drop=(row, lo, hi)`` hides keys lo..hi-1 from query rows >= row. It is
    the planted fault that shows the checks below can fail.
    """
    import torch
    B, S, K, G, D = q.shape
    T = k.shape[1]
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    visible = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        visible &= cols <= rows
    if window:
        visible &= cols > rows - window
    if drop:
        row, lo, hi = drop
        visible &= ~((rows >= row) & (cols >= lo) & (cols < hi))
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) / D ** 0.5
    s = s.masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.to(q.dtype), lse.permute(0, 3, 1, 2)


def compare(out, lse, ref_out, ref_lse):
    """(within tolerance, max|out err|, max|lse err|, out atol, out rtol)."""
    import torch
    atol, rtol = OUT_TOL[str(ref_out.dtype).split(".")[-1]]
    e_out = (out.float() - ref_out.float()).abs()
    e_lse = (lse - ref_lse).abs()
    ok = (bool((e_out <= atol + rtol * ref_out.float().abs()).all())
          and bool((e_lse <= LSE_TOL).all())
          and bool(torch.isfinite(out).all()))
    return ok, float(e_out.max()), float(e_lse.max()), atol, rtol


def dense_attention_bwd(q, k, v, do, causal, window=None, drop=None):
    """Plain masked attention backward in fp32: (dq, dk, dv) in the inputs'
    dtype, from a softmax of its own.

    ``drop=(row, lo, hi)`` leaves the contribution of query rows >= row to
    keys lo..hi-1 out of dk and dv: the planted fault of the backward.
    """
    import torch
    B, S, K, G, D = q.shape
    T = k.shape[1]
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    visible = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        visible &= cols <= rows
    if window:
        visible &= cols > rows - window
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scale = D ** -0.5
    s = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    del s
    out = torch.einsum("bkgst,btkd->bkgsd", p, vf)
    delta = (out * dof.permute(0, 2, 3, 1, 4)).sum(-1)
    ds = p * (torch.einsum("bskgd,btkd->bkgst", dof, vf)
              - delta[..., None]) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf)
    if drop:
        row, lo, hi = drop
        keep = ~((rows >= row) & (cols >= lo) & (cols < hi))
        p, ds = p * keep, ds * keep
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def compare_grads(got, ref, tol):
    """(within tolerance, [(max|err|, max|ref|) for dq, dk, dv], reading).

    |err| <= a * max|ref| + r * |ref| elementwise, with (a, r) = tol; the
    reading is the smallest a that passes.
    """
    import torch
    a, r = tol
    finite, errs, need = True, [], 0.0
    for g, f in zip(got, ref):
        f = f.float()
        e = (g.float() - f).abs()
        top = float(f.abs().max())
        finite = finite and bool(torch.isfinite(g).all())
        errs.append((float(e.max()), top))
        need = max(need, float((e - r * f.abs()).max()) / top)
    return finite and need <= a, errs, need


def grad_line(errs, need, tol):
    return (", ".join(f"{n} {e:.3e} (max|ref| {t:.3e})"
                      for n, (e, t) in zip(("dq", "dk", "dv"), errs))
            + f"; needs a >= {need:.3e} (limit a*max|ref| + r|ref|, "
            f"a={tol[0]:g}, r={tol[1]:g})")


def phase_hopper(build):
    """hopper.cuh's TMA maps, mbarrier and wgmma descriptors on the card:
    C1 = A B^T (B K-major) and C2 = bf16(C1) B (B MN-major) at D = 64 and
    128, each against an fp32 product of the same inputs; then its cluster
    helpers in a cluster of 8, each held against what it must give."""
    import ctypes
    import torch
    lib = build.load("hopper_selftest")
    fn = lib.hopper_selftest
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hopper_error_string.argtypes = [ctypes.c_int]
    lib.hopper_error_string.restype = ctypes.c_char_p
    for D in (64, 128):
        g = torch.Generator(device="cuda").manual_seed(1000 + D)
        a = torch.randn((64, D), generator=g, device="cuda").bfloat16()
        b = torch.randn((128, D), generator=g, device="cuda").bfloat16()
        c1 = torch.empty((64, 128), device="cuda")
        c2 = torch.empty((64, D), device="cuda")
        rc = fn(a.data_ptr(), b.data_ptr(), c1.data_ptr(), c2.data_ptr(), D,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"hopper self-test launch failed at D={D}: "
                       f"{lib.hopper_error_string(rc).decode()} ({rc})")
        torch.cuda.synchronize()
        # elementwise fp32 sums: no TF32 anywhere
        ref1 = (a.float()[:, None, :] * b.float()[None, :, :]).sum(-1)
        ref2 = (c1.bfloat16().float()[:, :, None]
                * b.float()[None, :, :]).sum(1)
        errs = [float((c - r).abs().max() / r.abs().max())
                for c, r in ((c1, ref1), (c2, ref2))]
        ok = [bool(torch.isfinite(c).all()) and e <= HOPPER_TOL
              for c, e in zip((c1, c2), errs)]
        print(f"[hopper] D={D}: TMA + wgmma, B K-major (A B^T) max|err| / "
              f"max|ref| {errs[0]:.3e} {'ok' if ok[0] else 'FAIL'}; B "
              f"MN-major, A in registers (bf16(C1) B) {errs[1]:.3e} "
              f"{'ok' if ok[1] else 'FAIL'} (limit {HOPPER_TOL:g})",
              flush=True)
        check(ok[0], f"hopper self-test: K-major wgmma wrong at D={D}")
        check(ok[1], f"hopper self-test: MN-major wgmma wrong at D={D}")

    cl = lib.hopper_cluster_selftest
    cl.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    cl.restype = ctypes.c_int
    n = 8                                     # B4's cluster size
    src = torch.randn((8, 256), generator=torch.Generator(
        device="cuda").manual_seed(1001), device="cuda")
    tiles = torch.full((n, 8, 256), float("nan"), device="cuda")
    dsmem = torch.full((n, 128), float("nan"), device="cuda")
    pushed = torch.full((n, 128), float("nan"), device="cuda")
    ranks = torch.full((n + 1,), -1, dtype=torch.int32, device="cuda")
    rc = cl(src.data_ptr(), tiles.data_ptr(), dsmem.data_ptr(),
            pushed.data_ptr(), ranks.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"hopper cluster self-test launch failed: "
                   f"{lib.hopper_error_string(rc).decode()} ({rc})")
    torch.cuda.synchronize()
    rank = torch.arange(n, device="cuda")[:, None]
    tid = torch.arange(128, device="cuda")[None, :]
    want = (rank + 1) % n * 1000 + tid        # read from the next rank
    want_pushed = (rank - 1) % n * 1000 + tid  # stored by the previous one
    results = {
        "TMA multicast into every block": bool(torch.equal(
            tiles, src.expand(n, 8, 256))),
        "DSMEM reads of the next rank (mapa, ld.shared::cluster) after the "
        "cluster barrier": bool(torch.equal(dsmem, want.float())),
        "DSMEM stores (st.shared::cluster) seen after a remote mbarrier "
        "arrival": bool(torch.equal(pushed, want_pushed.float())),
        "cluster ranks": ranks[:n].tolist() == list(range(n)),
        "remote mbarrier arrivals on rank 0": int(ranks[n]) == 1,
    }
    print(f"[hopper] cluster of {n}: " + "; ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in results.items()),
        flush=True)
    for what, ok in results.items():
        check(ok, f"hopper cluster self-test: {what} wrong")


def phase_kernels(fa):
    import torch
    shapes = [  # name, B, S, T, K, G, D, dtype, causal, window
        ("serve", 8, 2048, 2048, 8, 2, 128, torch.bfloat16, True, None),
        ("ragged", 2, 1000, 1000, 8, 2, 128, torch.bfloat16, True, None),
        ("window", 2, 2048, 2048, 8, 2, 128, torch.bfloat16, True, 256),
        ("noncausal", 2, 1024, 1024, 8, 2, 128, torch.bfloat16, False, None),
        ("fp32", 2, 512, 512, 8, 2, 128, torch.float32, True, None),
        ("g1", 2, 1024, 1024, 16, 1, 128, torch.bfloat16, True, None),
        ("g2_d64", 2, 1024, 1024, 4, 2, 64, torch.bfloat16, True, None),
        ("g3_d40_s_ne_t", 1, 200, 333, 2, 3, 40, torch.bfloat16, True, 50),
        ("fp32_g3_d72", 1, 333, 333, 2, 3, 72, torch.float32, False, 64),
        ("g8_ragged", 2, 1000, 1000, 2, 8, 128, torch.bfloat16, True, None),
        ("g64_d64", 2, 256, 256, 1, 64, 64, torch.bfloat16, True, None),
        *[(n, b, 64, 64, k, 2, d, torch.float32, True, None)
          for n, b, k, d in LM_ATTN_SHAPES],
    ]
    errs = {}
    for i, (name, B, S, T, K, G, D, dt, causal, window) in enumerate(shapes):
        q, k, v = attention_inputs(B, S, T, K, G, D, dt, seed=i)
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                      return_lse=True)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ok, e_out, e_lse, atol, rtol = compare(out, lse, ref_out, ref_lse)
        errs[name] = e_out
        limits = (f"limits out {atol:g}+{rtol:g}|ref|, lse {LSE_TOL:g}")
        print(f"[kernel] flash_attention {name:14s} B={B} S={S} T={T} K={K} "
              f"G={G} D={D} {str(dt)[6:]} causal={causal} window={window}: "
              f"max|out err|={e_out:.3e} max|lse err|={e_lse:.3e} "
              f"({limits}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash_attention disagrees with its plain version at "
                  f"{name}")
        if name == "serve":
            f_out, f_lse = dense_attention(q, k, v, causal, window, FAULT)
            caught, f_eo, f_el = compare(f_out, f_lse, ref_out, ref_lse)[:3]
            caught = not caught
            print(f"[kernel] planted fault at {name} (keys {FAULT[1]}.."
                  f"{FAULT[2] - 1} hidden from rows >= {FAULT[0]}): "
                  f"max|out err|={f_eo:.3e} max|lse err|={f_el:.3e} "
                  f"({limits}) {'caught' if caught else 'MISSED'}",
                  flush=True)
            check(caught, "the kernel check misses a dropped kv tile")
            del f_out, f_lse
        del q, k, v, out, lse, ref_out, ref_lse
    return errs


BWD_SHAPES = [  # name, B, S, T, K, G, D, dtype, causal, window
    ("train", 4, 2048, 2048, 8, 2, 128, "bfloat16", True, None),
    ("ragged", 2, 1000, 1000, 8, 2, 128, "bfloat16", True, None),
    ("window", 2, 2048, 2048, 8, 2, 128, "bfloat16", True, 256),
    ("noncausal", 2, 1024, 1024, 8, 2, 128, "bfloat16", False, None),
    ("fp32", 2, 512, 512, 8, 2, 128, "float32", True, None),
    ("g1", 2, 1024, 1024, 16, 1, 128, "bfloat16", True, None),
    ("g2_d64", 2, 1024, 1024, 4, 2, 64, "bfloat16", True, None),
    ("g3_d40_s_ne_t", 1, 200, 333, 2, 3, 40, "bfloat16", True, 50),
    ("fp32_g3_d72", 1, 333, 333, 2, 3, 72, "float32", False, 64),
    ("g8_ragged", 2, 1000, 1000, 2, 8, 128, "bfloat16", True, None),
    # B1 takes at most 64 heads a group: out and lse from the plain forward
    ("g80_d64", 1, 128, 128, 1, 80, 64, "bfloat16", True, None),
    *[(n, b, 64, 64, k, 2, d, "float32", True, None)
      for n, b, k, d in LM_ATTN_SHAPES],
]


def phase_bwd_kernels(fa, fa_bwd):
    """B2/B3 against their plain version; the planted backward fault."""
    import torch
    errs = {}
    for i, (name, B, S, T, K, G, D, dt, causal, window) in enumerate(
            BWD_SHAPES):
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(B, S, T, K, G, D, dtype, seed=200 + i)
        do = attention_inputs(B, S, S, K, G, D, dtype, seed=300 + i)[0]
        if G <= 64:
            out, lse = fa.flash_attention(q, k, v, causal=causal,
                                          window=window, return_lse=True)
        else:
            out, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                    window=window)
            lse = lse.contiguous()
        got = fa_bwd.flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa_bwd.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal, window=window)
        torch.cuda.synchronize()
        ok, e, need = compare_grads(got, ref, GRAD_TOL[dt])
        errs[name] = e
        print(f"[kernel] flash_attention_bwd {name:14s} B={B} S={S} T={T} "
              f"K={K} G={G} D={D} {dt} causal={causal} window={window}: "
              f"max|err| {grad_line(e, need, GRAD_TOL[dt])} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"flash_attention_bwd disagrees with its plain version at "
                  f"{name}")
        if name == "train":
            fault = dense_attention_bwd(q, k, v, do, causal, window, FAULT)
            passed, fe, fneed = compare_grads(fault, ref, GRAD_TOL[dt])
            caught = not passed
            print(f"[kernel] planted backward fault at {name} (the dk/dv "
                  f"contribution of rows >= {FAULT[0]} to keys {FAULT[1]}.."
                  f"{FAULT[2] - 1} left out): max|err| "
                  f"{grad_line(fe, fneed, GRAD_TOL[dt])} "
                  f"{'caught' if caught else 'MISSED'}", flush=True)
            check(caught, "the backward check misses a dropped tile")
            del fault
        del q, k, v, do, out, lse, got, ref
    return errs


def phase_op(ops):
    """The autograd op against autograd through fp32 dense attention."""
    import torch
    B, S, K, G, D = TRAIN_SHAPE
    q, k, v = attention_inputs(B, S, S, K, G, D, torch.bfloat16, seed=400)
    do = attention_inputs(B, S, S, K, G, D, torch.bfloat16, seed=401)[0]
    leaves = [t.requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, True, None),
                              leaves, do)
    dense = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(dense_attention(*dense, True)[0], dense,
                              do.float())
    torch.cuda.synchronize()
    ok, e, need = compare_grads(got, ref, OP_TOL)
    print(f"[kernel] autograd op (B1 + B2 + B3, bf16) vs autograd through "
          f"fp32 dense attention, B={B} S={S} K={K} G={G} D={D} causal: "
          f"max|err| {grad_line(e, need, OP_TOL)} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "the autograd op disagrees with dense attention")


def reset_counts(fa, fa_bwd):
    fa.launches = fa_bwd.launches_dq = fa_bwd.launches_dkv = 0


def read_counts(fa, fa_bwd):
    import torch
    torch.cuda.synchronize()
    return fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv


def phase_serve(fa, fa_bwd, serve, steps):
    import dataclasses
    import torch
    reset_counts(fa, fa_bwd)
    res = serve.main(["--arch", ARCH, "--requests", str(REQUESTS),
                      "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN),
                      "--seed", "0"])
    launches = read_counts(fa, fa_bwd)[0]
    cfg = res.cfg
    print(f"[serve] flash_attention launches: {launches} over "
          f"{res.prefills} prefills of {cfg.n_layers} layers; backward "
          f"{fa_bwd.launches_dq} dq, {fa_bwd.launches_dkv} dkv", flush=True)
    check(launches == cfg.n_layers * res.prefills,
          f"expected {cfg.n_layers * res.prefills} kernel launches, "
          f"got {launches}")
    check(fa_bwd.launches_dq == fa_bwd.launches_dkv == 0,
          "serving launched a backward kernel")
    V = cfg.padded_vocab
    check(tuple(res.prefill_logits.shape) == (REQUESTS, 1, V),
          f"prefill logits shape {tuple(res.prefill_logits.shape)}")
    check(bool(torch.isfinite(res.prefill_logits).all()),
          "non-finite prefill logits")
    check(tuple(res.tokens.shape) == (REQUESTS, GEN)
          and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < V,
          "generated tokens out of range")

    def prefill_logits(**change):
        sys_ = dataclasses.replace(res.sys, **change)
        step = steps.make_prefill_step(cfg, sys_, max_len=PROMPT_LEN + GEN)
        logits = step(res.params, {"tokens": res.prompts})[0]
        torch.cuda.synchronize()
        return logits

    plain = prefill_logits(use_pallas=False)
    check(fa.launches == launches, "the plain path launched the kernel")
    exact = prefill_logits(use_pallas=False, precision="fp32")
    kernel_fn = fa.flash_attention
    fa.flash_attention = (lambda q, k, v, *, causal=True, window=None, **_:
                          dense_attention(q, k, v, causal, window, FAULT)[0])
    try:
        fault = prefill_logits()
    finally:
        fa.flash_attention = kernel_fn
    check(fa.launches == launches, "the faulty path launched the kernel")

    def err(logits):
        d = (logits - exact).abs()
        return float(d.max()), float(d.pow(2).mean().sqrt())

    (err_kernel, rms_kernel), (err_plain, rms_plain) = (
        err(res.prefill_logits), err(plain))
    err_fault, rms_fault = err(fault)
    agree = float((res.prefill_logits.argmax(-1)
                   == plain.argmax(-1)).float().mean())
    ok = err_kernel <= LOGITS_RATIO * err_plain
    caught = err_fault > LOGITS_RATIO * err_plain
    print(f"[serve] prefill logits against the fp32 plain path "
          f"(max|logit|={float(exact.abs().max()):.3f}), max|err| (rms): "
          f"bf16 kernel path {err_kernel:.3e} ({rms_kernel:.3e}), bf16 plain "
          f"path {err_plain:.3e} ({rms_plain:.3e}), limit {LOGITS_RATIO:g}x "
          f"the plain path's; kernel vs plain max|diff|="
          f"{float((res.prefill_logits - plain).abs().max()):.3e}, argmax "
          f"agreement {agree:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    print(f"[serve] planted fault (keys {FAULT[1]}..{FAULT[2] - 1} hidden "
          f"from rows >= {FAULT[0]} in every layer): max|err| "
          f"{err_fault:.3e} ({rms_fault:.3e}), "
          f"{err_fault / err_plain:.2f}x the plain path's "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    check(ok, "kernel-path logits disagree with the plain path")
    check(caught, "the logits check misses a dropped kv tile")
    return res, launches


def phase_train(fa, fa_bwd, train, card):
    """Full-width training through train.main, launches counted."""
    import torch
    argv = ["--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--precision", "bf16"]
    reset_counts(fa, fa_bwd)
    res = train.main(argv + ["--steps", str(TRAIN_STEPS)])
    counts = read_counts(fa, fa_bwd)
    L = res.cfg.n_layers
    print(f"[train] launches over {TRAIN_STEPS} steps of {L} layers: "
          f"flash_attention {counts[0]}, dq {counts[1]}, dkv {counts[2]}",
          flush=True)
    check(counts == (L * TRAIN_STEPS,) * 3,
          f"expected {L * TRAIN_STEPS} launches of each kernel, got {counts}")
    print(f"[train] losses: {' '.join(f'{x:.4f}' for x in res.losses)}",
          flush=True)
    check(all(math.isfinite(x) for x in res.losses), "non-finite loss")
    print(f"[train] {card} | {res.tokens_per_s:.1f} tok/s, "
          f"{res.ms_per_step:.3f} ms/step over steps 2..{TRAIN_STEPS} "
          f"({' '.join(f'{x:.3f}' for x in res.step_ms)} ms), peak memory "
          f"{res.peak_memory_bytes / 2 ** 30:.3f} GiB "
          f"(max_memory_allocated)", flush=True)
    torch.cuda.empty_cache()

    reset_counts(fa, fa_bwd)
    remat = train.main(argv + ["--steps", "2", "--remat", "block",
                               "--microbatches", "2"])
    rc = read_counts(fa, fa_bwd)
    want = (2 * L * 2 * 2, L * 2 * 2, L * 2 * 2)
    diff = abs(remat.losses[0] - res.losses[0])
    print(f"[train] remat block, 2 microbatches, 2 steps: launches "
          f"flash_attention {rc[0]}, dq {rc[1]}, dkv {rc[2]} (expected "
          f"{want}); first loss {remat.losses[0]:.4f} against "
          f"{res.losses[0]:.4f} (|diff| {diff:.2e}, limit 1e-2); "
          f"{remat.ms_per_step:.3f} ms/step, peak memory "
          f"{remat.peak_memory_bytes / 2 ** 30:.3f} GiB", flush=True)
    check(rc == want, f"remat block: expected launches {want}, got {rc}")
    check(diff <= 1e-2, "remat block changes the first loss")
    torch.cuda.empty_cache()
    return res, counts


def loss_grads(params, batch, cfg, sys):
    """{leaf path: fp32 gradient of transformer.loss_fn}."""
    import torch
    from repro_torch import weights
    from repro_torch.models import transformer
    flat = {path: leaf.detach().requires_grad_()
            for path, leaf in weights.flatten(params).items()}
    loss, _ = transformer.loss_fn(weights.unflatten(flat), batch, cfg, sys)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return {path: g.detach() for path, g in zip(flat, grads)}


def phase_grad(fa_bwd):
    """Full-width gradients: kernel path against the fp32 plain path."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get(ARCH)
    params = transformer.init(torch.Generator(device="cuda").manual_seed(1),
                              cfg, "cuda")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, TRAIN_SEQ))
    batch = {"tokens": torch.from_numpy(toks).cuda(),
             "labels": torch.from_numpy(np.roll(toks, -1, -1)).cuda()}

    def grads(**kw):
        out = loss_grads(params, batch, cfg, transformer.SystemConfig(**kw))
        torch.cuda.synchronize()
        return out

    exact = grads(precision="fp32", use_pallas=False)
    kernel = grads(precision="bf16")
    plain = grads(precision="bf16", use_pallas=False)
    kernel_bwd = fa_bwd.flash_attention_bwd
    fa_bwd.flash_attention_bwd = (
        lambda q, k, v, out, lse, do, *, causal=True, window=None, **_:
        dense_attention_bwd(q, k, v, do, causal, window, FAULT))
    try:
        fault = grads(precision="bf16")
    finally:
        fa_bwd.flash_attention_bwd = kernel_bwd

    def dist(g):
        return {p: float((g[p] - e).abs().max() / e.abs().max())
                for p, e in exact.items()}

    def rel_l2(g):
        num = sum(float((g[p] - e).square().sum()) for p, e in exact.items())
        den = sum(float(e.square().sum()) for e in exact.values())
        return (num / den) ** 0.5

    d_k, d_p, d_f = dist(kernel), dist(plain), dist(fault)
    ratio = {p: d_k[p] / d_p[p] for p in exact}
    worst = max(ratio, key=ratio.get)
    fault_ratio = {p: d_f[p] / d_p[p] for p in exact}
    worst_fault = max(fault_ratio, key=fault_ratio.get)
    for p in exact:
        print(f"[grad] {p:24s} max|g32| {float(exact[p].abs().max()):.3e}: "
              f"distance kernel {d_k[p]:.3e}, plain {d_p[p]:.3e} "
              f"({ratio[p]:.2f}x), fault {d_f[p]:.3e} "
              f"({fault_ratio[p]:.2f}x)", flush=True)
    ok = all(ratio[p] <= GRAD_RATIO for p in exact)
    caught = fault_ratio[worst_fault] > GRAD_RATIO
    print(f"[grad] full-width loss gradients (B=1, S={TRAIN_SEQ}) against "
          f"the fp32 plain path: worst leaf {worst} at {ratio[worst]:.2f}x "
          f"the bf16 plain path's distance (limit {GRAD_RATIO:g}x); global "
          f"relative L2 kernel {rel_l2(kernel):.3e}, plain "
          f"{rel_l2(plain):.3e} {'ok' if ok else 'FAIL'}", flush=True)
    print(f"[grad] planted backward fault in every layer: worst leaf "
          f"{worst_fault} at {fault_ratio[worst_fault]:.2f}x, global "
          f"relative L2 {rel_l2(fault):.3e} "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    check(ok, "kernel-path gradients disagree with the plain path")
    check(caught, "the gradient check misses a dropped tile")
    del params, exact, kernel, plain, fault
    torch.cuda.empty_cache()


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(least ms the card needs, what sets it), at the operations' peak."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def expand_heads(q, k, v):
    """(B, S, K, G, D) / (B, T, K, D) -> (B, H, S, D) each, kv heads
    repeated over their group, for the library call."""
    B, S, K, G, D = q.shape
    T = k.shape[1]
    qh = q.reshape(B, S, K * G, D).transpose(1, 2).contiguous()
    kh, vh = (x[:, :, :, None].expand(B, T, K, G, D).reshape(B, T, K * G, D)
              .transpose(1, 2).contiguous() for x in (k, v))
    return qh, kh, vh


def sdpa_flash():
    """The context that pins SDPA to its flash backend; a shape it refuses
    raises instead of falling to another backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel(SDPBackend.FLASH_ATTENTION)


def phase_timing(fa, card):
    import torch.nn.functional as F
    import torch
    B, S, K, G, D = SERVE_SHAPE
    H = K * G
    q, k, v = attention_inputs(B, S, S, K, G, D, torch.bfloat16, seed=100)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=1)
    qh, kh, vh = expand_heads(q, k, v)
    with sdpa_flash():
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), iters=20)
    flops = 4.0 * B * H * D * visible_pairs(S, S, True, None)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * S * H
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"[timing] {card} | flash_attention B={B} S=T={S} H={H} K={K} "
          f"D={D} bf16 causal: kernel {ms:.4f} ms ({ms.spread()}; "
          f"{flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
          f"({bound_by}; {flops:.3e} FLOP, {nbytes:.3e} B), plain "
          f"{plain_ms:.4f} ms ({plain_ms.spread()}), library (SDPA, backend "
          f"FLASH_ATTENTION pinned, kv heads expanded) {library_ms:.4f} ms "
          f"({library_ms.spread()})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_bwd_timing(fa, fa_bwd, card):
    """B2 and B3 at the train shape; the library call is SDPA's backward
    (flash backend pinned), which computes dq, dk and dv together, so it is
    also set beside B2 + B3 launched back to back."""
    import torch
    import torch.nn.functional as F
    B, S, K, G, D = TRAIN_SHAPE
    H = K * G
    q, k, v = attention_inputs(B, S, S, K, G, D, torch.bfloat16, seed=500)
    do = attention_inputs(B, S, S, K, G, D, torch.bfloat16, seed=501)[0]
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = fa_bwd.attention_delta(out, do)
    kw = dict(causal=True, scale=D ** -0.5)
    args = (q, k, v, do, lse, delta)
    qh, kh, vh = (x.requires_grad_() for x in expand_heads(q, k, v))
    with sdpa_flash():
        out_h = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    backend = type(out_h.grad_fn).__name__
    check("Flash" in backend, f"SDPA's backward is {backend}, not flash")
    do_h = do.reshape(B, S, H, D).transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out_h, (qh, kh, vh), do_h, retain_graph=True), iters=20)
    # Not the yardstick: what SDPA picks unpinned, which earlier readings
    # of this phase timed without saying which backend it was.
    out_d = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    default_ms = cuda_ms(lambda: torch.autograd.grad(
        out_d, (qh, kh, vh), do_h, retain_graph=True), iters=20)
    print(f"[timing] {card} | SDPA unpinned (not the yardstick): backward "
          f"{type(out_d.grad_fn).__name__} {default_ms:.4f} ms "
          f"({default_ms.spread()})", flush=True)
    del out_d
    pairs = B * H * visible_pairs(S, S, True, None)
    stats = 4 * 2 * B * S * H                    # lse and delta, fp32
    io = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, dO, k, v in bf16
    rows = {}
    for name, kernel, plain, products, outs in (
            ("dq", fa_bwd.dq_kernel, fa_bwd.dq_reference, 3, q.numel()),
            ("dkv", fa_bwd.dkv_kernel, fa_bwd.dkv_reference, 4,
             k.numel() + v.numel())):
        ms = cuda_ms(lambda: kernel(*args, **kw), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=1)
        flops = 2.0 * D * products * pairs
        nbytes = io + stats + 2 * outs
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"[timing] {card} | flash_attention_bwd {name} B={B} S=T={S} "
              f"H={H} K={K} D={D} bf16 causal: kernel {ms:.4f} ms "
              f"({ms.spread()}; {flops / ms / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.3e} FLOP, "
              f"{nbytes:.3e} B), plain {plain_ms:.4f} ms "
              f"({plain_ms.spread()}), library (SDPA backward, {backend}, "
              f"dq, dk and dv together, kv heads expanded) "
              f"{library_ms:.4f} ms ({library_ms.spread()})", flush=True)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    both = cuda_ms(lambda: (fa_bwd.dq_kernel(*args, **kw),
                            fa_bwd.dkv_kernel(*args, **kw)), iters=20)
    print(f"[timing] {card} | flash_attention_bwd dq + dkv back to back "
          f"{both:.4f} ms ({both.spread()}) against SDPA's whole backward "
          f"({backend}) {library_ms:.4f} ms: {both / library_ms:.3f}x",
          flush=True)
    return rows


def mlstm_inputs(B, S, H, D, dtype, seed, f_shift=0.0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    ig = torch.randn((B, S, H), generator=g, device="cuda")
    fg = torch.randn((B, S, H), generator=g, device="cuda") + f_shift
    return q, k, v, ig, fg


def mlstm_drop_inter(ml, q, k, v, ig, fg, chunk):
    """The plain version with the inter-chunk q C term left out of the
    output of every chunk after the first (n and m still carried): the
    planted fault of B4."""
    import torch
    hs, state = [], None
    for c0 in range(0, q.shape[1], chunk):
        args = [x[:, c0:c0 + chunk] for x in (q, k, v, ig, fg)]
        if state is None:
            h, state = ml.mlstm_chunkwise_reference(*args, chunk=chunk)
        else:
            C, n, m = state
            h = ml.mlstm_chunkwise_reference(
                *args, chunk=chunk, state=(torch.zeros_like(C), n, m))[0]
            state = ml.mlstm_chunkwise_reference(*args, chunk=chunk,
                                                 state=state)[1]
        hs.append(h)
    return torch.cat(hs, dim=1)


def tol_line(name, e, need, tol):
    return (", ".join(f"{n} {x:.3e} (max|ref| {t:.3e})"
                      for n, (x, t) in zip(name, e))
            + f"; needs a >= {need:.3e} (limit a*max|ref| + r|ref|, "
            f"a={tol[0]:g}, r={tol[1]:g})")


# Every chunk of the tuner's grid at the full width, in fp32 and bf16 (each
# trial launches one), then head dims and chunks off the kernel's tiles.
MLSTM_CHECKS = [  # name, B, S, H, D, dtype, chunk, forget-gate shift
    ("full_c32", 8, 2048, 4, 512, "float32", 32, 0.0),
    ("full_c64", 8, 2048, 4, 512, "float32", 64, 0.0),
    ("full_c128", 8, 2048, 4, 512, "float32", 128, 0.0),
    ("full_c256", 8, 2048, 4, 512, "float32", 256, 0.0),
    ("full_bf16", 8, 2048, 4, 512, "bfloat16", 128, 0.0),
    ("full_bf16_c32", 8, 2048, 4, 512, "bfloat16", 32, 0.0),
    ("full_bf16_c64", 8, 2048, 4, 512, "bfloat16", 64, 0.0),
    ("full_bf16_c256", 8, 2048, 4, 512, "bfloat16", 256, 0.0),
    ("d72_c64", 2, 512, 2, 72, "float32", 64, 2.0),
    ("d40_s384_f16", 1, 384, 3, 40, "float16", 128, 2.0),
    ("d200_s100_bf16", 2, 100, 2, 200, "bfloat16", 100, 2.0),
]


def phase_mlstm(ml):
    """B4 against its plain version; the planted fault at full width."""
    import torch
    errs = {}
    for i, (name, B, S, H, D, dt, chunk, shift) in enumerate(MLSTM_CHECKS):
        tol = MLSTM_TOL[dt]
        x = mlstm_inputs(B, S, H, D, getattr(torch, dt), 600 + i, shift)
        h = ml.mlstm_chunkwise(*x, chunk=chunk)
        torch.cuda.synchronize()
        ref = ml.mlstm_chunkwise_reference(*x, chunk=chunk)[0]
        torch.cuda.synchronize()
        ok, e, need = compare_grads([h], [ref], tol)
        errs[name] = e[0][0]
        print(f"[kernel] mlstm {name:16s} B={B} S={S} H={H} D={D} {dt} "
              f"chunk={chunk}: max|err| {tol_line(['h'], e, need, tol)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"mlstm disagrees with its plain version at {name}")
        if name == "full_c128":
            fault = mlstm_drop_inter(ml, *x, chunk=chunk)
            passed, fe, fneed = compare_grads([fault], [ref], tol)
            print(f"[kernel] planted mlstm fault at {name} (q C left out of "
                  f"chunks >= 1): max|err| {tol_line(['h'], fe, fneed, tol)} "
                  f"{'MISSED' if passed else 'caught'}", flush=True)
            check(not passed, "the mlstm check misses a dropped q C term")
            del fault
        del x, h, ref
    return errs


RGLRU_CHECKS = [  # name, B, S, R, h0, chunk, r_block
    ("full", 8, 2048, 4096, False, 128, 128),
    ("full_h0", 8, 2048, 4096, True, 128, 128),
    ("full_c32_r256", 8, 2048, 4096, True, 32, 256),
    ("full_c256_r32", 8, 2048, 4096, False, 256, 32),
    ("ragged_h0", 2, 1000, 1000, True, 64, 128),
    ("ragged", 3, 777, 333, False, 256, 32),
    ("one_segment_h0", 2, 100, 4100, True, 128, 256),
    # the ring's edges: a chunk the plan cuts (512 KB a tile), the last
    # tile partial at full width, rows of R * 4 bytes that are not a
    # multiple of 16 at full length, 16 warps a block, the most stages
    ("full_c256_r256", 8, 2048, 4096, False, 256, 256),
    ("full_s2047_h0", 8, 2047, 4096, True, 128, 128),
    ("full_r4094_h0", 8, 2048, 4094, True, 128, 128),
    ("full_r512", 8, 2048, 4096, True, 128, 512),
    ("full_c32_r32", 8, 2048, 4096, False, 32, 32),
]


def plan_text(rg, S, R, chunk, r_block):
    """The kernel's launch plan for a shape and config, as printed."""
    p = rg.plan(S, R, chunk, r_block)
    return (f"plan: cp.async ring of {p['stages']} tiles of {p['depth']} "
            f"steps, {p['smem']} B smem, {p['threads']} threads")


def rglru_inputs(B, S, R, h0, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    la = -torch.randn((B, S, R), generator=g, device="cuda").abs() * 0.1
    b = torch.randn((B, S, R), generator=g, device="cuda")
    return la, b, (torch.randn((B, R), generator=g, device="cuda")
                   if h0 else None)


def phase_rglru(rg):
    """B5 against its plain version; the planted fault at full width."""
    import torch
    errs = {}
    for i, (name, B, S, R, h0, chunk, r_block) in enumerate(RGLRU_CHECKS):
        x = rglru_inputs(B, S, R, h0, 700 + i)
        got = rg.rglru_scan(*x, chunk=chunk, r_block=r_block)
        torch.cuda.synchronize()
        ref = rg.rglru_reference(*x)
        torch.cuda.synchronize()
        ok, e, need = compare_grads(got, ref, RGLRU_TOL)
        errs[name] = max(e[0][0], e[1][0])
        print(f"[kernel] rglru {name:16s} B={B} S={S} R={R} h0={h0} "
              f"chunk={chunk} r_block={r_block} "
              f"({plan_text(rg, S, R, min(chunk, S), min(r_block, R))}): "
              f"max|err| "
              f"{tol_line(['h', 'h_last'], e, need, RGLRU_TOL)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"rglru disagrees with its plain version at {name}")
        if name == "full":
            la = x[0].clone()
            la[:, S // 2] = float("-inf")        # step S/2 drops its carry
            fault = rg.rglru_reference(la, *x[1:])
            passed, fe, fneed = compare_grads(fault, ref, RGLRU_TOL)
            print(f"[kernel] planted rglru fault at {name} (step {S // 2} "
                  f"without its carry): max|err| "
                  f"{tol_line(['h', 'h_last'], fe, fneed, RGLRU_TOL)} "
                  f"{'MISSED' if passed else 'caught'}", flush=True)
            check(not passed, "the rglru check misses a dropped carry")
            del fault, la
        del x, got, ref
    return errs


def reset_all(counters):
    """Set every launch counter, [(kernel id, module, attribute)], to 0."""
    for _, mod, attr in counters:
        setattr(mod, attr, 0)


def read_all(counters):
    import torch
    torch.cuda.synchronize()
    return {kid: getattr(mod, attr) for kid, mod, attr in counters}


def phase_tuner(counters, ml, rg, tune, findb, ops, groundtruth):
    """The slice's main path: the kernel tuner on both full-width
    workloads, launch counters read around it; then the warm find-db path
    and the ops resolving to the winners."""
    import torch
    db = groundtruth.KernelConfigDB()
    reset_all(counters)
    summaries = [tune.tune_kernel(w, db=db, scheduler="grid", reps=3,
                                  warmup=1, device="cuda")
                 for w in (MLSTM_WORKLOAD, RGLRU_WORKLOAD)]
    counts = read_all(counters)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    groundtruth.export_golden(db.rows(), str(GOLDEN))
    for smry, want in zip(summaries, (4, 16)):
        print(f"[tune] {smry['workload']}: {smry['trials']} trials, winner "
              f"{smry['winner']} at {smry['winner_s'] * 1e3:.4f} ms against "
              f"default {tune.BASELINES[smry['kernel']]} at "
              f"{smry['default_s'] * 1e3:.4f} ms (spread "
              f"{smry['spread']:.2%}); stored {smry['config']} at "
              f"{smry['tuned_s'] * 1e3:.4f} ms, speedup "
              f"{smry['speedup']:.3f}x, hardware {smry['hardware']}, "
              f"tuning {smry['tuning_time_s']:.3f} s of kernel time in "
              f"{smry['wall_time_s']:.2f} s, kernel calls "
              f"{smry['kernel_calls'][smry['kernel']]}", flush=True)
        check(smry["source"] == "tuned" and smry["trials"] == want,
              f"{smry['workload']}: expected {want} trials, got "
              f"{smry['trials']}")
        check(smry["hardware"].startswith("cuda/")
              and "h100" in smry["hardware"],
              f"hardware key {smry['hardware']}")
        check(db.get(smry["kernel"], smry["shape"], smry["hardware"])
              == smry["config"], "the stored config is not in the find-db")
    calls = {"mlstm": summaries[0]["kernel_calls"]["mlstm"],
             "rglru": summaries[1]["kernel_calls"]["rglru"]}
    print(f"[tune] launches over the tuner run: {counts}; kernel calls the "
          f"backend timed: {calls}", flush=True)
    check(counts["B4"] == calls["mlstm"] > 0
          and counts["B5"] == calls["rglru"] > 0,
          "B4/B5 launches differ from the calls the tuner timed")
    check(counts["B1"] == counts["B2"] == counts["B3"] == 0,
          "the tuner launched an attention kernel")
    rows = groundtruth.load_golden(str(GOLDEN))
    check(len(rows) == 2, f"golden table holds {len(rows)} rows")

    reset_all(counters)
    warm = [tune.tune_kernel(w, db=db, device="cuda")
            for w in (MLSTM_WORKLOAD, RGLRU_WORKLOAD)]
    warm_counts = read_all(counters)
    print(f"[tune] second run: {[(w['source'], w['trials']) for w in warm]}"
          f", launches {warm_counts}", flush=True)
    check(all(w["source"] == "find-db" and w["trials"] == 0
              and w["config"] == s_["config"]
              for w, s_ in zip(warm, summaries)), "the warm run re-tuned")
    check(not any(warm_counts.values()), "the warm run launched a kernel")

    # ops with chunk=None on an empty find-db (the defaults), on the golden
    # table (the winners), and on a db holding configs that differ from
    # both, so that each lookup shows whether it hit its row
    winners = [smry["config"] for smry in summaries]
    other = [{"chunk": next(c for c in (64, 32) if c != winners[0]["chunk"])},
             next({"chunk": c, "r_block": r} for c in (64, 32)
                  for r in (256, 32) if (c, r) != (winners[1]["chunk"],
                                                  winners[1]["r_block"]))]
    planted = groundtruth.KernelConfigDB()
    for smry, cfg in zip(summaries, other):
        planted.put(smry["kernel"], smry["shape"], cfg,
                    hardware=smry["hardware"])
    seen = []
    launch_ml, launch_rg = ml._launch, rg._launch
    ml._launch = lambda *a: seen.append(("mlstm", {"chunk": a[-1]})) or \
        launch_ml(*a)
    rg._launch = lambda *a: seen.append(
        ("rglru", {"chunk": a[-2], "r_block": a[-1]})) or launch_rg(*a)
    golden = groundtruth.KernelConfigDB()
    golden.merge_rows(rows)
    x = mlstm_inputs(*MLSTM_SHAPE, torch.float32, 800)
    y = rglru_inputs(*RGLRU_SHAPE, True, 801)
    prev = findb.get_find_db()
    try:
        for db_ in (groundtruth.KernelConfigDB(), golden, planted):
            findb.set_find_db(db_)
            ops.mlstm(*x)
            ops.rglru(*y)
        torch.cuda.synchronize()
    finally:
        findb.set_find_db(prev)
        ml._launch, rg._launch = launch_ml, launch_rg
    want = []
    for cfgs in ([findb.DEFAULTS["mlstm"], findb.DEFAULTS["rglru"]], winners,
                 other):
        want += [("mlstm", dict(cfgs[0])), ("rglru", dict(cfgs[1]))]
    print(f"[tune] ops with chunk=None on an empty db, the golden table and "
          f"a db of other configs launched {seen} (expected {want})",
          flush=True)
    check(seen == want, "ops do not resolve to the find-db's configs")
    return summaries, counts


def mlstm_bound(B, S, H, D, itemsize):
    """The least work of the function at any chunk size: at chunk 1 (the
    recurrent form), per step and head, q C and the rank-one update of C
    (4 D^2) and q k, a v, q n and the update of n (8 D)."""
    flops = B * H * S * (4.0 * D * D + 8.0 * D)
    nbytes = 4 * B * S * H * D * itemsize + 2 * B * S * H * 4
    return bound(flops, nbytes, PEAK_FP32_FLOPS)


def rglru_bound(B, S, R):
    return bound(2.0 * B * S * R, 3 * B * S * R * 4 + B * R * 4,
                 PEAK_FP32_FLOPS)


def rglru_rate(B, S, R, ms):
    """TB/s reached: log_a and b read once, h and h_last written once."""
    return (12 * B * S * R + 4 * B * R) / (ms * 1e-3) / 1e12


def phase_recurrent_timing(build, ml, rg, summaries, card):
    """B4 and B5 at full width, default config and the winner; B5 at each
    config of the grid, with its plan, held against its plain version."""
    import torch
    rows = {}
    x = mlstm_inputs(*MLSTM_SHAPE, torch.float32, 900)
    plain_ms = cuda_ms(lambda: ml.mlstm_chunkwise_reference(x[0], *x[1:],
                                                            chunk=128),
                       iters=1)
    lib = build.load("mlstm")
    for label, cfg in (("default", {"chunk": 128}),
                       ("tuned", summaries[0]["config"])):
        ms = cuda_ms(lambda: ml.mlstm_chunkwise(*x, chunk=cfg["chunk"]),
                     iters=10)
        bound_ms, bound_by = mlstm_bound(*MLSTM_SHAPE, 4)
        cluster = lib.mlstm_cluster_size(*MLSTM_SHAPE, cfg["chunk"], 4)
        print(f"[timing] {card} | mlstm B,S,H,D={MLSTM_SHAPE} fp32 {label} "
              f"{cfg}, clusters of {cluster}: kernel {ms:.4f} ms "
              f"({ms.spread()}), bound "
              f"{bound_ms:.4f} ms ({bound_by}, fp32 CUDA-core peak), plain "
              f"(chunk 128) {plain_ms:.4f} ms ({plain_ms.spread()}), library "
              f"none", flush=True)
        rows[("mlstm", label)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=None)
    grid = {c: cuda_ms(lambda: ml.mlstm_chunkwise(*x, chunk=c), iters=5)
            for c in (32, 64, 128, 256)}
    print(f"[timing] {card} | mlstm every chunk of the grid: "
          + ", ".join(f"{c} {t:.4f} ms ({t.lo:.4f}-{t.hi:.4f})"
                      for c, t in grid.items()), flush=True)
    del x
    y = rglru_inputs(*RGLRU_SHAPE, False, 901)
    B, S, R = RGLRU_SHAPE
    plain_ms = cuda_ms(lambda: rg.rglru_reference(*y), iters=1)
    bound_ms, bound_by = rglru_bound(*RGLRU_SHAPE)
    for label, cfg in (("default", {"chunk": 128, "r_block": 128}),
                       ("tuned", summaries[1]["config"])):
        ms = cuda_ms(lambda: rg.rglru_scan(*y, **cfg), iters=20)
        print(f"[timing] {card} | rglru B,S,R={RGLRU_SHAPE} fp32 {label} "
              f"{cfg} ({plan_text(rg, S, R, cfg['chunk'], cfg['r_block'])})"
              f": kernel {ms:.4f} ms ({ms.spread()}), "
              f"{rglru_rate(B, S, R, ms):.3f} TB/s, bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms "
              f"({plain_ms.spread()}), library none", flush=True)
        rows[("rglru", label)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=None)
    out = torch.empty_like(y[0])
    ms = cuda_ms(lambda: torch.add(y[0], y[1], out=out), iters=20)
    print(f"[timing] {card} | torch.add over B5's bytes (two fp32 inputs "
          f"read, one written; not B5's function): {ms:.4f} ms "
          f"({ms.spread()}), {rglru_rate(B, S, R, ms):.3f} TB/s", flush=True)
    del out
    ref = rg.rglru_reference(*y)
    for c in (32, 64, 128, 256):
        for r in (32, 64, 128, 256):
            ms = cuda_ms(lambda: rg.rglru_scan(*y, chunk=c, r_block=r),
                         iters=10)
            ok, e, need = compare_grads(rg.rglru_scan(*y, chunk=c, r_block=r),
                                        ref, RGLRU_TOL)
            print(f"[timing] {card} | rglru grid chunk={c} r_block={r} "
                  f"({plan_text(rg, S, R, c, r)}): {ms:.4f} ms "
                  f"({ms.lo:.4f}-{ms.hi:.4f}), "
                  f"{rglru_rate(B, S, R, ms):.3f} TB/s; needs a >= "
                  f"{need:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"rglru disagrees with its plain version at chunk={c} "
                  f"r_block={r}")
    del ref
    return rows


def power_draw_w() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def record_steps(be, ts, sys_cfg):
    """Log (loss, accuracy) of every step ``run_epoch`` takes: the backend's
    cached train step for ``sys_cfg`` is wrapped in place."""
    (step, ev), _ = be.get_step(ts, sys_cfg)
    step = getattr(step, "inner", step)
    log = []

    def recorded(*args):
        out = step(*args)
        log.append((float(out[2]), float(out[3])))
        return out
    recorded.inner = step
    be._step_cache[be._step_key(ts, be._effective_sys(ts, sys_cfg))] = \
        (recorded, ev)
    return log


def loop_epoch(be, name, sys_cfg, fault=False):
    """One epoch of a fresh trial (seed 0): (per-step log, EpochResult).
    ``fault`` drops the LSTM's +1.0 forget bias (b's f slice less 1)."""
    ts = be.init_trial(name, LOOP_HPARAMS, seed=0)
    if fault:
        H = ts.cfg.hidden
        ts.params["b"][H:2 * H] -= 1.0
    log = record_steps(be, ts, sys_cfg)
    _, res = be.run_epoch(ts, sys_cfg)
    return log, res


def card_cpu_distance(cpu, card, batch):
    """(worst |loss diff| / (1 + |loss_cpu|) over the steps, worst step
    accuracy diff in samples, eval accuracy diff in samples)."""
    (clog, cres), (glog, gres) = cpu, card
    loss = max(abs(g[0] - c[0]) / (1 + abs(c[0])) for c, g in zip(clog, glog))
    acc = max(abs(g[1] - c[1]) for c, g in zip(clog, glog)) * batch
    ev = abs(gres.accuracy - cres.accuracy) * LOOP_SIZES["n_eval"]
    return loss, acc, ev


def profile_steps(be, name, steps=3):
    """Device busy time against wall time over ``steps`` train steps of a
    warm trial at the default config (torch.profiler): (wall ms, busy ms,
    launches, the kernel with the most device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ts = be.init_trial(name, LOOP_HPARAMS, seed=0)
    (train_step, _), _ = be.get_step(ts, LOOP_DEFAULT_SYS)
    batch = be._to_device({k: v[:LOOP_HPARAMS["batch_size"]]
                           for k, v in next(ts.data.epoch(0)).items()})
    state = [ts.params, ts.opt_state]

    def run():
        state[0], state[1], _, _ = train_step(state[0], state[1], 0, batch,
                                              0)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = max(kernels, key=lambda e: e.self_device_time_total)
    return wall, busy, sum(e.count for e in kernels), top


def phase_tuneloop(counters, card, idle_w):
    """PipeTune's own loop on the paper's Table-3 workloads: card against
    CPU per step (with a planted fault), the whole "real" sys space, Table
    2 through Experiment, the tuning launcher; no B1-B5 launch."""
    import numpy as np
    from repro_torch.api import Experiment, registry
    from repro_torch.core import energy
    from repro_torch.core.backends import TorchRealBackend
    from repro_torch.core.groundtruth import GroundTruth
    from repro_torch.core.job import HPTJob, Param, SearchSpace
    from repro_torch.launch import tune as tune_launch
    t_phase = time.perf_counter()
    reset_all(counters)
    print(f"[tuneloop] {card} | energy model: P_IDLE_W {energy.P_IDLE_W:.2f}"
          f" W, P_DYN_W {energy.P_DYN_W:.2f} W; this card's power.draw at "
          f"the start of the run (idle) {idle_w:.2f} W", flush=True)

    # 1. card against CPU, one fp32 epoch of each workload
    cpu_be = TorchRealBackend(**LOOP_SIZES, device="cpu")
    card_be = TorchRealBackend(**LOOP_SIZES, device="cuda")
    bs = LOOP_HPARAMS["batch_size"]
    for name in PAPER_WORKLOADS:
        cpu = loop_epoch(cpu_be, name, LOOP_DEFAULT_SYS)
        got = card_cpu_distance(cpu, loop_epoch(card_be, name,
                                                LOOP_DEFAULT_SYS), bs)
        print(f"[tuneloop] card vs CPU {name}: {len(cpu[0])} steps, loss "
              f"{cpu[0][0][0]:.4f} -> {cpu[0][-1][0]:.4f}, worst step loss "
              f"distance {got[0]:.3e} (limit {CARD_CPU_TOL:.0e}), step "
              f"accuracy {got[1]:.1f} samples, eval accuracy {got[2]:.1f} "
              f"samples (limit 1.5)", flush=True)
        check(got[0] <= CARD_CPU_TOL and got[1] <= 1.5 and got[2] <= 1.5,
              f"{name}: the card's epoch differs from the CPU's: {got}")
        if name == "lstm-news20":
            bad = card_cpu_distance(cpu, loop_epoch(card_be, name,
                                                    LOOP_DEFAULT_SYS,
                                                    fault=True), bs)
            print(f"[tuneloop] planted fault (LSTM without the +1.0 forget "
                  f"bias, card side only): worst step loss distance "
                  f"{bad[0]:.3e}", flush=True)
            check(bad[0] > CARD_CPU_TOL,
                  "the card-vs-CPU check misses the dropped forget bias")

    # 2. the whole "real" sys space on the card
    space = registry.default_sys_space("real", device="cuda").configs()
    check(len(space) == 12, f"the real sys space has {len(space)} configs")
    for name in PAPER_WORKLOADS:
        be = TorchRealBackend(**LOOP_SIZES, device="cuda")
        last = {}
        for cfg in space:
            _, res = loop_epoch(be, name, cfg)
            key = (cfg["remat"], cfg["microbatches"])
            last[key, cfg["precision"]] = res.loss
            print(f"[tuneloop] {card} | {name} remat={cfg['remat']} "
                  f"microbatches={cfg['microbatches']} "
                  f"{cfg['precision']}: {np.median(res.step_times) * 1e3:.3f}"
                  f" ms/step (median of {len(res.step_times)}), compile_s "
                  f"{res.compile_s:.3f}, final loss {res.loss:.4f}",
                  flush=True)
            check(all(np.isfinite([res.loss, res.accuracy])),
                  f"{name} {cfg}: loss {res.loss}")
        worst = max(abs(last[k, "bf16"] - last[k, "fp32"])
                    / (1 + abs(last[k, "fp32"])) for k, _ in last)
        print(f"[tuneloop] {name}: bf16 against fp32, worst final-loss "
              f"distance {worst:.3e} (limit {BF16_LOSS_TOL})", flush=True)
        check(worst <= BF16_LOSS_TOL, f"{name}: bf16 ends {worst} from fp32")

    # where a trial epoch's time goes: device busy against wall
    be = TorchRealBackend(**LOOP_SIZES, device="cuda")
    for name in PAPER_WORKLOADS:
        wall, busy, n, top = profile_steps(be, name)
        print(f"[tuneloop] {card} | profile {name} (3 steps, remat none, 1 "
              f"microbatch, fp32): wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}, {n} kernel "
              f"launches; top kernel {top.key[:60]} "
              f"{top.self_device_time_total / 1e3:.3f} ms x{top.count}",
              flush=True)

    # 3. Table 2 on the card (benchmarks/table2.py, quick)
    job = HPTJob(workload="lenet-mnist", space=SearchSpace([
        Param("batch_size", "choice", choices=(32, 64)),
        Param("dropout", "float", 0.0, 0.5),
        Param("learning_rate", "log", 0.001, 0.1)]), max_epochs=6, seed=0)
    sizes = dict(n_train=768, n_eval=192, steps_per_epoch=6)

    def backend():
        return TorchRealBackend(**sizes, device="cuda")
    rows = {}
    arb = Experiment(job).with_tuner("v1").with_backend(backend())
    rec = arb.build_runner().run_trial(
        "lenet-mnist", "arbitrary",
        {"batch_size": 64, "learning_rate": 0.08, "dropout": 0.45}, 6)
    rows["Arbitrary"] = (rec.accuracy, rec.train_time, 0.0, rec.energy, "")
    for label, tuner in (("TuneV1", "v1"), ("TuneV2", "v2"),
                         ("PipeTune", "pipetune")):
        t0 = time.perf_counter()
        exp = (Experiment(job)
               .with_tuner(tuner, **({"max_probes": 4}
                                     if tuner == "pipetune" else {}))
               .with_backend(backend())
               .with_sys_space(registry.default_sys_space(
                   "real", device="cuda"))
               .with_scheduler("random", n_trials=6))
        if tuner == "pipetune":
            exp = exp.with_groundtruth(GroundTruth())
        res = exp.run()
        gt = (f", ground truth {res.gt_hits} hits / {res.gt_misses} misses"
              if tuner == "pipetune" else "")
        rows[label] = (res.best_accuracy, res.best_train_time,
                       res.tuning_time_s, res.energy_j,
                       f", {len(res.records)} trials, wall "
                       f"{time.perf_counter() - t0:.2f} s{gt}")
    for label, (acc, train_s, tune_s, e, extra) in rows.items():
        print(f"[tuneloop] {card} | table2 lenet-mnist {label}: accuracy "
              f"{acc:.4f}, training time {train_s:.3f} s, tuning time "
              f"{tune_s:.3f} s, modeled energy {e:.1f} J{extra}", flush=True)
    gap = abs(rows["PipeTune"][0] - rows["TuneV1"][0])
    check(gap <= TABLE2_ACC_TOL,
          f"PipeTune's accuracy is {gap:.4f} from TuneV1's")

    # 4. the tuning launcher with its defaults
    for name in PAPER_WORKLOADS:
        t0 = time.perf_counter()
        res = tune_launch.main(["--workload", name])
        print(f"[tuneloop] {card} | launcher {name}: best accuracy "
              f"{res.best_accuracy:.4f}, tuning time {res.tuning_time_s:.3f} "
              f"s, {len(res.records)} trials, ground truth {res.gt_hits} / "
              f"{res.gt_misses}, wall {time.perf_counter() - t0:.2f} s",
              flush=True)
        check(len(res.records) > 0 and np.isfinite(res.best_accuracy),
              f"launcher {name}: {res.best_accuracy}")

    counts = read_all(counters)
    print(f"[tuneloop] launches of B1-B5 over the phase: {counts}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(not any(counts.values()), "the tuning loop launched a kernel")


def busy_union_ms(prof):
    """(device busy ms, device activities) over a torch.profiler window:
    the union of the intervals of every device activity (kernels, copies,
    sets), so that kernels of two lanes that overlap count once."""
    from torch.autograd import DeviceType
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6, len(spans)


def logged_backend(fault=False):
    """A card ``TorchRealBackend`` at the launcher's sizes that logs every
    step's loss per trial (``.losses[id(TrialState)]``). ``fault`` plants a
    lane fault: the first trial it starts draws its batches in another
    order (the batch generator of the next seed, a wave-mate's stream)."""
    import dataclasses
    from repro_torch.core.backends import TorchRealBackend

    class Logged(TorchRealBackend):
        def __init__(self):
            super().__init__(**LOOP_SIZES, device="cuda")
            self.losses = {}
            self.planted = None

        def init_trial(self, workload, hparams, seed=0):
            ts = super().init_trial(workload, hparams, seed=seed)
            if fault and self.planted is None:
                self.planted = id(ts)
                ts.data = dataclasses.replace(ts.data, seed=ts.data.seed + 1)
            return ts

        def get_step(self, ts, sys_cfg):
            (step, ev), dt = super().get_step(ts, sys_cfg)
            log = self.losses.setdefault(id(ts), [])

            def logged(*args):
                out = step(*args)
                log.append(float(out[2]))
                return out
            return (logged, ev), dt
    return Logged()


class EpochWaves:
    """Ask/tell scheduler over fixed trials: releases every trial one epoch
    at a time (wave e trains them all to epoch e), so a trial's epochs may
    land on different lanes; ``on_last_wave`` runs before the last wave is
    released. The best trial is the best final score."""

    def __init__(self, proposals, epochs, on_last_wave):
        self.proposals, self.epochs = proposals, epochs
        self.on_last_wave = on_last_wave
        self.epoch, self.waiting, self.scores = 0, set(), {}

    def suggest(self):
        from repro_torch.core.schedulers import TrialProposal
        if self.waiting or self.epoch == self.epochs:
            return []
        self.epoch += 1
        if self.epoch == self.epochs:
            self.on_last_wave()
        self.waiting = {p.trial_id for p in self.proposals}
        return [TrialProposal(p.trial_id, p.hparams, self.epoch)
                for p in self.proposals]

    def report(self, trial_id, score):
        self.waiting.discard(trial_id)
        self.scores[trial_id] = score

    def best(self):
        tid = max(self.scores, key=self.scores.get)
        return next(p.hparams for p in self.proposals
                    if p.trial_id == tid), self.scores[tid]


def par_run(name, lanes, fault=False, prof_mode="last"):
    """TuneV1's policy at LOOP_DEFAULT_SYS over PAR_TRIALS random-search
    trials (batch 64) trained to PAR_EPOCHS, one epoch a wave
    (``EpochWaves``), on ``lanes`` thread lanes (1: the serial executor).
    ``prof_mode`` places torch.profiler (device activity only): "last"
    starts it before the last wave is released, "midwave" from a thread
    of its own PAR_MIDWAVE_S into the last wave, "off" runs none. Returns
    (result, {trial: step losses}, wall s, wall s of the waves before the
    last, (window s, busy ms, device activities) or None)."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import make_executor
    from repro_torch.core.job import HPTJob, Param, SearchSpace
    from repro_torch.core.pipetune import TuneV1
    from repro_torch.core.schedulers import RandomSearch
    import torch

    class FixedSysV1(TuneV1):
        def sys_for_epoch(self, record, state, epoch, prev):
            return dict(LOOP_DEFAULT_SYS)
    space = SearchSpace([
        Param("batch_size", "choice", choices=(64,)),
        Param("learning_rate", "log", 0.001, 0.1),
        Param("dropout", "float", 0.0, 0.5)])
    job = HPTJob(workload=name, space=space, max_epochs=PAR_EPOCHS, seed=0)
    prof = None if prof_mode == "off" else \
        profile(activities=[ProfilerActivity.CUDA])
    window = {}

    def start():
        prof.start()
        window["t0"] = time.perf_counter()

    def midwave(done):
        # starts and stops the profiler on a thread of its own
        if not done.wait(PAR_MIDWAVE_S):
            start()
            done.wait()
            prof.stop()

    def last_wave():
        window["last"] = time.perf_counter()
        if prof_mode == "last":
            start()
        elif prof_mode == "midwave":
            window["done"] = threading.Event()
            window["thread"] = threading.Thread(target=midwave,
                                                args=(window["done"],))
            window["thread"].start()
    sched = EpochWaves(RandomSearch(space, n_trials=PAR_TRIALS,
                                    epochs=PAR_EPOCHS, seed=0).suggest(),
                       PAR_EPOCHS, last_wave)
    be = logged_backend(fault)
    runner = FixedSysV1(be)
    ex = make_executor(lanes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = runner.run_job(job, scheduler=sched, executor=ex)
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        ex.close()
        if "thread" in window:
            window["done"].set()
            window["thread"].join()
        elif "t0" in window:
            prof.stop()
    spans = (end - window["t0"], *busy_union_ms(prof)) \
        if "t0" in window else None
    losses = {tid: be.losses[id(st)] for tid, st in runner.states.items()}
    return res, losses, end - t0, window["last"] - t0, spans


def prof_text(window):
    if window is None:
        return "profiler off"
    span, busy, n = window
    return (f"over its last wave ({span:.3f} s): device busy {busy:.1f} "
            f"ms, idle share {1 - busy / (span * 1e3):.3f}, {n} device "
            "activities")


def par_distance(res, losses, ref, ref_losses):
    """(worst per-step loss distance, worst eval accuracy distance in
    samples, hparams equal) of a run against the serial one."""
    worst, acc = 0.0, 0.0
    for tid, rec in ref.records.items():
        got = losses[tid]
        want = ref_losses[tid]
        if len(got) != len(want):
            return float("inf"), float("inf"), False
        worst = max([worst] + [abs(g - w) / (1 + abs(w))
                               for g, w in zip(got, want)])
        acc = max([acc] + [abs(a.accuracy - b.accuracy)
                           * LOOP_SIZES["n_eval"] for a, b in
                           zip(res.records[tid].epochs, rec.epochs)])
    same_hp = {t: r.hparams for t, r in res.records.items()} == \
        {t: r.hparams for t, r in ref.records.items()}
    return worst, acc, same_hp


def par_text(run, base, what):
    """One (a) run's readings against the serial run ``base``, checked:
    the same hparams, every step's loss within PAR_LOSS_TOL and eval
    accuracy within PAR_ACC_SAMPLES of serial. Wall time, speedup and
    ms/step are those of the waves before the last (no profiler ran)."""
    import numpy as np
    res, losses, wall, early, window = run
    steps = [t for r in res.records.values() for e in r.epochs[:-1]
             for t in e.step_times]
    trial_s = sum(e.duration_s for r in res.records.values()
                  for e in r.epochs[:-1])
    dist = par_distance(res, losses, base[0], base[1])
    check(dist[2] and dist[0] <= PAR_LOSS_TOL
          and dist[1] <= PAR_ACC_SAMPLES,
          f"{what} differs from serial: {dist}")
    speed = "" if run is base else \
        f", speedup over serial {base[3] / early:.3f}x"
    return (f"waves 1-{PAR_EPOCHS - 1} (no profiler): wall {early:.3f} s, "
            f"trial time {trial_s:.3f} s, {len(steps)} steps at "
            f"{np.median(steps) * 1e3:.3f} ms/step median (p90 "
            f"{np.percentile(steps, 90) * 1e3:.3f}){speed}; whole run "
            f"{wall:.3f} s, tuning time {res.tuning_time_s:.3f} s; "
            f"{prof_text(window)}; against serial: worst step loss "
            f"{dist[0]:.3e} (limit {PAR_LOSS_TOL:.0e}), eval accuracy "
            f"{dist[1]:.1f} samples (limit {PAR_ACC_SAMPLES})")


def lane_probe(mode, reps, card):
    """``--lane-probe``'s child: (a)'s runs ``reps`` times in one process,
    with the profiler off ("off": serial, 2 and 4 lanes on each workload)
    or started mid-wave ("midwave": 4 lanes, held against a serial run
    with the profiler off). A crash ends the process. "serial" times
    ``reps`` epochs of one trial at LOOP_HPARAMS on the main thread, no
    executor: the step that (a) starts from, which a tree without lanes
    runs too."""
    import numpy as np
    if mode == "serial":
        for name in PAR_WORKLOADS:
            be = logged_backend()
            ts = be.init_trial(name, LOOP_HPARAMS)
            for rep in range(reps + 1):         # the first epoch warms up
                ts, r = be.run_epoch(ts, LOOP_DEFAULT_SYS)
                if rep:
                    print(f"[probe] {card} | serial {name} epoch {rep}/"
                          f"{reps} at {LOOP_HPARAMS} on the main thread: "
                          f"{np.median(r.step_times) * 1e3:.3f} ms/step "
                          f"median of {len(r.step_times)}", flush=True)
        return
    for name in PAR_WORKLOADS:
        be = logged_backend()
        be.run_epoch(be.init_trial(name, LOOP_HPARAMS), LOOP_DEFAULT_SYS)
    for rep in range(reps):
        for name in PAR_WORKLOADS:
            base = par_run(name, 1, prof_mode="off")
            lanes = PAR_LANES[1:] if mode == "off" else PAR_LANES[-1:]
            for n in (1, *lanes):
                run = base if n == 1 else par_run(name, n, prof_mode=mode)
                what = f"{mode} rep {rep + 1}/{reps} {name} on {n} lane(s)"
                print(f"[probe] {card} | {what}: {par_text(run, base, what)}",
                      flush=True)


def run_lane_probe(card, reps):
    """Each profiler mode in a process of its own, so that a crash in one
    is told apart from the other; prints each child's exit code."""
    codes = {}
    for mode in ("off", "midwave"):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--lane-probe-child",
                              mode, str(reps)], timeout=900)
        codes[mode] = out.returncode
        print(f"[probe] {card} | mode {mode}: exit {out.returncode} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"lane_probe": codes, "reps": reps}))
    return 0 if not any(codes.values()) else 1


def phase_parallel(counters, card):
    """Trials run concurrently: TuneV1 serially and on 2 and 4 thread
    lanes (one CUDA stream each) against the serial run, step by step,
    with a planted lane fault; PipeTune + hyperband on 4 lanes through the
    launcher; the sim launcher on the serial, parallel and cluster
    executors; no B1-B5 launch."""
    import io
    import numpy as np
    from repro_torch.launch import tune as tune_launch
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    reset_all(counters)
    with profile(activities=[ProfilerActivity.CUDA]):
        pass                    # the profiler's one-time set-up, untimed

    # (a) serial against lanes, with the card's busy share over each run
    serial = {}
    for name in PAR_WORKLOADS:
        be = logged_backend()                    # warm the config's kernels
        _, warm = be.run_epoch(be.init_trial(name, LOOP_HPARAMS),
                               LOOP_DEFAULT_SYS)
        print(f"[parallel] {card} | {name} warm-up epoch at "
              f"{LOOP_HPARAMS} on the main thread: "
              f"{len(warm.step_times)} steps at "
              f"{np.median(warm.step_times) * 1e3:.3f} ms/step median",
              flush=True)
        for lanes in PAR_LANES:
            run = par_run(name, lanes)
            serial.setdefault(name, run)
            print(f"[parallel] {card} | {name} TuneV1 random "
                  f"{PAR_TRIALS}x{PAR_EPOCHS} (an epoch a wave) at remat "
                  f"none, 1 microbatch, fp32 on {lanes} lane(s): "
                  f"{par_text(run, serial[name], f'{name} on {lanes}')}",
                  flush=True)

    # (c) a planted lane fault must fail (a)'s check
    # (c) a planted lane fault must fail (a)'s check
    name = PAR_WORKLOADS[0]
    print(f"[parallel] (a) {time.perf_counter() - t_phase:.1f} s into the "
          "phase", flush=True)
    bad = par_run(name, PAR_LANES[-1], fault=True, prof_mode="off")
    dist = par_distance(bad[0], bad[1], *serial[name][:2])
    print(f"[parallel] planted fault (one trial on {PAR_LANES[-1]} lanes "
          f"draws its batches in a wave-mate's order): worst step loss "
          f"{dist[0]:.3e}", flush=True)
    check(dist[0] > PAR_LOSS_TOL, "the lane check misses a planted fault")

    print(f"[parallel] (c) {time.perf_counter() - t_phase:.1f} s into the "
          "phase", flush=True)

    # (b) PipeTune + hyperband through the launcher, serial and 4 lanes
    got = {}
    for flags in ([], ["--parallelism", "4"]):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = tune_launch.main(["--workload", "lenet-mnist", "--epochs",
                                    str(PAR_EPOCHS), *flags])
        got[len(flags)] = res
        print(f"[parallel] {card} | launcher lenet-mnist pipetune "
              f"hyperband {PAR_EPOCHS} epochs {' '.join(flags) or 'serial'}: "
              f"best accuracy "
              f"{res.best_accuracy:.4f}, tuning time {res.tuning_time_s:.3f}"
              f" s, {len(res.records)} trials, ground truth {res.gt_hits} / "
              f"{res.gt_misses}, wall {time.perf_counter() - t0:.2f} s",
              flush=True)
        check(res.gt_hits + res.gt_misses == len(res.records),
              f"hits + misses != trials: {res.gt_hits} + {res.gt_misses} "
              f"!= {len(res.records)}")
    gap = abs(got[2].best_accuracy - got[0].best_accuracy)
    check(gap <= TABLE2_ACC_TOL,
          f"PipeTune on 4 lanes is {gap:.4f} from serial in accuracy")

    print(f"[parallel] (b) {time.perf_counter() - t_phase:.1f} s into the "
          "phase", flush=True)

    # (d) the sim launcher: the same numbers on every executor
    printed = {}
    for flags in ([], ["--parallelism", "4"], ["--executor", "cluster"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tune_launch.main(SIM_LAUNCH + flags)
        lines = out.getvalue().splitlines()
        printed[" ".join(flags) or "serial"] = lines
        for line in lines:
            print(f"[parallel] sim {' '.join(flags) or 'serial'}: {line}",
                  flush=True)
    body = {k: [ln for ln in v[1:] if "makespan" not in ln]
            for k, v in printed.items()}
    check(len({tuple(v) for v in body.values()}) == 1,
          f"the sim launcher's numbers differ between executors: {body}")
    spans = {k: [ln for ln in v if "makespan" in ln]
             for k, v in printed.items()}
    check(bool(spans["--executor cluster"]) and not spans["serial"]
          and not spans["--parallelism 4"],
          f"only the cluster executor prints a makespan: {spans}")

    # (e) no TPU kernel on this path
    counts = read_all(counters)
    phase_s = time.perf_counter() - t_phase
    print(f"[parallel] launches of B1-B5 over the phase: {counts}; phase "
          f"{phase_s:.1f} s (limit {PAR_PHASE_LIMIT_S:.0f} s)", flush=True)
    check(not any(counts.values()), "the parallel phase launched a kernel")
    check(phase_s < PAR_PHASE_LIMIT_S,
          f"the parallel phase took {phase_s:.1f} s")


def load_example(name):
    """An example script of the repo (``examples/<name>.py``) as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dropped(cfg):
    """The planted Type-III fault, as an fp32 epoch function: one jacobi
    sweep or one Lloyd step fewer an epoch; bfs skips its first epoch."""
    import dataclasses
    import torch
    from repro_torch.models import numeric
    if cfg.kind == "jacobi":
        return numeric._epoch_fn(dataclasses.replace(
            cfg, sweeps_per_epoch=cfg.sweeps_per_epoch - 1), torch.float32)
    if cfg.kind == "spkmeans":                   # sweeps // 4 Lloyd steps
        return numeric._epoch_fn(dataclasses.replace(
            cfg, sweeps_per_epoch=cfg.sweeps_per_epoch - 4), torch.float32)
    run, calls = numeric._epoch_fn(cfg, torch.float32), []

    def epoch(state):
        calls.append(None)
        if len(calls) == 1:
            return state, state["visited"].sum()
        return run(state)
    return epoch


def typeiii_epochs(name, device, fault=False):
    """TYPEIII_EPOCHS fp32 epochs of a fresh trial (seed 0) through
    TorchNumericBackend: per epoch, what the check holds (jacobi's x,
    spkmeans' centroids and assignments, bfs's visited) on the CPU, and the
    epoch's accuracy. ``fault`` runs ``dropped``'s epoch function."""
    import torch
    from repro_torch.core.numeric_backend import TorchNumericBackend
    from repro_torch.models import numeric
    be = TorchNumericBackend(device=device)
    cfg = numeric.CONFIGS[name]
    run = dropped(cfg) if fault else numeric._epoch_fn(cfg, torch.float32)
    auxes = []

    def epoch(state):
        state, aux = run(state)
        auxes.append(aux)
        return state, aux
    be._cache[(cfg.name, str(torch.float32))] = epoch
    ts = be.init_trial(name, {})
    out = []
    for _ in range(TYPEIII_EPOCHS):
        ts, res = be.run_epoch(ts, TYPEIII_SYS)
        held = {"jacobi": ("x",), "spkmeans": ("cents",),
                "bfs": ("visited",)}[cfg.kind]
        held = [ts.params[k] for k in held] + \
            ([auxes[-1]] if cfg.kind == "spkmeans" else [])
        out.append(([t.cpu() for t in held], res.accuracy))
    return out


def typeiii_distance(cpu, card):
    """(worst max|delta| / max|CPU value| of jacobi's x or spkmeans'
    centroids over the epochs, elements that differ among spkmeans'
    assignments or bfs's visited flags, worst accuracy difference)."""
    rel, mism, acc = 0.0, 0, 0.0
    for (want, a_want), (got, a_got) in zip(cpu, card):
        if want[0].is_floating_point():
            scale = float(want[0].abs().max())
            rel = max(rel, float((got[0] - want[0]).abs().max()) / scale)
            rest = zip(got[1:], want[1:])
        else:
            rest = zip(got, want)
        mism += sum(int((g != w).sum()) for g, w in rest)
        acc = max(acc, abs(a_got - a_want))
    return rel, mism, acc


def numeric_epoch_profile(be, name):
    """Device busy against wall time over one warm fp32 epoch
    (torch.profiler, device activity only, so that the host's time is not
    the profiler's; the union of device activity): (wall ms, busy ms,
    device activities)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ts = be.init_trial(name, {})
    ts, _ = be.run_epoch(ts, TYPEIII_SYS)                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.run_epoch(ts, TYPEIII_SYS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n = busy_union_ms(prof)
    return wall, busy, n


def phase_typeiii(counters, card):
    """The Type-III workloads on the card: card against CPU per epoch (with
    planted faults), bf16 against fp32, ms per epoch per sys config, the
    idle share of an epoch, the reference's Fig-12 run through Experiment,
    and the tuning launcher with --backend numeric; no B1-B5 launch."""
    import io
    import numpy as np
    from repro_torch.api import Experiment
    from repro_torch.core.groundtruth import GroundTruth
    from repro_torch.core.job import HPTJob, Param, SearchSpace
    from repro_torch.core.numeric_backend import TorchNumericBackend
    from repro_torch.launch import tune as tune_launch
    t_phase = time.perf_counter()
    reset_all(counters)

    # 1. card against CPU, every epoch, and the planted faults
    for name in TYPEIII:
        cpu = typeiii_epochs(name, "cpu")
        got = typeiii_distance(cpu, typeiii_epochs(name, "cuda"))
        bad = typeiii_distance(cpu, typeiii_epochs(name, "cuda", fault=True))
        print(f"[typeiii] card vs CPU {name}: {TYPEIII_EPOCHS} fp32 epochs, "
              f"accuracy {cpu[0][1]:.4f} -> {cpu[-1][1]:.4f}; worst "
              f"relative distance {got[0]:.3e} (limit {TYPEIII_TOL:.0e}), "
              f"{got[1]} assignments/flags differ, accuracy {got[2]:.3e}; "
              f"planted fault (one sweep / Lloyd step dropped, bfs's "
              f"first epoch skipped): "
              f"{bad[0]:.3e}, {bad[1]} differ", flush=True)
        check(got[0] <= TYPEIII_TOL and got[1] == 0 and got[2] <= 1e-6,
              f"{name}: the card's epochs differ from the CPU's: {got}")
        check(bad[0] > TYPEIII_TOL or bad[1] > 0,
              f"{name}: the card-vs-CPU check misses the planted fault")

    # 2. bf16 against fp32, and ms per epoch at each sys config
    be = TorchNumericBackend(device="cuda")
    for name in TYPEIII:
        accs = {}
        for prec in ("fp32", "bf16"):
            for mb in (1, 2):
                sys_cfg = {"remat": "none", "microbatches": mb,
                           "precision": prec}
                ts = be.init_trial(name, {})
                runs = []
                for _ in range(TYPEIII_EPOCHS):
                    ts, res = be.run_epoch(ts, sys_cfg)
                    runs += res.step_times
                    accs.setdefault((prec, mb), []).append(res.accuracy)
                print(f"[typeiii] {card} | {name} microbatches={mb} {prec}: "
                      f"{np.median(runs) * 1e3:.3f} ms per epoch-function "
                      f"run (median of {len(runs)}; first "
                      f"{runs[0] * 1e3:.3f}), {res.duration_s * 1e3:.3f} ms "
                      f"the last epoch, accuracy {res.accuracy:.4f}",
                      flush=True)
        gap = max(abs(b - f) for b, f in zip(accs["bf16", 1],
                                             accs["fp32", 1]))
        print(f"[typeiii] {name}: bf16 against fp32, worst epoch accuracy "
              f"distance {gap:.3e} (limit {TYPEIII_BF16_ACC})", flush=True)
        check(gap <= TYPEIII_BF16_ACC, f"{name}: bf16 {gap} from fp32")
        wall, busy, n = numeric_epoch_profile(be, name)
        print(f"[typeiii] {card} | profile {name} (one warm epoch, fp32, 1 "
              f"microbatch): wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}, {n} device activities",
              flush=True)

    # 3. the reference's Fig-12 run: TuneV1 against PipeTune
    space = SearchSpace([Param("block", "choice", choices=(1, 2))])
    gt = GroundTruth()
    ratios = []
    for name in TYPEIII:
        job = HPTJob(workload=name, space=space, max_epochs=FIG12_EPOCHS)
        runs = {}
        for tuner, kw in (("v1", {}), ("pipetune",
                                       {"max_probes": FIG12_PROBES})):
            exp = (Experiment(job).with_tuner(tuner, **kw)
                   .with_backend("numeric", device="cuda")
                   .with_scheduler("random", n_trials=FIG12_TRIALS))
            if tuner == "pipetune":
                exp = exp.with_groundtruth(gt)
            t0 = time.perf_counter()
            runs[tuner] = (exp.run(), time.perf_counter() - t0)
        (r1, w1), (rp, wp) = runs["v1"], runs["pipetune"]
        ratios.append(rp.tuning_time_s / max(r1.tuning_time_s, 1e-9))
        print(f"[typeiii] {card} | fig12 {name}: TuneV1 tuning time "
              f"{r1.tuning_time_s:.4f} s (accuracy {r1.best_accuracy:.4f}, "
              f"wall {w1:.2f} s), PipeTune {rp.tuning_time_s:.4f} s "
              f"(accuracy {rp.best_accuracy:.4f}, wall {wp:.2f} s, ground "
              f"truth {rp.gt_hits} hits / {rp.gt_misses} misses), ratio "
              f"{ratios[-1]:.3f}", flush=True)
        check(len(r1.records) == len(rp.records) == FIG12_TRIALS,
              f"fig12 {name}: {len(r1.records)}, {len(rp.records)} trials")
    print(f"[typeiii] {card} | fig12 tune_ratio_mean={np.mean(ratios):.3f}",
          flush=True)

    # 4. the tuning launcher, on the card by default
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = tune_launch.main(["--backend", "numeric", "--workload",
                                "jacobi-rodinia", "--scheduler", "random"])
    for line in out.getvalue().splitlines():
        print(f"[typeiii] launcher: {line}", flush=True)
    print(f"[typeiii] launcher wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(len(res.records) > 0 and res.best_accuracy > 0.3,
          f"the numeric launcher's best accuracy is {res.best_accuracy}")

    counts = read_all(counters)
    phase_s = time.perf_counter() - t_phase
    print(f"[typeiii] launches of B1-B5 over the phase: {counts}; phase "
          f"{phase_s:.1f} s (limit {TYPEIII_PHASE_LIMIT_S:.0f} s)",
          flush=True)
    check(not any(counts.values()), "the Type-III phase launched a kernel")
    check(phase_s < TYPEIII_PHASE_LIMIT_S,
          f"the Type-III phase took {phase_s:.1f} s")


def counted_lm_backend(example, fa, fa_bwd):
    """The example's LMBackend, recording per epoch (layers, sys config,
    steps, B1/B2/B3 launches) in ``log``."""
    class Counted(example.LMBackend):
        log = []

        def run_epoch(self, ts, sys_cfg, collect_profile=True):
            before = (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv)
            ts, res = super().run_epoch(ts, sys_cfg, collect_profile)
            after = (fa.launches, fa_bwd.launches_dq, fa_bwd.launches_dkv)
            self.log.append((ts.cfg.n_layers, dict(res.sys_config),
                             len(res.step_times),
                             tuple(a - b for a, b in zip(after, before)),
                             res.step_times))
            return ts, res
    return Counted


def lm_launches(log, what, card):
    """Print B1-B3 launches and ms/step per sys config over ``log`` and
    check each epoch against what it implies: per step, L x M launches of
    B2 and of B3, and of B1 once more under remat (the recompute)."""
    import numpy as np
    per = {}
    for layers, sys_cfg, steps, got, times in log:
        m = int(sys_cfg["microbatches"])
        fwd = 2 if sys_cfg["remat"] != "none" else 1
        want = (layers * m * fwd * steps, layers * m * steps,
                layers * m * steps)
        check(got == want, f"{what} {sys_cfg}: B1-B3 launched {got} in "
              f"{steps} steps, expected {want}")
        key = (sys_cfg["remat"], m, sys_cfg["precision"])
        ent = per.setdefault(key, [0, 0, 0, 0, []])
        for i in range(3):
            ent[i] += got[i]
        ent[3] += 1
        ent[4] += list(times)
    for (remat, m, prec), (b1, b2, b3, epochs, times) in sorted(per.items()):
        print(f"[lmtune] {card} | {what} remat={remat} microbatches={m} "
              f"{prec}: {epochs} epochs, {len(times)} steps at "
              f"{np.median(times) * 1e3:.3f} ms/step median; launches B1 "
              f"{b1}, B2 {b2}, B3 {b3} (as the epochs imply)", flush=True)
    return per


def lm_epoch(be, sys_cfg, init=None, fault=False):
    """Per-step losses of one epoch of a fresh tune-lm trial (seed 0,
    learning rate 2e-3), and its initial train state (a copy on the CPU).
    ``init`` replaces the trial's initial state with a copy of that one,
    moved to the backend's device; ``fault`` starts the trial one batch on:
    a neighbour's batches."""
    from repro_torch.tree import tree_map
    ts = be.init_trial("tune-lm", {"learning_rate": 2e-3}, seed=0)
    state, opt = ts.params
    if init is not None:
        state = {"params": tree_map(lambda a: a.to(be.device, copy=True),
                                    init["params"]),
                 "opt": tree_map(lambda a: a.to(be.device, copy=True),
                                 init["opt"]), "step": init["step"]}
        ts.params = (state, opt)
    start = {"params": tree_map(lambda a: a.to("cpu", copy=True),
                                state["params"]),
             "opt": tree_map(lambda a: a.to("cpu", copy=True), state["opt"]),
             "step": state["step"]}
    if fault:
        ts.step = 1
    log = []
    key = ("step", str(sys_cfg), 2e-3)
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.transformer import SystemConfig
    step = steps_lib.make_train_step(
        ts.cfg, SystemConfig(microbatches=sys_cfg["microbatches"],
                             remat=sys_cfg["remat"],
                             precision=sys_cfg["precision"]), ts.params[1])

    def logged(state, batch):
        state, m = step(state, batch)
        log.append(float(m["loss"]))
        return state, m
    be._cache[key] = logged
    be.run_epoch(ts, sys_cfg)
    return log, start


def lm_step_profile(be, sys_cfg, steps=2):
    """Device busy against wall time over ``steps`` warm train steps of a
    fresh trial (torch.profiler, device activity only): (wall ms a step,
    busy ms a step, the three kernels with the most device time as (name,
    ms a step, launches a step))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    be.steps_per_epoch = steps
    ts = be.init_trial(LM_FULL_ARCH, {"learning_rate": 1e-3})
    ts, _ = be.run_epoch(ts, sys_cfg)                    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        be.run_epoch(ts, sys_cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, _ = busy_union_ms(prof)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:3]
    top = [(e.key[:48], e.self_device_time_total / 1e3 / steps,
            e.count / steps) for e in kernels]
    return wall / steps, busy / steps, top


def phase_lmtune(counters, card, fa, fa_bwd):
    """PipeTune over the LM train step (the example's LMBackend): card
    against CPU per step with a planted fault; the example's main() on the
    card; PipeTune at full-width qwen3-0.6b through a subclass overriding
    _cfg(). B1-B3 launch as the epochs imply."""
    import io
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.api import Experiment, registry
    from repro_torch.core.groundtruth import GroundTruth
    from repro_torch.core.job import HPTJob, Param, SearchSpace
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    example = load_example("torch_tune_llm_sysparams")

    # 1. card against CPU, one epoch at one config per remat value, from
    # the CPU trial's initial state
    threads = torch.get_num_threads()
    for sys_cfg in LM_SYS:
        torch.set_num_threads(1)                  # see LM_CARD_CPU_TOL
        try:
            cpu, init = lm_epoch(example.LMBackend(device="cpu"), sys_cfg)
        finally:
            torch.set_num_threads(threads)
        got, _ = lm_epoch(example.LMBackend(device="cuda"), sys_cfg, init)
        bad, _ = lm_epoch(example.LMBackend(device="cuda"), sys_cfg, init,
                          fault=True)
        steps = [abs(g - c) / (1 + abs(c)) for g, c in zip(got, cpu)]
        dist = max(steps)
        fdist = max(abs(g - c) / (1 + abs(c)) for g, c in zip(bad, cpu))
        print(f"[lmtune] card vs CPU tune-lm {sys_cfg}: {len(cpu)} steps, "
              f"loss {cpu[0]:.4f} -> {cpu[-1]:.4f}, step loss distances "
              f"{' '.join(f'{d:.1e}' for d in steps)}, worst {dist:.3e} "
              f"(limit {LM_CARD_CPU_TOL:.0e}); planted fault (the card "
              f"trial one batch on): {fdist:.3e}", flush=True)
        check(len(got) == len(cpu) == 6 and dist <= LM_CARD_CPU_TOL,
              f"tune-lm {sys_cfg}: the card's steps differ from the CPU's")
        check(fdist > LM_CARD_CPU_TOL, "the LM card-vs-CPU check misses "
              "the planted fault")
    print(f"[lmtune] (1) {time.perf_counter() - t_phase:.1f} s into the "
          "phase", flush=True)

    # 2. the example's main() on the card (its backend counted)
    Counted = counted_lm_backend(example, fa, fa_bwd)
    space = registry.default_sys_space("lm")     # as the example registered
    registry.register_backend("lm", Counted, sys_space=lambda **_: space)
    reset_all(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = example.main([])
    wall = time.perf_counter() - t0
    counts = read_all(counters)
    for line in out.getvalue().splitlines():
        print(f"[lmtune] main: {line}", flush=True)
    per = lm_launches(Counted.log, "main tune-lm", card)
    total = tuple(sum(v[i] for v in per.values()) for i in range(3))
    print(f"[lmtune] {card} | main: best lr "
          f"{res.best_hparams['learning_rate']:.3e}, {len(res.records)} "
          f"trials, tuning time {res.tuning_time_s:.3f} s, wall {wall:.2f} "
          f"s, ground truth {res.gt_hits} / {res.gt_misses}, locked "
          f"{res.best_record.sys_history[-1]}; launches {counts}",
          flush=True)
    check(total == (counts["B1"], counts["B2"], counts["B3"])
          and total[0] > 0 and counts["B4"] == counts["B5"] == 0,
          f"main's launches {counts} differ from its epochs' {total}")
    print(f"[lmtune] (2) {time.perf_counter() - t_phase:.1f} s into the "
          "phase", flush=True)

    # 3. full-width qwen3-0.6b: PipeTune through a subclass's _cfg()
    class FullWidth(Counted):
        log = []

        def _cfg(self):
            return configs.get(LM_FULL_ARCH)
    job = HPTJob(workload=LM_FULL_ARCH, space=SearchSpace(
        [Param("learning_rate", "log", 1e-4, 1e-2)]),
        max_epochs=LM_FULL_EPOCHS)
    reset_all(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = (Experiment(job).with_tuner("pipetune", max_probes=4)
            .with_backend(FullWidth(device="cuda"))
            .with_sys_space(space)
            .with_groundtruth(GroundTruth())
            .with_scheduler("random", n_trials=LM_FULL_TRIALS).run())
    wall = time.perf_counter() - t0
    counts = read_all(counters)
    per = lm_launches(FullWidth.log, f"full-width {LM_FULL_ARCH}", card)
    total = tuple(sum(v[i] for v in per.values()) for i in range(3))
    losses = [e.loss for r in full.records.values() for e in r.epochs]
    print(f"[lmtune] {card} | full-width {LM_FULL_ARCH} PipeTune random "
          f"{LM_FULL_TRIALS} x {LM_FULL_EPOCHS} epochs: best final loss "
          f"{-full.best_accuracy:.4f}, tuning time {full.tuning_time_s:.3f} "
          f"s, wall {wall:.2f} s, locked {full.best_record.sys_history[-1]}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; launches {counts}", flush=True)
    check(all(np.isfinite(losses)), f"full-width losses {losses}")
    check(total == (counts["B1"], counts["B2"], counts["B3"])
          and total[0] > 0 and counts["B4"] == counts["B5"] == 0,
          f"full width: launches {counts} differ from the epochs' {total}")
    del full
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[lmtune] phase {phase_s:.1f} s (limit {LM_PHASE_LIMIT_S:.0f} s)",
          flush=True)
    check(phase_s < LM_PHASE_LIMIT_S, f"the LM phase took {phase_s:.1f} s")
    return total


def phase_lmprofile(card):
    """Where a full-width LM example step's time goes, at each remat value
    of LM_SYS (torch.profiler, device activity only); within
    LM_PHASE_LIMIT_S."""
    import torch
    from repro_torch import configs
    t_phase = time.perf_counter()
    example = load_example("torch_tune_llm_sysparams")

    class FullWidth(example.LMBackend):
        def _cfg(self):
            return configs.get(LM_FULL_ARCH)
    for sys_cfg in LM_SYS:
        wall, busy, top = lm_step_profile(FullWidth(device="cuda"), sys_cfg)
        print(f"[lmprofile] {card} | full-width {LM_FULL_ARCH} {sys_cfg}: "
              f"{wall:.3f} ms/step, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}; top kernels "
              + "; ".join(f"{k} {ms:.3f} ms x{n:g}" for k, ms, n in top),
              flush=True)
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[lmprofile] phase {phase_s:.1f} s (limit "
          f"{LM_PHASE_LIMIT_S:.0f} s)", flush=True)
    check(phase_s < LM_PHASE_LIMIT_S,
          f"the LM profile phase took {phase_s:.1f} s")


def phase_trainstep(counters, card, tune, findb, groundtruth):
    """The kernel tuner's train_step workload on the card, its golden table
    through --kernel-db in both launchers, TorchRealBackend picking the
    tuned config up, and the port's quickstart; no B1-B5 launch in the
    tuner, the tuning launcher or the quickstart."""
    import io
    from repro_torch.core.backends import TorchRealBackend
    from repro_torch.launch import train as train_launch
    from repro_torch.launch import tune as tune_launch
    t_phase = time.perf_counter()
    db = groundtruth.KernelConfigDB()
    reset_all(counters)
    smry = tune.tune_kernel(TRAIN_WORKLOAD, db=db, device="cuda")
    print(f"[trainstep] {card} | {smry['workload']} ({smry['shape']}): "
          f"{smry['trials']} trials, winner {smry['winner']} at "
          f"{smry['winner_s'] * 1e3:.3f} ms/step against "
          f"{tune.BASELINES['train_step']} at "
          f"{smry['default_s'] * 1e3:.3f} ms/step (spread "
          f"{smry['spread']:.2%}); stored {smry['config']} at "
          f"{smry['tuned_s'] * 1e3:.3f} ms/step, speedup "
          f"{smry['speedup']:.3f}x, tuning {smry['tuning_time_s']:.3f} s in "
          f"{smry['wall_time_s']:.2f} s, {smry['kernel_calls']['train_step']}"
          f" steps, hardware {smry['hardware']}", flush=True)
    check(smry["source"] == "tuned" and smry["trials"] == 6,
          f"train_step: {smry['trials']} trials")
    check(smry["hardware"].startswith("cuda/") and "h100" in
          smry["hardware"], f"hardware key {smry['hardware']}")
    TRAIN_GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    groundtruth.export_golden(db.rows(), str(TRAIN_GOLDEN))
    warm = tune.tune_kernel(TRAIN_WORKLOAD, db=db, device="cuda")
    print(f"[trainstep] warm rerun: {warm['source']}, {warm['trials']} "
          f"trials, {warm['config']}", flush=True)
    check(warm["source"] == "find-db" and warm["trials"] == 0
          and warm["config"] == smry["config"], "the warm run re-tuned")

    # --kernel-db in the tuning launcher, then in the train launcher
    prev = findb.set_find_db(groundtruth.KernelConfigDB())
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tune_launch.main(["--workload", "lenet-mnist", "--system", "v1",
                              "--scheduler", "random", "--epochs", "1",
                              "--kernel-db", str(TRAIN_GOLDEN)])
        first = out.getvalue().splitlines()[0]
        print(f"[trainstep] launch.tune --kernel-db: {first}", flush=True)
        check(first.startswith("kernel find-db: 1 tuned configs"), first)
        # a TorchRealBackend epoch with no sys keys runs the tuned config
        be = TorchRealBackend(**LOOP_SIZES, device="cuda")
        _, res = be.run_epoch(be.init_trial("lenet-mnist",
                                            {"batch_size": 64}), {})
        print(f"[trainstep] TorchRealBackend epoch with no sys keys ran "
              f"{res.sys_config}", flush=True)
        check(res.sys_config == smry["config"],
              f"the epoch ran {res.sys_config}, not the tuned config")
        # and a find-db of another config: the epoch follows it
        other = {"remat": "block", "microbatches": 4, "precision": "fp32"}
        if smry["config"] == other:
            other = {**other, "microbatches": 2}
        planted = groundtruth.KernelConfigDB()
        planted.put("train_step", smry["shape"], other,
                    hardware=smry["hardware"])
        findb.set_find_db(planted)
        _, res = be.run_epoch(be.init_trial("lenet-mnist",
                                            {"batch_size": 64}), {})
        print(f"[trainstep] with a find-db of {other}: ran "
              f"{res.sys_config}", flush=True)
        check(res.sys_config == other, "the epoch ignored the find-db")
        counts = read_all(counters)
        check(not any(counts.values()), f"the train_step tuner and the "
              f"tuning launcher launched a kernel: {counts}")
        findb.set_find_db(groundtruth.KernelConfigDB())
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tres = train_launch.main(["--arch", "qwen3-0.6b-reduced",
                                      "--steps", "2", "--kernel-db",
                                      str(TRAIN_GOLDEN)])
        first = out.getvalue().splitlines()[0]
        print(f"[trainstep] launch.train --kernel-db: {first} "
              f"({tres.kernel_db_rows} rows; final loss "
              f"{tres.losses[-1]:.4f})", flush=True)
        check(tres.kernel_db_rows == 1 and first.startswith(
            "kernel find-db: 1 tuned configs"), first)
    finally:
        findb.set_find_db(prev)

    # the port's quickstart, on the card by default
    quick = load_example("torch_quickstart")
    reset_all(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        qres = quick.main([])
    for line in out.getvalue().splitlines():
        print(f"[trainstep] quickstart: {line}", flush=True)
    counts = read_all(counters)
    print(f"[trainstep] {card} | quickstart: best accuracy "
          f"{qres.best_accuracy:.4f}, tuning time {qres.tuning_time_s:.3f} "
          f"s, wall {time.perf_counter() - t0:.2f} s; launches {counts}",
          flush=True)
    check(len(qres.records) == 4 and not any(counts.values()),
          f"quickstart: {len(qres.records)} trials, launches {counts}")
    phase_s = time.perf_counter() - t_phase
    print(f"[trainstep] phase {phase_s:.1f} s (limit "
          f"{TRAINSTEP_PHASE_LIMIT_S:.0f} s)", flush=True)
    check(phase_s < TRAINSTEP_PHASE_LIMIT_S,
          f"the train_step phase took {phase_s:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run it from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import device as device_lib
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fa_bwd
    from repro_torch.core import groundtruth
    from repro_torch.kernels import findb
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import tune
    from repro_torch.launch import serve, steps, train

    card = card_line()
    if sys.argv[1:2] == ["--lane-probe"]:
        print(f"[card] {card}", flush=True)
        return run_lane_probe(card, int(sys.argv[2]) if sys.argv[2:]
                              else PAR_PROBE_REPS)
    if sys.argv[1:2] == ["--lane-probe-child"]:
        device_lib.resolve("cuda")
        lane_probe(sys.argv[2], int(sys.argv[3]), card)
        return 0
    idle_w = power_draw_w()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    device_lib.resolve("cuda")
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, lib in libs.items():
        for kernel, report in ptxas_report(lib.with_suffix(".log")):
            print(f"[ptxas] {name}: {kernel}: {report}", flush=True)

    phase_hopper(build)
    errs = phase_kernels(fa)
    bwd_errs = phase_bwd_kernels(fa, fa_bwd)
    phase_op(ops)
    res, launches = phase_serve(fa, fa_bwd, serve, steps)
    print(f"[serve] {card} | prefill {res.prefill_tok_s:.1f} tok/s "
          f"({res.prefill_ms:.3f} ms for {REQUESTS}x{PROMPT_LEN}), decode "
          f"{res.decode_tok_s:.1f} tok/s ({res.decode_ms / (GEN - 1):.3f} "
          f"ms/step at batch {REQUESTS})", flush=True)
    del res
    torch.cuda.empty_cache()
    _, train_counts = phase_train(fa, fa_bwd, train, card)
    phase_grad(fa_bwd)
    timing = phase_timing(fa, card)
    bwd_timing = phase_bwd_timing(fa, fa_bwd, card)
    mlstm_errs = phase_mlstm(ml)
    rglru_errs = phase_rglru(rg)
    counters = [("B1", fa, "launches"), ("B2", fa_bwd, "launches_dq"),
                ("B3", fa_bwd, "launches_dkv"), ("B4", ml, "launches"),
                ("B5", rg, "launches")]
    summaries, tune_counts = phase_tuner(counters, ml, rg, tune, findb, ops,
                                         groundtruth)
    rec_timing = phase_recurrent_timing(build, ml, rg, summaries, card)
    phase_tuneloop(counters, card, idle_w)
    phase_parallel(counters, card)
    phase_typeiii(counters, card)
    lm_counts = phase_lmtune(counters, card, fa, fa_bwd)
    phase_lmprofile(card)
    phase_trainstep(counters, card, tune, findb, groundtruth)

    src_bwd = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    train_errs = bwd_errs["train"]
    kernels = [
        {"name": "flash_attention", "id": "B1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:28",
         "launches": launches, "launches_lmtune": lm_counts[0],
         "max_abs_err": errs["serve"], **timing},
        {"name": "flash_attention_bwd_dq", "id": "B2", "route": "cuda",
         "source": src_bwd,
         "replaces": "src/repro/kernels/flash_attention_bwd.py:43",
         "launches": train_counts[1], "launches_lmtune": lm_counts[1],
         "max_abs_err": train_errs[0][0],
         **bwd_timing["dq"]},
        {"name": "flash_attention_bwd_dkv", "id": "B3", "route": "cuda",
         "source": src_bwd,
         "replaces": "src/repro/kernels/flash_attention_bwd.py:87",
         "launches": train_counts[2], "launches_lmtune": lm_counts[2],
         "max_abs_err": max(train_errs[1][0], train_errs[2][0]),
         **bwd_timing["dkv"]},
        {"name": "mlstm", "id": "B4", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm.cu",
         "replaces": "src/repro/kernels/mlstm.py:27",
         "launches": tune_counts["B4"],
         "max_abs_err": mlstm_errs["full_c128"],
         **rec_timing[("mlstm", "tuned")]},
        {"name": "rglru", "id": "B5", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru.cu",
         "replaces": "src/repro/kernels/rglru.py:24",
         "launches": tune_counts["B5"],
         "max_abs_err": rglru_errs["full"],
         **rec_timing[("rglru", "tuned")]}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
