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
     forward), in fp32 at the LM phase's shapes (8 x 64 tokens in 1, 2
     or 4 microbatches, at full-width qwen3-0.6b and at the LM example's
     width), and B1 at the [archs] shapes (G = 6, 7, 1 with K = 16, window
     4096 at S = 8192) and at examples/torch_serve_lm.py's prefill (bf16,
     8 x 64 tokens, K 2, G 2, D 64); B1-B3 at recurrentgemma-9b's attention
     (``rg_shapes``: head_dim 256, K = 1, G = 16, window 2048, at the
     [hybrid] serve and train shapes, a ragged S = 2047 in fp32, D = 192
     and K = 2); B1-B3 at internvl2-26b's attention (``vlm_shapes``: K 8,
     G 6, D 128 at the [vlm] serve and train shapes, 8 and 2 x 2048). A
     planted fault (one kv tile hidden
     from the later rows in the forward; in the backward, the dk/dv
     contribution of the same rows to the same keys left out) must fail
     each check (B1's at the serve, the [archs], the example's, the
     head_dim 256 and the [vlm] shapes; B2/B3's at the train, the head_dim
     256 and the [vlm] shapes). The whole autograd op (B1 forward,
     B2 and B3 backward) is held against autograd through fp32 dense
     attention at the train shape;
  3. serve full-width qwen3-0.6b (seeded bf16 weights, 8 requests of 2048
     prompt tokens, 32 generated) through ``repro_torch.launch.serve.main``,
     with every launch counter set to 0 just before and read just after; the
     flash kernel must have run 28 times (one per layer) per prefill, the
     backward kernels never. Then recompute the prefill logits on the plain
     attention path (``use_pallas=False``) in bf16 and in fp32, and hold both
     bf16 paths against the fp32 one (``LOGITS_RATIO``); the planted forward
     fault must fail this check;
 3b. ``[archs]``: serve the dense and moe archs of ROADMAP queue A 2c and
     3 at their published widths (``ARCHS_RUNS``: qwen2-moe-a2.7b and
     qwen2-1.5b whole through ``serve.main``, mixtral-8x22b, yi-34b and
     deepseek-coder-33b cut to 4 layers through ``serve.serve``), counters
     set to 0 just before each run and read just after: B1 once per layer
     and prefill, no backward kernel; finite logits and tokens in range;
     the prefill logits held as in 3 (where the prompt passes the window,
     the planted fault lies inside the last row's window); tok/s, peak
     memory, B1's share of one prefill's device time (torch.profiler) and,
     for the moe archs, the share of tokens x layers whose top-k experts
     the bf16 and fp32 routers agree on. Then the int8 KV cache on
     full-width qwen2-1.5b: ``INT8_TOKENS`` tokens decoded from position 0
     into an int8 and a bf16 cache, the logits within ``INT8_MAX_ERR`` and
     ``INT8_MIN_AGREE`` of each other, which a zeroed k_scale row must
     break; both caches' decode ms a step and peak memory printed. Last, ``examples/torch_serve_lm.py`` with its defaults (B1
     once per layer and prefill). Within ``ARCHS_PHASE_LIMIT_S``;
 3c. ``[hybrid]``: recurrentgemma-9b at full width through the step
     functions (``launch.serve`` refuses a hybrid: the reference's prefill
     hands decode no recurrent state). Served at full depth: a warm-up and
     a timed prefill of ``HYBRID_SERVE`` (B1 once per group and prefill,
     B2/B3 never), ``HYBRID_GEN`` tokens decoded from ``init_cache`` (no
     kernel launch; the last position's logits against the fp32 plain
     forward of those tokens within ``HYBRID_DECODE_RATIO`` of the bf16
     kernel-path prefill's distance), the prefill logits held as in 3
     (planted fault ``HYBRID_FAULT``), tok/s, peak memory, and one
     profiled prefill's device time split into B1, the plain RG-LRU scan
     and GEMMs. Trained cut to ``HYBRID_TRAIN_LAYERS`` layers at
     ``HYBRID_TRAIN`` tokens (fp32 masters, bf16 compute, adamw):
     ``HYBRID_TRAIN_STEPS`` steps and one at remat block with 2
     microbatches, B1 = B2 = B3 = groups x microbatches a step (B1 twice
     under remat), finite losses, peak memory; then its loss gradients
     held against the fp32 plain path leaf by leaf as in 5, with the
     planted backward fault. Within ``HYBRID_PHASE_LIMIT_S``;
 3d. ``[vlm]``: internvl2-26b at full width through the step functions
     (``launch.serve`` refuses a vlm: its prompts are patch embeddings).
     Served at full depth (48 layers, 19.9 B parameters): a warm-up and a
     timed prefill of ``VLM_SERVE`` seeded embeddings, then ``VLM_GEN``
     tokens decoded greedily from the prefill's caches through embed @
     adapter, counters set to 0 just before and read just after (B1 once
     per layer and prefill, B2/B3 never); tok/s and peak memory. Cut to
     ``VLM_CUT_LAYERS`` layers: the prefill logits held as in 3 (planted
     fault ``FAULT``); card against CPU in fp32 (TF32 off), a prefill of
     ``VLM_DECODE_PROMPT`` embeddings (its bf16 caches within one bf16
     step) and ``VLM_DECODE`` decode steps from the card's caches within
     ``VLM_CARD_CPU_TOL``, which a decode without the adapter must break;
     trained (fp32 masters, bf16 compute, adamw) ``VLM_TRAIN_STEPS`` steps
     at ``VLM_TRAIN`` and one at remat block with 2 microbatches, B1 = B2 =
     B3 = layers x microbatches a step (B1 twice under remat), peak memory;
     the loss gradients against the fp32 plain path leaf by leaf as in 5,
     the unused embed's zero on every path, with the planted backward
     fault. Within ``VLM_PHASE_LIMIT_S``;
 3e. ``[ssm]``: xlstm-350m at full width through the step functions
     (``launch.serve`` refuses an ssm: its prefill returns no cache).
     Served at full depth (24 layers): a warm-up and a timed prefill of
     ``SSM_SERVE``, ``SSM_GEN`` tokens decoded from ``init_cache``, every
     counter set to 0 just before and read just after (B1-B5 all 0: the
     reference's xLSTM runs its plain chunkwise mLSTM, never B4); the last
     position's decode logits against the fp32 forward of those tokens
     within ``SSM_DECODE_RATIO`` of the bf16 prefill's distance; tok/s,
     peak memory; the plain chunkwise mLSTM's and the sLSTM time loop's
     device spans in a prefill (CUDA events around each call), and GEMMs,
     device busy and the idle share over a prefill of ``SSM_PROFILE_S``
     tokens a row (torch.profiler, device activity). Trained cut to
     ``SSM_TRAIN_LAYERS`` layers (its host-bound sLSTM loop) at
     ``SSM_TRAIN`` tokens: ``SSM_TRAIN_STEPS`` steps and one at remat
     block with 2 microbatches, finite losses, ms a step, peak memory,
     launches 0. One group (8 layers) card against CPU in fp32 (TF32 off)
     at ``SSM_CHECK`` tokens (two mLSTM chunks): logits and every loss
     gradient within ``SSM_LOGITS_TOL`` and ``SSM_GRAD_TOL``, which the
     chunkwise mLSTM without its inter-chunk q C term must break. Within
     ``SSM_PHASE_LIMIT_S``;
 3f. ``[encdec]``: whisper-small at full width and depth through the step
     functions (``launch.serve`` refuses it: its prompts are frames plus
     tokens): ``ENC_SERVE`` requests of 1500 seeded frames and
     ``ENC_PROMPT`` tokens prefilled, ``ENC_GEN`` tokens decoded past the
     prompt through the reference's handover (a prompt-long self cache:
     the ring and the positions wrap), counters at 0 (no TPU kernel on the
     path); encode + prefill ms, decode tok/s, peak memory. Trained
     ``ENC_TRAIN_STEPS`` steps and one at remat block with 2 microbatches.
     Card against CPU in fp32 (TF32 off), cut to ``ENC_CHECK_LAYERS`` +
     ``ENC_CHECK_LAYERS`` layers, at 1 x (1500 frames, ``ENC_CHECK_TOKENS``
     tokens): the forward logits, the teacher-forced decode from
     ``init_cache`` with ``build_cross_cache`` and every loss gradient
     within ``ENC_CARD_CPU_TOL``, the decode within ``ENC_DECODE_TOL`` of
     the card's forward (tests/test_models.py's bound); the cross-attention
     without the later half of the frames must break it. Within
     ``ENC_PHASE_LIMIT_S``;
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
 5b. ``[ckpt]``: checkpoint/restart of full-width qwen3-0.6b (4 x 2048
     tokens, fp32 masters, bf16 compute; 40 leaves, 7.15 GB) through
     ``launch.train.main``, under ``CKPT_ROOT``, after printing its free
     space (the depth is cut, and says so, only where two checkpoints do
     not fit). ``CKPT_STEPS`` steps straight, twice (the card's own
     run-to-run distance); the same with ``--ckpt --ckpt-every 2``, a
     clone of the state taken on the card at the step-2 save: its losses
     and final state within the straight runs' distance (bit for bit where
     they are), steps 3-4 run while the step-2 write is in flight, and the
     step-2 checkpoint reloads equal to the clone bit for bit (the
     snapshot holds against the in-place updates). Then ``--resume`` in a
     fresh process (``chip_smoke.py --train-child``, which calls
     ``train.main`` as ``python -m repro_torch.launch.train`` does and
     prints its launches) must print "resumed from step 2", and its losses
     and step-4 checkpoint must match the straight run as above. B1, B2 and
     B3 launch layers x steps in every run. Printed: checkpoint bytes,
     save()'s blocking time, the writer's time and GB/s (sha256
     included), the restore time, ms/step with and without a write in
     flight. Planted faults, each caught: (a) a flipped byte in a leaf file
     (``IOError``), (b) a resume that zeroes adamw's moments, (c) a save
     that queues the live tensors with no host copy, then one more step;
 5c. ``[dist]``: an NCCL process group of world size 1 over a
     ``FileStore`` (the collectives are copies here): the full-width
     gradients of one step reduced by ``compressed_grad_mean``, int8
     within half a scale (``DIST_HALF_SCALE``) of method none per element,
     which a reduce with its scales dropped must break; ``compressed_bytes``
     int8 against fp32 (a quarter); ``compress_grads`` (int8, top-k at 1%)
     and both reduces timed; ``state_specs`` and ``reshard_state`` of the
     train state on ``single_device_mesh()`` and back, and the [ckpt]
     checkpoint restored with ``placements=``, both bit for bit. Each of
     5b and 5c must end within its limit;
  6. time B1, B2 and B3 (``time_attention``) at the serve shape (B1's
     reading), the train shape (B2's and B3's), the [hybrid] serve shape
     (head_dim 256, MQA, window 2048) and the [vlm] serve shape (K 8, G 6,
     D 128, 8 x 2048), each beside its bound, its plain
     version and one PyTorch library call of the same function
     (``scaled_dot_product_attention`` with ``enable_gqa`` and its
     backward, the flash backend pinned, timed here only: the port never
     calls it; what the backward picks unpinned is printed as
     information), and B2 + B3 back to back beside SDPA's whole backward;
     then the fp32 variants at the [lmtune] shapes and at the [hybrid]
     shape beside their bounds, plain versions and SDPA (unpinned: flash
     takes no fp32; the backend it picked is printed). Every
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
     (``PAR_TRIALS`` x ``PAR_EPOCHS``, batch 64, ``PAR_SIZES``) on
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
     (random 3 trials x 2 epochs of ``LM_FULL_STEPS`` steps) at
     full-width qwen3-0.6b through a
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
Then it prints the ``{"kernels": [...]}`` line (B1-B3 with their
``launches_vlm`` and ``vlm`` timing rows and their ``launches_ckpt``,
``launches_ckpt_resume`` and ``launches_dist``, B4 and B5 with their
``launches_ssm``), the card line, and last
``{"ok": true, "device": {...}}``.

``--train-child LAYERS ARGS`` (used by [ckpt]) runs
``repro_torch.launch.train.main(ARGS)`` with ``ARCH`` at LAYERS layers and
prints its start step, losses, step times and B1-B3 launches as JSON.
``--lane-probe [REPS]`` builds nothing and runs (a) alone, REPS times
(``PAR_PROBE_REPS``) in each of two processes: one with the profiler off
(serial, 2 and 4 lanes), one with the profiler started from another thread
``PAR_MIDWAVE_S`` into a last wave on 4 lanes. It prints each process's
exit code, so a crash is put down to the lanes or to the profiler. Without CUDA, or without the repo's
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
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


def hybrid_attention():
    """recurrentgemma-9b's attention from its config: (K, G, D, window)."""
    from repro_torch import configs
    cfg = configs.get(HYBRID_ARCH)
    K = cfg.n_kv_heads
    return K, cfg.n_heads // K, cfg.resolved_head_dim, cfg.window


def rg_shapes():
    """B1-B3's rows at recurrentgemma-9b's attention (head_dim 256, MQA:
    K = 1, G = 16, window 2048), each held against the plain version with
    its planted fault (for B2/B3: that fault's rows left out of dk/dv): the
    [hybrid] serve and train shapes (at S = 4096 the window cuts), a ragged
    S in fp32, D = 192 (padded to 256) and K = 2. FAULT's keys lie inside
    every row's window; at S = 1000 the fault takes rows >= 256. Rows:
    name, B, S, K, G, D, dtype, window, fault (S = T, causal)."""
    K, G, D, window = hybrid_attention()
    (b_serve, s_serve), (b_train, s_train) = HYBRID_SERVE, HYBRID_TRAIN
    return [
        ("rg_serve", b_serve, s_serve, K, G, D, "bfloat16", window, FAULT),
        ("rg_train", b_train, s_train, K, G, D, "bfloat16", window, FAULT),
        ("rg_fp32_ragged", 1, s_serve - 1, K, G, D, "float32", window,
         FAULT),
        ("rg_d192", 2, 1000, K, G, 192, "bfloat16", 512, (256, 0, 64)),
        ("rg_k2", 2, 1024, 2, G, D, "bfloat16", None, (512, 64, 128)),
    ]


# B1's rows that are also held against a planted fault, and the fault of
# each: FAULT at the serve shape and the [archs] phase's shapes; at the
# example's 64-token prompt, where FAULT's rows lie past the end, keys 0..15
# hidden from rows >= 32; and every row of rg_shapes.
FAULT_ROWS = {"serve": FAULT, "g6_qwen2": FAULT, "g7_yi": FAULT,
              "g1_k16": FAULT, "mixtral_window": FAULT,
              "serve_lm": (32, 0, 16), "vlm_serve": FAULT, "vlm_train": FAULT}


def vlm_shapes():
    """B1-B3's rows at internvl2-26b's attention (K 8, G 6, D 128, causal,
    no window) at the [vlm] serve and train shapes, each with FAULT: name,
    B, S, K, G, D."""
    from repro_torch import configs
    cfg = configs.get(VLM_ARCH)
    K = cfg.n_kv_heads
    G, D = cfg.n_heads // K, cfg.resolved_head_dim
    return [("vlm_serve", *VLM_SERVE, K, G, D),
            ("vlm_train", *VLM_TRAIN, K, G, D)]
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
# The launcher's data sizes at half its steps an epoch (4 of 8). The phase
# is bound by the host (the LSTM's lanes), whose speed varies from one
# machine to the next: at 8 steps it read 35.4-44.2 s of its limit on an
# NVIDIA H100 80GB HBM3 (700 W), and the LM phase, as host-bound, once
# read 63.7 s where it had read 35.2-48.8 s.
PAR_SIZES = dict(LOOP_SIZES, steps_per_epoch=4)
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
# Steps an epoch of the full-width run: half the example's 6. Its steps
# are bound by the host (8 x 64 tokens, 0.5-0.7 s a step at block/2 and
# 1.1-1.4 s at block/4 on an NVIDIA H100 80GB HBM3, 700 W); at 6 the phase
# read 35.2-48.8 s, and once 63.7 s, of LM_PHASE_LIMIT_S.
LM_FULL_STEPS = 3
LM_PHASE_LIMIT_S = 60.0

# The kernel tuner's train_step workload (train-smoke: lenet-mnist at batch
# 64) and --kernel-db in the launchers.
TRAIN_WORKLOAD = "train-smoke"
TRAIN_GOLDEN = Path("build") / "chip_smoke" / "train_step_golden.json"
TRAINSTEP_PHASE_LIMIT_S = 60.0

# [archs]: the dense and moe archs of ROADMAP queue A 2c and 3 served at
# their published widths through serve.serve (qwen2-moe-a2.7b and qwen2-1.5b
# at full depth through serve.main; the others at 4 layers, whose weights
# fit beside the cache: mixtral-8x22b's 56 layers are about 263 GiB in bf16,
# yi-34b's and deepseek-coder-33b's about 64 GiB). mixtral's 8192-token
# prompts pass its 4096 window, so B1's window mask and the rolled ring
# cache both act. Name, layers (None: all), requests, prompt tokens.
ARCHS_RUNS = [("qwen2-moe-a2.7b", None, 8, 2048),
              ("mixtral-8x22b", 4, 2, 8192),
              ("qwen2-1.5b", None, 8, 2048),
              ("yi-34b", 4, 8, 2048),
              ("deepseek-coder-33b", 4, 8, 2048)]
ARCHS_GEN = 32
# The int8 KV cache on full-width qwen2-1.5b: INT8_TOKENS prompt tokens
# decoded one by one from position 0 into an int8 and a bf16 cache (bf16
# compute). Limits on the int8 path's logits against the bf16 cache path's
# (max |diff| over all steps, and the share of (step, request) argmaxes
# that agree); a cache whose slot-0 k_scale row is zeroed after the first
# step must break one of them. On an NVIDIA H100 80GB HBM3 (700 W) the
# int8 cache read max|diff| 0.1581 (max|logit| 5.680) and agreement
# 0.9336; the fault 2.4899 and 0.4297. The limits leave about 3x on the
# distance and 0.13 on the agreement (random weights: many near-tied
# argmaxes), and sit well inside the fault's readings.
INT8_ARCH, INT8_TOKENS = "qwen2-1.5b", 64
INT8_MAX_ERR = 0.5
INT8_MIN_AGREE = 0.8
ARCHS_PHASE_LIMIT_S = 90.0

# [hybrid]: recurrentgemma-9b (head_dim 256, MQA G = 16, window 2048) at
# full width through launch.steps. Served at full depth (38 layers,
# 10.4 B parameters, bf16): HYBRID_SERVE prompts prefilled (B1 once per
# group and prefill), then HYBRID_GEN tokens decoded from init_cache, as the
# reference decodes a hybrid. Trained cut to HYBRID_TRAIN_LAYERS layers (1
# group + 1 tail block; the untied 256,000-row embedding and head keep
# most of its 2.99 B parameters) at HYBRID_TRAIN tokens a step.
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_SERVE = (8, 2048)
HYBRID_GEN = 32
HYBRID_TRAIN_LAYERS = 4
HYBRID_TRAIN = (1, 4096)
HYBRID_TRAIN_STEPS = 3
# Decode from init_cache against the fp32 plain forward of the same
# HYBRID_GEN tokens, at the last position: at most this times the distance
# of the bf16 kernel path's prefill of those tokens (on an NVIDIA H100 80GB
# HBM3 at 700 W: 3.058e-1 against 3.057e-1).
HYBRID_DECODE_RATIO = 2.0
# The planted fault of the prefill logits check: the later half of the
# window's keys hidden from the later rows. One dropped tile (FAULT) moved
# the last position's logits 1.26x the bf16 plain path's distance on the
# same card: the bf16 rounding of 26 recurrent layers (0.30 at max|logit|
# 5.0) hides it there, where B1's own check (rg_serve) catches it.
HYBRID_FAULT = (1024, 1024, 2048)
# The phase read 30.2 s on that card within the whole script.
HYBRID_PHASE_LIMIT_S = 90.0
# Kernel names of the library GEMMs (cuBLAS), for the prefill breakdown.
HYBRID_GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
HYBRID_SCAN_RANGE = "hybrid.plain_rglru_scan"

# [ssm]: xlstm-350m (24 layers: 3 groups of 7 mLSTM + 1 sLSTM; d 1024, 4
# heads of 512, d_inner 2048) at full width and depth through launch.steps
# (launch.serve refuses an ssm: its prefill returns no cache). Served:
# SSM_SERVE prompts prefilled, then SSM_GEN tokens decoded from init_cache;
# trained at SSM_TRAIN tokens a step. No TPU kernel is on this path: the
# reference's xLSTM runs its jnp chunkwise mLSTM, never B4.
SSM_ARCH = "xlstm-350m"
SSM_SERVE = (8, 2048)
SSM_GEN = 32
SSM_TRAIN = (4, 2048)
SSM_TRAIN_STEPS = 3
# Training is cut to one group (8 of 24 layers, full width): the sLSTM's
# time loop is host-bound under autograd, and at full depth a step took
# 8.9-12.0 s and the remat block step with 2 microbatches 51.0 s (NVIDIA
# H100 80GB HBM3, 700 W), past the phase's limit.
SSM_TRAIN_LAYERS = 8
# Decode from init_cache against the fp32 forward of the same SSM_GEN
# tokens, at the last position: at most this times the bf16 prefill's
# distance from it, as in [hybrid].
SSM_DECODE_RATIO = 2.0
# Card against CPU in fp32 (TF32 off): one group (8 layers) at full width
# on SSM_CHECK tokens, two mLSTM chunks, so the carried state acts. Logits
# and every loss gradient as max|card - CPU| / max|CPU|. The model at
# random init is ill-conditioned (exponential gates over 512 steps): on the
# CPU, weights moved by one fp32 step (6e-8 relative noise) move the logits
# 4.554e-4 and the worst gradient leaf 6.046e-3
# (tools/probe_ssm_conditioning.py), and the card read 7.865e-5 and
# 8.092e-4 (NVIDIA H100 80GB HBM3, 700 W). The limits sit above that
# spread; the planted fault reads 1.243.
SSM_CHECK = (1, 512)
SSM_LOGITS_TOL, SSM_GRAD_TOL = 1e-3, 1e-2
SSM_PHASE_LIMIT_S = 120.0
# The profiled prefill's prompt length: a full 8 x 2048 prefill is about
# 130,000 kernels, whose trace took the profiler over a minute to read back.
SSM_PROFILE_S = 512

# [vlm]: internvl2-26b (d 6144, 48 heads of 128 over 8 kv heads: G 6; d_ff
# 16384, vocab 92553) at full width. Served at full depth (48 layers, 19.9 B
# parameters, bf16): VLM_SERVE seeded patch embeddings prefilled (B1 once
# per layer and prefill), then VLM_GEN tokens decoded from the prefill's
# caches through embed @ adapter. Checked and trained cut to
# VLM_CUT_LAYERS layers (2.74 B parameters, most of them in the embedding
# and the head): the prefill logits as in phase 3, VLM_DECODE decode steps
# card against CPU in fp32 after a VLM_DECODE_PROMPT-embedding prefill,
# VLM_TRAIN tokens a step, and the loss gradients as in phase 5.
VLM_ARCH = "internvl2-26b"
VLM_SERVE = (8, 2048)
VLM_GEN = 32
VLM_CUT_LAYERS = 4
VLM_TRAIN = (2, 2048)
VLM_TRAIN_STEPS = 3
VLM_DECODE_PROMPT, VLM_DECODE = 16, 4
# Card against CPU, fp32: the prefill read 2.428e-6 and the decode steps
# 7.490e-5 of max|logit| (NVIDIA H100 80GB HBM3, 700 W): each decode step
# writes its token's k and v into the bf16 cache on each side, where an
# fp32 difference in the last place can round a value to the neighbouring
# bf16. The decode without the adapter reads 1.164.
VLM_CARD_CPU_TOL = 1e-3
# The prefill's bf16 caches: each value within one bf16 step (2**-7 of it)
# of the CPU's, plus this share of the cache's largest value: a value near
# zero, the difference of large fp32 sums, can round many of its own bf16
# steps away (23 at one value on the card above).
VLM_CACHE_TOL = 1e-5
VLM_PHASE_LIMIT_S = 120.0

# [encdec]: whisper-small (12 + 12 layers, d 768, 12 heads of 64, d_ff
# 3072, 1500 frames) at full width and depth through launch.steps: ENC_SERVE
# requests of 1500 seeded frames and ENC_PROMPT tokens, then ENC_GEN tokens
# decoded past the prompt through the reference's handover (the self cache
# is prompt-long, so the ring and the positions wrap); trained at
# ENC_SERVE x (1500 frames, ENC_PROMPT tokens). Card against CPU in fp32 at
# 1 request and ENC_CHECK_TOKENS tokens, cut to ENC_CHECK_LAYERS + as many
# layers for the CPU side: the forward logits, the teacher-forced decode
# from init_cache (and, as tests/test_models.py, within ENC_DECODE_TOL of
# the forward), the loss gradients. No TPU kernel is on this path.
ENC_ARCH = "whisper-small"
ENC_SERVE, ENC_PROMPT, ENC_GEN = 8, 224, 32
ENC_TRAIN_STEPS = 3
ENC_CHECK_TOKENS, ENC_CHECK_LAYERS = 64, 2
# The card read at most 1.4e-5 (a gradient leaf; logits 1.3e-6) on an
# NVIDIA H100 80GB HBM3 at 700 W.
ENC_CARD_CPU_TOL = 1e-4
ENC_DECODE_TOL = 0.1
ENC_PHASE_LIMIT_S = 90.0

# [ckpt] and [dist]: full-width qwen3-0.6b through launch.train with
# --ckpt/--resume, its checkpoints under CKPT_ROOT (ignored by git, removed
# at the end). Two straight runs measure the card's run-to-run distance; a
# resumed run must be bit for bit where they are, else within CKPT_SLACK
# times their distance. Depth is cut only if the disk cannot hold two
# checkpoints in CKPT_DISK_SHARE of its free space.
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ckpt"
CKPT_STEPS = 4
CKPT_SLACK = 4.0
CKPT_DISK_SHARE = 0.9
CKPT_CHILD_TIMEOUT_S = 300
CKPT_PHASE_LIMIT_S = 120.0
# An int8 reduce over one rank is q * scale with q = round(g / scale): at
# most half a scale from g, plus the fp32 rounding of the divide and the
# multiply (2 x 127 x 2^-24 of a scale < 2^-16).
DIST_HALF_SCALE = 0.5 + 2.0 ** -16
DIST_PHASE_LIMIT_S = 60.0

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
                rest = re.match(r"I(?:13__nv_bfloat16|6__half|f|Li\d+E)+E",
                                mangled[run.end() + n:])
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


def dense_attention_sliced(q, k, v, causal, window=None, drop=None):
    """``dense_attention`` one (batch row, kv head) at a time: the same
    function in a fraction of the memory, for the long prompts."""
    import torch
    outs, lses = [], []
    for b in range(q.shape[0]):
        parts = [dense_attention(q[b:b + 1, :, h:h + 1],
                                 k[b:b + 1, :, h:h + 1],
                                 v[b:b + 1, :, h:h + 1], causal, window, drop)
                 for h in range(q.shape[2])]
        outs.append(torch.cat([o for o, _ in parts], dim=2))
        lses.append(torch.cat([lse for _, lse in parts], dim=2))
    return torch.cat(outs), torch.cat(lses)


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
        # the [archs] prefills: qwen2-1.5b and mixtral (G = 6), yi-34b and
        # deepseek-coder-33b (G = 7), qwen2-moe-a2.7b (G = 1, K = 16), and
        # mixtral's window at its prompt length
        ("g6_qwen2", 8, 2048, 2048, 2, 6, 128, torch.bfloat16, True, None),
        ("g7_yi", 8, 2048, 2048, 8, 7, 128, torch.bfloat16, True, None),
        ("g1_k16", 8, 2048, 2048, 16, 1, 128, torch.bfloat16, True, None),
        ("mixtral_window", 2, 8192, 8192, 8, 6, 128, torch.bfloat16, True,
         4096),
        # examples/torch_serve_lm.py's prefill (serve-lm: K 2, G 2, D 64)
        ("serve_lm", 8, 64, 64, 2, 2, 64, torch.bfloat16, True, None),
        # the [vlm] prefill and train shapes (internvl2-26b: K 8, G 6)
        *[(n, b, s_, s_, k, g, d, torch.bfloat16, True, None)
          for n, b, s_, k, g, d in vlm_shapes()],
        *[(n, b, s_, s_, k, g, d, getattr(torch, dt), True, w)
          for n, b, s_, k, g, d, dt, w, _ in rg_shapes()],
    ]
    fault_rows = {**FAULT_ROWS, **{n: f for n, *_, f in rg_shapes()}}
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
        if name in fault_rows:
            drop = fault_rows[name]
            f_out, f_lse = dense_attention_sliced(q, k, v, causal, window,
                                                  drop)
            caught, f_eo, f_el = compare(f_out, f_lse, ref_out, ref_lse)[:3]
            caught = not caught
            print(f"[kernel] planted fault at {name} (keys {drop[1]}.."
                  f"{drop[2] - 1} hidden from rows >= {drop[0]}): "
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
    """B2/B3 against their plain version (BWD_SHAPES, then rg_shapes' and
    vlm_shapes' rows); the planted backward fault at the train shape and
    at rg_shapes' and vlm_shapes'."""
    import torch
    rg = rg_shapes()
    shapes = BWD_SHAPES + [(n, b, s_, s_, k, g, d, dt, True, w)
                           for n, b, s_, k, g, d, dt, w, _ in rg] + [
        (n, b, s_, s_, k, g, d, "bfloat16", True, None)
        for n, b, s_, k, g, d in vlm_shapes()]
    faults = {"train": FAULT, **{n: f for n, *_, f in rg},
              **{n: FAULT for n, *_ in vlm_shapes()}}
    errs = {}
    for i, (name, B, S, T, K, G, D, dt, causal, window) in enumerate(
            shapes):
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
        if name in faults:
            drop = faults[name]
            fault = dense_attention_bwd(q, k, v, do, causal, window, drop)
            passed, fe, fneed = compare_grads(fault, ref, GRAD_TOL[dt])
            caught = not passed
            print(f"[kernel] planted backward fault at {name} (the dk/dv "
                  f"contribution of rows >= {drop[0]} to keys {drop[1]}.."
                  f"{drop[2] - 1} left out): max|err| "
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


def archs_fault(prompt_len, window):
    """The planted fault of an [archs] run: FAULT, or where the prompt
    passes the window, the same kind of fault (one kv tile hidden from the
    later rows) at the window's left edge, so that it lies inside the window
    of the last row, whose logits prefill returns: FAULT's keys 64..127 are
    outside it."""
    if window is None or prompt_len <= window:
        return FAULT
    row = prompt_len - window
    return (row, row + 64, row + 128)


def faulty_flash(drop):
    """A stand-in for ``fa.flash_attention`` with a planted fault: keys
    drop[1]..drop[2]-1 hidden from rows >= drop[0]."""
    return (lambda q, k, v, *, causal=True, window=None, **_:
            dense_attention_sliced(q, k, v, causal, window, drop)[0])


@contextlib.contextmanager
def routing_recorded(moe_lib, log):
    """Append each MoE layer's top-k experts (sorted per token) to ``log``
    while the block runs."""
    gating = moe_lib._top_k_gating

    def recorded(logits, cfg):
        weights, idx, aux = gating(logits, cfg)
        log.append(idx.sort(-1).values)
        return weights, idx, aux
    moe_lib._top_k_gating = recorded
    try:
        yield log
    finally:
        moe_lib._top_k_gating = gating


def b1_share(prof):
    """(B1's device ms, device busy ms) over a torch.profiler window."""
    from torch.autograd import DeviceType
    b1 = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "fa_fwd" in e.key)
    return b1 / 1e3, busy_union_ms(prof)[0]


def serve_arch(serve, T, configs, arch, layers, requests, prompt_len):
    """One [archs] run: serve.main at full depth, else serve.serve on the
    config cut to ``layers`` layers (seeded bf16 weights, numpy prompts, as
    serve.setup makes them)."""
    import dataclasses
    import numpy as np
    import torch
    argv = ["--arch", arch, "--requests", str(requests), "--prompt-len",
            str(prompt_len), "--gen", str(ARCHS_GEN), "--seed", "0"]
    if layers is None:
        return serve.main(argv)
    sys_ = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers,
                              dtype=sys_.compute_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init(gen, cfg, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (requests, prompt_len))).to("cuda")
    return serve.serve(params, prompts, cfg, sys_, ARCHS_GEN)


def int8_decode(res, steps, T, quant, fault=False):
    """Decode the first INT8_TOKENS prompt tokens of ``res`` one by one from
    position 0 into a fresh cache: (logits (B, INT8_TOKENS, V), ms a step
    over steps 1.. (CUDA events), peak bytes allocated above the start).
    With ``fault``, the int8 cache's slot-0 k_scale row is zeroed after the
    first step in every layer."""
    import torch
    B = res.prompts.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cache = T.init_cache(res.cfg, B, INT8_TOKENS, quant=quant, device="cuda")
    decode = steps.make_decode_step(res.cfg, res.sys)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = []
    for t in range(INT8_TOKENS):
        if t == 1:
            start.record()
        logits, cache = decode(res.params, cache, res.prompts[:, t:t + 1], t)
        out.append(logits[:, 0])
        if fault and t == 0:
            cache["k_scale"][:, :, 0] = 0
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (INT8_TOKENS - 1)
    peak = torch.cuda.max_memory_allocated() - base
    return torch.stack(out, dim=1), ms, peak


def phase_int8(res, steps, T, card):
    """The int8 KV cache against the bf16 cache on full-width INT8_ARCH."""
    ref, ms_bf16, peak_bf16 = int8_decode(res, steps, T, quant=False)

    def distance(logits):
        return (float((logits - ref).abs().max()),
                float((logits.argmax(-1) == ref.argmax(-1)).float().mean()))
    logits, ms_int8, peak_int8 = int8_decode(res, steps, T, quant=True)
    err, agree = distance(logits)
    f_err, f_agree = distance(int8_decode(res, steps, T, quant=True,
                                          fault=True)[0])
    ok = err <= INT8_MAX_ERR and agree >= INT8_MIN_AGREE
    caught = f_err > INT8_MAX_ERR or f_agree < INT8_MIN_AGREE
    B = res.prompts.shape[0]
    print(f"[archs] {card} | int8 KV cache, {res.cfg.name} full width, "
          f"{B} x {INT8_TOKENS} tokens decoded from position 0, against the "
          f"bf16 cache (max|logit| {float(ref.abs().max()):.3f}): max|diff| "
          f"{err:.4f}, argmax agreement {agree:.4f} (limits "
          f"{INT8_MAX_ERR:g}, {INT8_MIN_AGREE:g}) {'ok' if ok else 'FAIL'}; "
          f"planted fault (slot-0 k_scale zeroed after step 0): max|diff| "
          f"{f_err:.4f}, agreement {f_agree:.4f} "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    print(f"[archs] {card} | int8 KV cache decode (eager: each layer "
          f"dequantizes its whole cache to fp32 every step): "
          f"{ms_int8:.3f} ms a step against the bf16 cache's "
          f"{ms_bf16:.3f} (steps 1..{INT8_TOKENS - 1}); peak above the "
          f"start {peak_int8 / 2**20:.3f} against {peak_bf16 / 2**20:.3f} "
          f"MiB", flush=True)
    check(ok, "the int8 KV cache strays from the bf16 cache")
    check(caught, "the int8 check misses a zeroed k_scale row")


def phase_archs(fa, fa_bwd, serve, steps, card):
    """Queue A 2c/3/6 on the card: every run's prefills go through B1, its
    logits held against the plain and fp32 paths (the planted fault must
    break that limit), the MoE routers' bf16/fp32 agreement, tok/s, peak
    memory and B1's share of a prefill's device time; then the int8 cache.
    Returns B1's launches over the served runs."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    total = 0
    for arch, layers, requests, prompt_len in ARCHS_RUNS:
        t_run = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, fa_bwd)
        res = serve_arch(serve, T, configs, arch, layers, requests,
                         prompt_len)
        launches, dq, dkv = read_counts(fa, fa_bwd)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        cfg = res.cfg
        total += launches
        want = cfg.n_layers * res.prefills
        print(f"[archs] {arch}: {cfg.n_layers} layers, flash_attention "
              f"launches {launches} over {res.prefills} prefills (want "
              f"{want}); backward {dq} dq, {dkv} dkv", flush=True)
        check(launches == want, f"{arch}: expected {want} B1 launches, got "
                                f"{launches}")
        check(dq == dkv == 0, f"{arch}: serving launched a backward kernel")
        V = cfg.padded_vocab
        check(tuple(res.prefill_logits.shape) == (requests, 1, V)
              and bool(torch.isfinite(res.prefill_logits).all()),
              f"{arch}: prefill logits wrong in shape or not finite")
        check(tuple(res.tokens.shape) == (requests, ARCHS_GEN)
              and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < V,
              f"{arch}: generated tokens out of range")

        def prefill_logits(**change):
            sys_ = dataclasses.replace(res.sys, **change)
            step = steps.make_prefill_step(cfg, sys_,
                                           max_len=prompt_len + ARCHS_GEN)
            logits = step(res.params, {"tokens": res.prompts})[0]
            torch.cuda.synchronize()
            return logits

        routes_bf16, routes_fp32 = [], []
        with routing_recorded(moe_lib, routes_bf16), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            prefill_logits()
        b1_ms, busy_ms = b1_share(prof)
        del prof
        plain = prefill_logits(use_pallas=False)
        with routing_recorded(moe_lib, routes_fp32):
            exact = prefill_logits(use_pallas=False, precision="fp32")
        drop = archs_fault(prompt_len, cfg.window)
        kernel_fn = fa.flash_attention
        fa.flash_attention = faulty_flash(drop)
        try:
            fault = prefill_logits()
        finally:
            fa.flash_attention = kernel_fn

        def err(logits):
            return float((logits - exact).abs().max())
        e_kernel, e_plain, e_fault = (err(res.prefill_logits), err(plain),
                                      err(fault))
        ok = e_kernel <= LOGITS_RATIO * e_plain
        caught = e_fault > LOGITS_RATIO * e_plain
        routing = ""
        if cfg.family == "moe":
            same = [(a == b).all(-1).float()
                    for a, b in zip(routes_bf16, routes_fp32)]
            routing = (f"; top-{cfg.top_k} experts of bf16 and fp32 routers "
                       f"agree for {float(torch.stack(same).mean()):.4f} of "
                       f"tokens x layers (layer 0: "
                       f"{float(same[0].mean()):.4f})")
        B, S = res.prompts.shape
        print(f"[archs] {card} | {arch} ({cfg.n_layers} layers) {B}x{S} + "
              f"{ARCHS_GEN}: prefill {res.prefill_tok_s:.1f} tok/s "
              f"({res.prefill_ms:.3f} ms), decode {res.decode_tok_s:.1f} "
              f"tok/s ({res.decode_ms / (ARCHS_GEN - 1):.3f} ms/step), peak "
              f"memory {peak:.3f} GiB; B1 {b1_ms:.3f} ms of {busy_ms:.3f} ms "
              f"device busy in one prefill (share {b1_ms / busy_ms:.4f})"
              f"{routing}", flush=True)
        print(f"[archs] {arch} prefill logits against the fp32 plain path "
              f"(max|logit| {float(exact.abs().max()):.3f}): bf16 kernel "
              f"path {e_kernel:.3e}, bf16 plain path {e_plain:.3e}, limit "
              f"{LOGITS_RATIO:g}x the plain path's {'ok' if ok else 'FAIL'}; "
              f"planted fault (keys {drop[1]}..{drop[2] - 1} hidden from rows "
              f">= {drop[0]}) {e_fault:.3e} ({e_fault / e_plain:.2f}x) "
              f"{'caught' if caught else 'MISSED'}; run "
              f"{time.perf_counter() - t_run:.1f} s", flush=True)
        check(ok, f"{arch}: kernel-path logits disagree with the plain path")
        check(caught, f"{arch}: the logits check misses a dropped kv tile")
        del plain, exact, fault, routes_bf16, routes_fp32
        if arch == INT8_ARCH:
            phase_int8(res, steps, T, card)
        del res
        torch.cuda.empty_cache()
    # examples/torch_serve_lm.py (the reference example's serve-lm config:
    # 4 layers, head_dim 64) on the card with its defaults
    reset_counts(fa, fa_bwd)
    with contextlib.redirect_stdout(sys.stderr):
        ex = load_example("torch_serve_lm").main([])
    launches, dq, dkv = read_counts(fa, fa_bwd)
    want = ex.cfg.n_layers * ex.prefills
    print(f"[archs] {card} | examples/torch_serve_lm.py: prefill "
          f"{ex.prefill_tok_s:.1f} tok/s, decode {ex.decode_tok_s:.1f} "
          f"tok/s; B1 launches {launches} (want {want}), backward {dq} dq, "
          f"{dkv} dkv", flush=True)
    check(launches == want and dq == dkv == 0,
          "examples/torch_serve_lm.py: B1 launches wrong")
    check(bool(torch.isfinite(ex.prefill_logits).all())
          and int(ex.tokens.max()) < ex.cfg.padded_vocab,
          "examples/torch_serve_lm.py: bad logits or tokens")
    total += launches
    del ex
    phase_s = time.perf_counter() - t_phase
    print(f"[archs] phase {phase_s:.1f} s (limit {ARCHS_PHASE_LIMIT_S:.0f} "
          f"s); B1 launches over the served runs {total}", flush=True)
    check(phase_s < ARCHS_PHASE_LIMIT_S,
          f"the archs phase took {phase_s:.1f} s")
    return total


def prefill_shares(prof, ranges):
    """(B1 ms, {range: ms}, GEMM ms, device busy ms, the top kernels) over
    a profiled prefill: B1 by its kernel's name; each user range of
    ``ranges`` as the device span of its instances (from the first kernel
    launched inside one to the end of its last: the stream runs them in
    order); GEMMs by the library's kernel names."""
    from torch.autograd import DeviceType
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if e.key not in ranges]
    b1 = sum(e.self_device_time_total for e in kernels if "fa_fwd" in e.key)
    gemm = sum(e.self_device_time_total for e in kernels
               if any(w in e.key.lower() for w in HYBRID_GEMM_NAMES))
    spans = {r: sum(e.self_device_time_total for e in device if e.key == r)
             / 1e3 for r in ranges}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return (b1 / 1e3, spans, gemm / 1e3,
            busy_union_ms(prof, skip=tuple(ranges))[0],
            [(e.key[:60], e.self_device_time_total / 1e3) for e in top])


@contextlib.contextmanager
def scan_annotated(rec_lib):
    """Run the hybrid's plain RG-LRU scan inside a profiler range named
    ``HYBRID_SCAN_RANGE``."""
    import torch
    scan = rec_lib.rglru_reference

    def annotated(*args):
        with torch.profiler.record_function(HYBRID_SCAN_RANGE):
            return scan(*args)
    rec_lib.rglru_reference = annotated
    try:
        yield
    finally:
        rec_lib.rglru_reference = scan


@contextlib.contextmanager
def event_spans(module, names, out):
    """Time each call of ``module.<attr>`` on the card, for {attr: label}
    in ``names``: CUDA events on the current stream just before and after
    every call; on exit ``out[label]`` is their summed ms, each the device
    span from the end of the work before the call to the end of its last
    kernel, idle gaps included."""
    import torch
    saved = {attr: getattr(module, attr) for attr in names}
    marks = {label: [] for label in names.values()}

    def timed(fn, label):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                marks[label].append((start, end))
        return run
    for attr, label in names.items():
        setattr(module, attr, timed(saved[attr], label))
    try:
        yield out
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)
        torch.cuda.synchronize()
        for label, pairs in marks.items():
            out[label] = sum(a.elapsed_time(b) for a, b in pairs)


def hybrid_serve(fa, fa_bwd, steps, card):
    """Full-width, full-depth recurrentgemma-9b: prefill through
    make_prefill_step (warm-up, then timed), decode from init_cache through
    make_decode_step, the prefill logits against the plain and fp32 paths
    with a planted fault, and where one prefill's device time goes. Returns
    B1's launches as counted over the two prefills and the decode."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.models import recurrent as rec_lib
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    sys_ = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(HYBRID_ARCH),
                              dtype=sys_.compute_dtype)
    B, S = HYBRID_SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                    "cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    weights_gib = sum(a.numel() * a.element_size()
                      for a in tree_leaves(params)) / 2 ** 30
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S))).to("cuda")
    prefill = steps.make_prefill_step(cfg, sys_)
    decode = steps.make_decode_step(cfg, sys_)

    reset_counts(fa, fa_bwd)
    prefill(params, {"tokens": prompts})                    # warm-up
    with device_lib.Timer(dev) as t_prefill:
        logits, cache = prefill(params, {"tokens": prompts})
    prefill_counts = read_counts(fa, fa_bwd)
    G, V = cfg.hybrid_groups, cfg.padded_vocab
    want = (2 * G, 0, 0)
    print(f"[hybrid] {HYBRID_ARCH}: {cfg.n_layers} layers ({G} groups of "
          f"{cfg.rec_per_attn} recurrent + 1 attention, {cfg.hybrid_tail} "
          f"tail), {n_params / 1e9:.3f} B parameters ({weights_gib:.3f} GiB "
          f"bf16 with fp32 Lambda); launches over 2 prefills: B1 "
          f"{prefill_counts[0]}, dq {prefill_counts[1]}, dkv "
          f"{prefill_counts[2]} (want {want})",
          flush=True)
    check(prefill_counts == want,
          f"hybrid prefill launches {prefill_counts}, want {want}")
    D = cfg.resolved_head_dim
    check(tuple(logits.shape) == (B, 1, V)
          and bool(torch.isfinite(logits).all()),
          "hybrid prefill logits wrong in shape or not finite")
    check(tuple(cache["k"].shape) == (G, B, cfg.window, 1, D),
          f"hybrid prefill cache {tuple(cache['k'].shape)}")
    del cache
    prefill_tok_s = B * S / (t_prefill.ms / 1e3)

    # decode HYBRID_GEN prompt tokens from init_cache (the reference's
    # prefill hands decode no recurrent state)
    reset_counts(fa, fa_bwd)
    cache = T.init_cache(cfg, B, S, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dec = []
    for t in range(HYBRID_GEN):
        if t == 1:
            start.record()
        step_logits, cache = decode(params, cache, prompts[:, t:t + 1], t)
        dec.append(step_logits[:, 0])
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (HYBRID_GEN - 1)
    decode_counts = read_counts(fa, fa_bwd)
    dec = torch.stack(dec, dim=1)
    check(decode_counts == (0, 0, 0),
          f"hybrid decode launched kernels {decode_counts}")
    check(bool(torch.isfinite(dec).all()), "hybrid decode logits not finite")
    del cache

    def prefill_logits(tokens, **change):
        step = steps.make_prefill_step(cfg, dataclasses.replace(sys_,
                                                                **change))
        out = step(params, {"tokens": tokens})[0]
        torch.cuda.synchronize()
        return out

    # decode against the parallel forward: the first HYBRID_GEN tokens
    # prefilled on the kernel path and on the fp32 plain path
    head = prompts[:, :HYBRID_GEN]
    short_kernel = prefill_logits(head)[:, 0]
    short_exact = prefill_logits(head, use_pallas=False,
                                 precision="fp32")[:, 0]
    e_dec = float((dec[:, -1] - short_exact).abs().max())
    e_short = float((short_kernel - short_exact).abs().max())
    dec_ok = e_dec <= HYBRID_DECODE_RATIO * e_short
    print(f"[hybrid] {card} | decode from init_cache, {B} x {HYBRID_GEN} "
          f"tokens: {decode_ms:.3f} ms a step ({B / (decode_ms / 1e3):.1f} "
          f"tok/s, steps 1..{HYBRID_GEN - 1}); B1-B3 launches 0; position "
          f"{HYBRID_GEN - 1}'s logits against the fp32 plain forward of the "
          f"same {HYBRID_GEN} tokens: decode {e_dec:.3e}, bf16 kernel-path "
          f"prefill {e_short:.3e} (limit {HYBRID_DECODE_RATIO:g}x it) "
          f"{'ok' if dec_ok else 'FAIL'}", flush=True)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    with scan_annotated(rec_lib), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill_logits(prompts)
    b1_ms, spans, gemm_ms, busy_ms, top = prefill_shares(
        prof, (HYBRID_SCAN_RANGE,))
    scan_ms = spans[HYBRID_SCAN_RANGE]
    del prof
    plain = prefill_logits(prompts, use_pallas=False)
    exact = prefill_logits(prompts, use_pallas=False, precision="fp32")

    def err(x):
        return float((x - exact).abs().max())

    def fault_err(drop):
        kernel_fn = fa.flash_attention
        fa.flash_attention = faulty_flash(drop)
        try:
            return err(prefill_logits(prompts))
        finally:
            fa.flash_attention = kernel_fn
    e_kernel, e_plain = err(logits), err(plain)
    e_fault, e_tile = fault_err(HYBRID_FAULT), fault_err(FAULT)
    ok = e_kernel <= LOGITS_RATIO * e_plain
    caught = e_fault > LOGITS_RATIO * e_plain
    print(f"[hybrid] {card} | {HYBRID_ARCH} {B}x{S}: prefill "
          f"{prefill_tok_s:.1f} tok/s ({t_prefill.ms:.3f} ms), decode "
          f"{B / (decode_ms / 1e3):.1f} tok/s, peak memory {serve_peak:.3f} "
          f"GiB (served run; {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
          f" with the fp32 checks); one profiled prefill: device busy "
          f"{busy_ms:.3f} ms, B1 {b1_ms:.3f} ms (share "
          f"{b1_ms / busy_ms:.4f}), plain RG-LRU scan {scan_ms:.3f} ms "
          f"({scan_ms / busy_ms:.4f}), GEMMs {gemm_ms:.3f} ms "
          f"({gemm_ms / busy_ms:.4f}); top kernels "
          + "; ".join(f"{k} {ms:.3f}" for k, ms in top), flush=True)
    print(f"[hybrid] prefill logits against the fp32 plain path (max|logit| "
          f"{float(exact.abs().max()):.3f}): bf16 kernel path {e_kernel:.3e},"
          f" bf16 plain path {e_plain:.3e}, limit {LOGITS_RATIO:g}x the plain "
          f"path's {'ok' if ok else 'FAIL'}; planted fault (keys "
          f"{HYBRID_FAULT[1]}..{HYBRID_FAULT[2] - 1} hidden from rows >= "
          f"{HYBRID_FAULT[0]}) {e_fault:.3e} ({e_fault / e_plain:.2f}x) "
          f"{'caught' if caught else 'MISSED'}; one tile (keys "
          f"{FAULT[1]}..{FAULT[2] - 1} from rows >= {FAULT[0]}, not a "
          f"check) {e_tile:.3e} ({e_tile / e_plain:.2f}x)", flush=True)
    check(dec_ok, "hybrid decode strays from the forward")
    check(ok, "hybrid kernel-path logits disagree with the plain path")
    check(caught, "the hybrid logits check misses a dropped kv tile")
    del params, logits, plain, exact, dec
    torch.cuda.empty_cache()
    return prefill_counts[0] + decode_counts[0]


def hybrid_train(fa, fa_bwd, steps, card):
    """The full-width cut to HYBRID_TRAIN_LAYERS layers (fp32 masters, bf16
    compute, adamw as launch.train): steps at 1 x 4096 tokens and one at
    remat block with 2 microbatches, launches counted; then the loss
    gradients on the kernel path against the fp32 plain path, leaf by leaf,
    with a planted backward fault. Returns (B1, B2, B3) launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(configs.get(HYBRID_ARCH),
                              n_layers=HYBRID_TRAIN_LAYERS)
    G = cfg.hybrid_groups
    B, S = HYBRID_TRAIN
    n_steps = HYBRID_TRAIN_STEPS + 1
    opt = optimizers.adamw(optimizers.warmup_cosine(3e-4, 10, n_steps),
                           weight_decay=0.01)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.make_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, opt, "cuda")
    n_params = sum(a.numel() for a in tree_leaves(state["params"]))
    toks = synthetic.make_lm_dataset(0, 2 * B * S * (n_steps + 1),
                                     cfg.vocab)

    def batch_of(i, rows):
        chunk = toks[i * 2 * B * S:][:rows * S].reshape(rows, S)
        return {"tokens": torch.from_numpy(chunk).to("cuda", torch.long),
                "labels": torch.from_numpy(np.roll(chunk, -1, -1)).to(
                    "cuda", torch.long)}

    reset_counts(fa, fa_bwd)
    step = steps.make_train_step(cfg, T.SystemConfig(precision="bf16"), opt)
    losses, ms = [], []
    for i in range(HYBRID_TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, metrics = step(state, batch_of(i, B))
        end.record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        ms.append(start.elapsed_time(end))
    counts = read_counts(fa, fa_bwd)
    want = (G * HYBRID_TRAIN_STEPS,) * 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[hybrid] {card} | train {HYBRID_ARCH} cut to {cfg.n_layers} "
          f"layers ({G} group + {cfg.hybrid_tail} tail; {n_params / 1e9:.3f}"
          f" B parameters, fp32 masters, adamw), {HYBRID_TRAIN_STEPS} steps "
          f"of {B}x{S} tokens: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; ms/step "
          f"{' '.join(f'{x:.3f}' for x in ms)}; peak memory {peak:.3f} GiB; "
          f"launches B1 {counts[0]}, dq {counts[1]}, dkv {counts[2]} (want "
          f"{want})", flush=True)
    check(counts == want, f"hybrid train launches {counts}, want {want}")
    check(all(math.isfinite(x) for x in losses), "non-finite hybrid loss")

    reset_counts(fa, fa_bwd)
    remat = steps.make_train_step(
        cfg, T.SystemConfig(precision="bf16", remat="block", microbatches=2),
        opt)
    torch.cuda.reset_peak_memory_stats()
    state, metrics = remat(state, batch_of(HYBRID_TRAIN_STEPS, 2 * B))
    r_counts = read_counts(fa, fa_bwd)
    r_want = (2 * G * 2, G * 2, G * 2)
    r_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[hybrid] remat block, 2 microbatches of {B}x{S}: loss "
          f"{float(metrics['loss']):.4f}, launches B1 {r_counts[0]}, dq "
          f"{r_counts[1]}, dkv {r_counts[2]} (want {r_want}), peak memory "
          f"{r_peak:.3f} GiB", flush=True)
    check(r_counts == r_want, f"hybrid remat launches {r_counts}")
    check(math.isfinite(float(metrics["loss"])), "non-finite remat loss")
    total = tuple(a + b for a, b in zip(counts, r_counts))

    # gradients at 1 x S: the kernel path, the bf16 plain path and a
    # planted backward fault, each against the fp32 plain path, one set of
    # gradients beside the fp32 one at a time
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    batch = batch_of(HYBRID_TRAIN_STEPS + 1, 1)

    def grads(**kw):
        out = loss_grads(params, batch, cfg, T.SystemConfig(**kw))
        torch.cuda.synchronize()
        return out

    exact = grads(precision="fp32", use_pallas=False)

    def dist(**kw):
        g = grads(**kw)
        return {p: float((g[p] - e).abs().max() / e.abs().max())
                for p, e in exact.items()}

    d_k = dist(precision="bf16")
    d_p = dist(precision="bf16", use_pallas=False)
    kernel_bwd = fa_bwd.flash_attention_bwd
    fa_bwd.flash_attention_bwd = (
        lambda q, k, v, out, lse, do, *, causal=True, window=None, **_:
        dense_attention_bwd(q, k, v, do, causal, window, FAULT))
    try:
        d_f = dist(precision="bf16")
    finally:
        fa_bwd.flash_attention_bwd = kernel_bwd
    ratio = {p: d_k[p] / d_p[p] for p in exact}
    f_ratio = {p: d_f[p] / d_p[p] for p in exact}
    worst = max(ratio, key=ratio.get)
    worst_f = max(f_ratio, key=f_ratio.get)
    for p in exact:
        print(f"[hybrid] grad {p:28s} distance kernel {d_k[p]:.3e}, plain "
              f"{d_p[p]:.3e} ({ratio[p]:.2f}x), fault {d_f[p]:.3e} "
              f"({f_ratio[p]:.2f}x)", flush=True)
    ok = ratio[worst] <= GRAD_RATIO
    caught = f_ratio[worst_f] > GRAD_RATIO
    print(f"[hybrid] loss gradients (1x{S}) against the fp32 plain path: "
          f"worst leaf {worst} at {ratio[worst]:.2f}x the bf16 plain path's "
          f"distance (limit {GRAD_RATIO:g}x) {'ok' if ok else 'FAIL'}; "
          f"planted backward fault: worst leaf {worst_f} at "
          f"{f_ratio[worst_f]:.2f}x {'caught' if caught else 'MISSED'}",
          flush=True)
    check(ok, "hybrid kernel-path gradients disagree with the plain path")
    check(caught, "the hybrid gradient check misses a dropped tile")
    del params, exact
    torch.cuda.empty_cache()
    return total


def phase_hybrid(fa, fa_bwd, steps, card):
    """[hybrid]: recurrentgemma-9b served at full width and depth and
    trained at full width cut in depth, through launch.steps' functions
    (launch.serve refuses a hybrid), within HYBRID_PHASE_LIMIT_S. Returns
    (B1 launches serving, (B1, B2, B3) launches training)."""
    t_phase = time.perf_counter()
    serve_launches = hybrid_serve(fa, fa_bwd, steps, card)
    train_launches = hybrid_train(fa, fa_bwd, steps, card)
    phase_s = time.perf_counter() - t_phase
    print(f"[hybrid] phase {phase_s:.1f} s (limit "
          f"{HYBRID_PHASE_LIMIT_S:.0f} s)", flush=True)
    check(phase_s < HYBRID_PHASE_LIMIT_S,
          f"the hybrid phase took {phase_s:.1f} s")
    return serve_launches, train_launches


@contextlib.contextmanager
def tf32_off():
    """fp32 matrix products and convolutions without TF32, restored after."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bf16_excess(got, ref):
    """max(|got - ref| - 2**-7 |ref|) / max|ref|: how far two bf16 tensors
    differ beyond one bf16 step of each value, in units of the largest."""
    got, ref = got.float().to(ref.device), ref.float()
    return float(((got - ref).abs() - 2.0 ** -7 * ref.abs()).max()
                 / ref.abs().max())


def rel_dist(got, ref):
    """max|got - ref| / max|ref|, on ref's device."""
    return float((got.to(ref.device) - ref).abs().max() / ref.abs().max())


def cpu_exp_warmed():
    """One fp32 exp on the CPU, so that the CPU side of a card-vs-CPU check
    is not the process's first: PyTorch's first fp32 CPU exp of a process on
    several threads has erred by up to 1.5e-4 (tools/probe_cpu_exp.py)."""
    import torch
    torch.exp(torch.zeros(1 << 16))


def train_run(counters, steps, cfg, batches, sys_kw, opt, state):
    """Steps of ``make_train_step`` over ``batches`` (counters set to 0
    just before): (state, losses, ms a step by CUDA events, counts)."""
    import torch
    from repro_torch.models import transformer as T
    step = steps.make_train_step(cfg, T.SystemConfig(**sys_kw), opt)
    reset_all(counters)
    losses, ms = [], []
    for batch in batches:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        ms.append(start.elapsed_time(end))
    return state, losses, ms, read_all(counters)


def adamw_for(n_steps):
    from repro_torch.optim import optimizers
    return optimizers.adamw(optimizers.warmup_cosine(3e-4, 10, n_steps),
                            weight_decay=0.01)


def ssm_serve(counters, steps, card):
    """Full-width, full-depth xlstm-350m: prefill through make_prefill_step
    (warm-up, then timed; as in the reference it returns no cache), decode
    from init_cache, decode against the fp32 forward, and where one
    prefill's device time goes (the plain chunkwise mLSTM, the sLSTM's time
    loop, GEMMs, idle). Returns the launch counts over the served run."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    sys_ = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(SSM_ARCH), dtype=sys_.compute_dtype)
    B, S = SSM_SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                    "cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S))).to("cuda")
    prefill = steps.make_prefill_step(cfg, sys_)
    decode = steps.make_decode_step(cfg, sys_)

    reset_all(counters)
    prefill(params, {"tokens": prompts})                    # warm-up
    with device_lib.Timer(dev) as t_prefill:
        logits, cache = prefill(params, {"tokens": prompts})
    V = cfg.padded_vocab
    check(cache is None, "an ssm's prefill returned a cache")
    check(tuple(logits.shape) == (B, 1, V)
          and bool(torch.isfinite(logits).all()),
          "ssm prefill logits wrong in shape or not finite")
    cache = T.init_cache(cfg, B, S, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dec = []
    for t in range(SSM_GEN):
        if t == 1:
            start.record()
        step_logits, cache = decode(params, cache, prompts[:, t:t + 1], t)
        dec.append(step_logits[:, 0])
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (SSM_GEN - 1)
    counts = read_all(counters)
    dec = torch.stack(dec, dim=1)
    mcfg = cfg.mlstm_cfg()
    print(f"[ssm] {SSM_ARCH}: {cfg.n_layers} layers ({cfg.ssm_groups} groups"
          f" of {cfg.mlstm_per_slstm} mLSTM + 1 sLSTM; d {cfg.d_model}, "
          f"{mcfg.n_heads} heads of {mcfg.head_dim}, d_inner "
          f"{mcfg.d_inner}), {n_params:,} parameters (bf16, w_if and b_if "
          f"fp32); launches over 2 prefills and {SSM_GEN} decode steps: "
          f"{counts} (want all 0)", flush=True)
    check(not any(counts.values()), f"the ssm launched kernels: {counts}")
    check(bool(torch.isfinite(dec).all()), "ssm decode logits not finite")
    del cache
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def prefill_logits(tokens, **change):
        step = steps.make_prefill_step(cfg, dataclasses.replace(sys_,
                                                                **change))
        out = step(params, {"tokens": tokens})[0]
        torch.cuda.synchronize()
        return out

    head = prompts[:, :SSM_GEN]
    short = prefill_logits(head)[:, 0]
    short_exact = prefill_logits(head, precision="fp32")[:, 0]
    e_dec = float((dec[:, -1] - short_exact).abs().max())
    e_short = float((short - short_exact).abs().max())
    dec_ok = e_dec <= SSM_DECODE_RATIO * e_short

    # the plain mLSTM's and the sLSTM loop's device spans over a prefill at
    # the serve shape, by CUDA events around each call
    spans = {}
    with event_spans(xlstm_lib, {"mlstm_chunkwise_reference": "mlstm",
                                 "slstm_steps": "slstm"}, spans), \
            device_lib.Timer(dev) as t_spans:
        prefill_logits(prompts)
    m_ms, s_ms = spans["mlstm"], spans["slstm"]
    # GEMMs, device busy and idle share over SSM_PROFILE_S tokens a row
    # (each part's work scales with S); idle against the same prefill's
    # unprofiled time
    short_prompts = prompts[:, :SSM_PROFILE_S]
    prefill_logits(short_prompts)
    with device_lib.Timer(dev) as t_short:
        prefill_logits(short_prompts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill_logits(short_prompts)
    _, _, gemm_ms, busy_ms, top = prefill_shares(prof, ())
    del prof
    n_m = cfg.ssm_groups * cfg.mlstm_per_slstm
    print(f"[ssm] {card} | {SSM_ARCH} {B}x{S}: prefill "
          f"{B * S / (t_prefill.ms / 1e3):.1f} tok/s ({t_prefill.ms:.3f} "
          f"ms), decode from init_cache {B / (decode_ms / 1e3):.1f} tok/s "
          f"({decode_ms:.3f} ms a step, steps 1..{SSM_GEN - 1}), peak memory "
          f"{serve_peak:.3f} GiB", flush=True)
    print(f"[ssm] {card} | a {B}x{S} prefill ({t_spans.ms:.3f} ms), device "
          f"spans by CUDA events: plain mLSTM chunkwise {m_ms:.3f} ms "
          f"({m_ms / t_spans.ms:.4f}; {m_ms / n_m:.3f} ms a layer over "
          f"{n_m}, B4 at this shape in [timing]), sLSTM time loop "
          f"{s_ms:.3f} ms ({s_ms / t_spans.ms:.4f}; {s_ms / cfg.ssm_groups:.3f}"
          f" ms a layer, {S} steps each)", flush=True)
    print(f"[ssm] {card} | a {B}x{SSM_PROFILE_S} prefill ({t_short.ms:.3f} "
          f"ms unprofiled), torch.profiler device activity: busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / t_short.ms:.4f}; "
          f"GEMMs {gemm_ms:.3f} ms ({gemm_ms / busy_ms:.4f} of busy, the "
          f"sLSTM's recurrent products among them); top kernels "
          + "; ".join(f"{k} {ms:.3f}" for k, ms in top), flush=True)
    print(f"[ssm] decode from init_cache: position {SSM_GEN - 1}'s logits "
          f"against the fp32 forward of the same {SSM_GEN} tokens: decode "
          f"{e_dec:.3e}, bf16 prefill {e_short:.3e} (limit "
          f"{SSM_DECODE_RATIO:g}x it) {'ok' if dec_ok else 'FAIL'}",
          flush=True)
    check(dec_ok, "ssm decode strays from the forward")
    del params, logits, dec
    torch.cuda.empty_cache()
    return counts, m_ms


def ssm_train(counters, steps, card):
    """Full-width xlstm-350m cut to SSM_TRAIN_LAYERS layers (fp32 masters,
    bf16 compute, adamw): SSM_TRAIN_STEPS steps at SSM_TRAIN tokens and one
    at remat block with 2 microbatches. Returns the launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.tree import tree_leaves
    full = configs.get(SSM_ARCH)
    cfg = dataclasses.replace(full, n_layers=SSM_TRAIN_LAYERS)
    B, S = SSM_TRAIN
    n_steps = SSM_TRAIN_STEPS + 1
    opt = adamw_for(n_steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.make_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, opt, "cuda")
    n_params = sum(a.numel() for a in tree_leaves(state["params"]))
    toks = synthetic.make_lm_dataset(0, B * S * n_steps, cfg.vocab)

    def batch_of(i):
        chunk = toks[i * B * S:][:B * S].reshape(B, S)
        return {"tokens": torch.from_numpy(chunk).to("cuda", torch.long),
                "labels": torch.from_numpy(np.roll(chunk, -1, -1)).to(
                    "cuda", torch.long)}

    state, losses, ms, counts = train_run(
        counters, steps, cfg, [batch_of(i) for i in range(SSM_TRAIN_STEPS)],
        dict(precision="bf16"), opt, state)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[ssm] {card} | train {SSM_ARCH} cut to {cfg.n_layers} of "
          f"{full.n_layers} layers ({cfg.ssm_groups} group; {n_params:,} "
          f"parameters, fp32 masters, bf16 compute, adamw), "
          f"{SSM_TRAIN_STEPS} steps of {B}x{S} tokens: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; ms/step "
          f"{' '.join(f'{x:.3f}' for x in ms)}; peak memory {peak:.3f} GiB; "
          f"launches {counts} (want all 0)", flush=True)
    check(all(math.isfinite(x) for x in losses), "non-finite ssm loss")
    torch.cuda.reset_peak_memory_stats()
    state, r_losses, r_ms, r_counts = train_run(
        counters, steps, cfg, [batch_of(SSM_TRAIN_STEPS)],
        dict(precision="bf16", remat="block", microbatches=2), opt, state)
    print(f"[ssm] remat block, 2 microbatches of {B // 2}x{S}: loss "
          f"{r_losses[0]:.4f}, {r_ms[0]:.3f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, launches "
          f"{r_counts}", flush=True)
    check(math.isfinite(r_losses[0]), "non-finite ssm remat loss")
    check(not any(counts.values()) and not any(r_counts.values()),
          f"ssm training launched kernels: {counts}, {r_counts}")
    del state
    torch.cuda.empty_cache()
    return {k: counts[k] + r_counts[k] for k in counts}


def ssm_card_cpu(steps, card, ml):
    """One group of xlstm-350m (8 layers) at full width, card against CPU
    in fp32 with TF32 off: the logits and every loss gradient, with the
    planted fault (the chunkwise mLSTM without its inter-chunk q C term)
    on the card side."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.tree import tree_map
    cfg = configs.get(SSM_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=cfg.mlstm_per_slstm + 1)
    B, S = SSM_CHECK
    cpu_exp_warmed()
    params = T.init(torch.Generator().manual_seed(1), cfg, "cpu")
    gpu_params = tree_map(lambda a: a.to("cuda"), params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, -1))}
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    sys_ = T.SystemConfig(precision="fp32")

    def logits(p, b):
        with torch.no_grad():
            return T.forward(p, {"tokens": b["tokens"]}, cfg, sys_)[0]

    def drop_inter(q, k, v, i_gate, f_gate, chunk=256, state=None):
        return mlstm_drop_inter(ml, q, k, v, i_gate, f_gate,
                                min(chunk, q.shape[1])), None

    with tf32_off():
        ref = logits(params, batch)
        e_logits = rel_dist(logits(gpu_params, gpu_batch), ref)
        chunkwise = xlstm_lib.mlstm_chunkwise_reference
        xlstm_lib.mlstm_chunkwise_reference = drop_inter
        try:
            e_fault = rel_dist(logits(gpu_params, gpu_batch), ref)
        finally:
            xlstm_lib.mlstm_chunkwise_reference = chunkwise
        g_cpu = loss_grads(params, batch, cfg, sys_)
        g_gpu = loss_grads(gpu_params, gpu_batch, cfg, sys_)
    e_grads = {p: rel_dist(g_gpu[p], g) for p, g in g_cpu.items()}
    worst = max(e_grads, key=e_grads.get)
    ok = e_logits <= SSM_LOGITS_TOL and e_grads[worst] <= SSM_GRAD_TOL
    caught = e_fault > SSM_LOGITS_TOL
    print(f"[ssm] {card} | card against CPU, fp32 (TF32 off), {SSM_ARCH} "
          f"cut to {cfg.n_layers} layers (1 group) at full width, {B}x{S} "
          f"tokens ({S // min(256, S)} mLSTM chunks): logits {e_logits:.3e} "
          f"(limit {SSM_LOGITS_TOL:g}), worst gradient leaf {worst} "
          f"{e_grads[worst]:.3e} (limit {SSM_GRAD_TOL:g}; max|d| / "
          f"max|CPU|) {'ok' if ok else 'FAIL'}; "
          f"planted fault (chunkwise without the inter-chunk q C term) "
          f"logits {e_fault:.3e} {'caught' if caught else 'MISSED'}",
          flush=True)
    check(ok, "the ssm on the card disagrees with the CPU")
    check(caught, "the ssm card-vs-CPU check misses a dropped q C term")
    del gpu_params, g_gpu
    torch.cuda.empty_cache()


def phase_ssm(counters, steps, card, ml):
    """[ssm]: xlstm-350m served and trained at full width and depth through
    launch.steps, and one group held card against CPU; within
    SSM_PHASE_LIMIT_S. Returns (launch counts serving and training, the
    plain mLSTM's span in the profiled prefill)."""
    t_phase = time.perf_counter()
    serve_counts, mlstm_ms = ssm_serve(counters, steps, card)
    t_serve = time.perf_counter()
    train_counts = ssm_train(counters, steps, card)
    t_train = time.perf_counter()
    ssm_card_cpu(steps, card, ml)
    phase_s = time.perf_counter() - t_phase
    print(f"[ssm] phase {phase_s:.1f} s (limit {SSM_PHASE_LIMIT_S:.0f} s: "
          f"serve {t_serve - t_phase:.1f}, train {t_train - t_serve:.1f}, "
          f"card vs CPU {time.perf_counter() - t_train:.1f}); launches "
          f"serving {serve_counts}, training {train_counts}", flush=True)
    check(phase_s < SSM_PHASE_LIMIT_S, f"the ssm phase took {phase_s:.1f} s")
    return serve_counts, train_counts, mlstm_ms


def vlm_embeddings(B, S, d, seed):
    """Seeded patch embeddings (B, S, d) on the card, bf16."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, S, d), generator=g, device="cuda").to(
        torch.bfloat16)


def vlm_serve(fa, fa_bwd, steps, card):
    """Full-width, full-depth internvl2-26b: a warm-up and a timed prefill
    of VLM_SERVE patch embeddings, then VLM_GEN tokens decoded greedily from
    the prefill's caches (embed @ adapter). Returns (B1 launches, the
    parameters cut to VLM_CUT_LAYERS layers, the embeddings)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    sys_ = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(VLM_ARCH), dtype=sys_.compute_dtype)
    B, S = VLM_SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                    "cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    gib = sum(a.numel() * a.element_size()
              for a in tree_leaves(params)) / 2 ** 30
    emb = vlm_embeddings(B, S, cfg.d_model, 1)
    prefill = steps.make_prefill_step(cfg, sys_, max_len=S + VLM_GEN)
    decode = steps.make_decode_step(cfg, sys_)
    reset_counts(fa, fa_bwd)
    prefill(params, {"embeddings": emb})                    # warm-up
    with device_lib.Timer(dev) as t_prefill:
        logits, cache = prefill(params, {"embeddings": emb})
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    with device_lib.Timer(dev) as t_decode:
        for i in range(VLM_GEN - 1):
            step_logits, cache = decode(params, cache, tok, S + i)
            tok = step_logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
    counts = read_counts(fa, fa_bwd)
    tokens = torch.cat(out, dim=1)
    L, V = cfg.n_layers, cfg.padded_vocab
    want = (2 * L, 0, 0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[vlm] {VLM_ARCH}: {L} layers (d {cfg.d_model}, K "
          f"{cfg.n_kv_heads}, G {cfg.n_heads // cfg.n_kv_heads}, D "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}), {n_params:,} "
          f"parameters ({gib:.3f} GiB bf16); launches over 2 prefills and "
          f"{VLM_GEN - 1} decode steps: B1 {counts[0]}, dq {counts[1]}, dkv "
          f"{counts[2]} (want {want})", flush=True)
    check(counts == want, f"vlm serve launches {counts}, want {want}")
    check(tuple(logits.shape) == (B, 1, V)
          and bool(torch.isfinite(logits).all()),
          "vlm prefill logits wrong in shape or not finite")
    check(tuple(cache["k"].shape) == (L, B, S + VLM_GEN, cfg.n_kv_heads,
                                      cfg.resolved_head_dim),
          f"vlm cache {tuple(cache['k'].shape)}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < V,
          "vlm tokens out of range")
    decode_ms = t_decode.ms / (VLM_GEN - 1)
    print(f"[vlm] {card} | {VLM_ARCH} {B}x{S} embeddings + {VLM_GEN}: "
          f"prefill {B * S / (t_prefill.ms / 1e3):.1f} tok/s "
          f"({t_prefill.ms:.3f} ms), decode {B / (decode_ms / 1e3):.1f} "
          f"tok/s ({decode_ms:.3f} ms a step at batch {B}), peak memory "
          f"{peak:.3f} GiB", flush=True)
    del cache, logits
    cut = {k: v for k, v in params.items() if k != "layers"}
    cut["layers"] = tree_map(lambda a: a[:VLM_CUT_LAYERS].clone(),
                             params["layers"])
    del params
    torch.cuda.empty_cache()
    return counts[0], cut, emb


def vlm_checks(fa, steps, card, params, emb):
    """At the cut: the prefill logits of the kernel path and the bf16 plain
    path against the fp32 plain path (planted forward fault), and a few
    decode steps card against CPU in fp32 (planted fault: decode without
    the adapter)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    sys_ = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(VLM_ARCH), dtype=sys_.compute_dtype,
                              n_layers=VLM_CUT_LAYERS)

    def prefill_logits(**change):
        step = steps.make_prefill_step(cfg, dataclasses.replace(sys_,
                                                                **change))
        out = step(params, {"embeddings": emb})[0]
        torch.cuda.synchronize()
        return out

    kernel, plain = prefill_logits(), prefill_logits(use_pallas=False)
    exact = prefill_logits(use_pallas=False, precision="fp32")
    kernel_fn = fa.flash_attention
    fa.flash_attention = faulty_flash(FAULT)
    try:
        fault = prefill_logits()
    finally:
        fa.flash_attention = kernel_fn

    def err(x):
        return float((x - exact).abs().max())
    e_kernel, e_plain, e_fault = err(kernel), err(plain), err(fault)
    ok = e_kernel <= LOGITS_RATIO * e_plain
    caught = e_fault > LOGITS_RATIO * e_plain
    B, S = emb.shape[:2]
    print(f"[vlm] prefill logits, {VLM_ARCH} cut to {VLM_CUT_LAYERS} layers, "
          f"{B}x{S}, against the fp32 plain path (max|logit| "
          f"{float(exact.abs().max()):.3f}): bf16 kernel path {e_kernel:.3e},"
          f" bf16 plain path {e_plain:.3e}, limit {LOGITS_RATIO:g}x the plain "
          f"path's {'ok' if ok else 'FAIL'}; planted fault (keys "
          f"{FAULT[1]}..{FAULT[2] - 1} hidden from rows >= {FAULT[0]}) "
          f"{e_fault:.3e} ({e_fault / e_plain:.2f}x) "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    check(ok, "vlm kernel-path logits disagree with the plain path")
    check(caught, "the vlm logits check misses a dropped kv tile")
    del kernel, plain, exact, fault

    # card against CPU in fp32 on the same bf16 weights: a prefill of
    # VLM_DECODE_PROMPT embeddings (logits, and its bf16 caches within one
    # bf16 step), then VLM_DECODE decode steps on each side from the card's
    # caches, so that a cache value rounded to the neighbouring bf16 on one
    # side does not stand in for a decode difference
    P, N = VLM_DECODE_PROMPT, VLM_DECODE
    prompt = emb[:1, :P]
    feed = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (N, 1, 1)))
    sys32 = dataclasses.replace(sys_, precision="fp32")
    prefill = steps.make_prefill_step(cfg, sys32, max_len=P + N)

    def decode_all(p, cache, dev, decode_cfg):
        decode = steps.make_decode_step(decode_cfg, sys32)
        out = []
        for i in range(N):
            logits, cache = decode(p, cache, feed[i].to(dev), P + i)
            out.append(logits)
        return torch.cat(out, dim=1).cpu()

    cpu_exp_warmed()
    # the CPU side's weights widened once (bf16 -> fp32 is exact)
    cpu_params = tree_map(lambda a: a.cpu().float(), params)
    with tf32_off():
        card_prefill, card_cache = prefill(params, {"embeddings": prompt})
        cpu_prefill, cpu_cache = prefill(cpu_params,
                                         {"embeddings": prompt.cpu()})
        e_cache = max(bf16_excess(card_cache[n], c)
                      for n, c in cpu_cache.items())
        from_card = {n: c.cpu() for n, c in card_cache.items()}
        card_dec = decode_all(params, card_cache, "cuda", cfg)
        cpu_dec = decode_all(cpu_params, from_card, "cpu", cfg)
        _, fault_cache = prefill(params, {"embeddings": prompt})
        no_adapter = decode_all(params, fault_cache, "cuda",
                                dataclasses.replace(cfg, family="dense"))
    e_pre = rel_dist(card_prefill, cpu_prefill)
    e_dec = rel_dist(card_dec, cpu_dec)
    e_fault = rel_dist(no_adapter, cpu_dec)
    ok = max(e_pre, e_dec) <= VLM_CARD_CPU_TOL and e_cache <= VLM_CACHE_TOL
    caught = e_fault > VLM_CARD_CPU_TOL
    print(f"[vlm] {card} | card against CPU, fp32 (TF32 off), cut to "
          f"{cfg.n_layers} layers: prefill of 1x{P} embeddings {e_pre:.3e}, "
          f"its bf16 caches {e_cache:.3e} of max|cache| beyond one bf16 step "
          f"(limit {VLM_CACHE_TOL:g}); {N} decode steps through "
          f"embed @ adapter from the card's caches {e_dec:.3e} (max|d| / "
          f"max|CPU|, limit {VLM_CARD_CPU_TOL:g}) {'ok' if ok else 'FAIL'}; "
          f"planted fault (decode without the adapter) {e_fault:.3e} "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    check(ok, "vlm prefill or decode on the card disagrees with the CPU")
    check(caught, "the vlm decode check misses a missing adapter")


def vlm_train(fa, fa_bwd, steps, card):
    """The cut (fp32 masters, bf16 compute, adamw): VLM_TRAIN_STEPS steps at
    VLM_TRAIN and one at remat block with 2 microbatches, B1-B3 launches
    counted; then the loss gradients (1 x S) of the kernel path against the
    fp32 plain path leaf by leaf, with the planted backward fault; the
    unused embed's gradient must be zero on every path. Returns (B1, B2,
    B3) launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(configs.get(VLM_ARCH), n_layers=VLM_CUT_LAYERS)
    L, (B, S) = cfg.n_layers, VLM_TRAIN
    n_steps = VLM_TRAIN_STEPS + 1
    opt = adamw_for(n_steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.make_train_state(
        torch.Generator(device="cuda").manual_seed(2), cfg, opt, "cuda")
    n_params = sum(a.numel() for a in tree_leaves(state["params"]))
    rng = np.random.default_rng(2)

    def batch_of(i, rows):
        labels = rng.integers(0, cfg.vocab, (rows, S))
        return {"embeddings": vlm_embeddings(rows, S, cfg.d_model, 10 + i),
                "labels": torch.from_numpy(labels).to("cuda")}

    counters = [("B1", fa, "launches"), ("B2", fa_bwd, "launches_dq"),
                ("B3", fa_bwd, "launches_dkv")]
    state, losses, ms, counts = train_run(
        counters, steps, cfg, [batch_of(i, B) for i in range(VLM_TRAIN_STEPS)],
        dict(precision="bf16"), opt, state)
    counts = tuple(counts.values())
    want = (L * VLM_TRAIN_STEPS,) * 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[vlm] {card} | train {VLM_ARCH} cut to {L} layers ({n_params:,}"
          f" parameters, fp32 masters, bf16 compute, adamw), "
          f"{VLM_TRAIN_STEPS} steps of {B}x{S}: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; ms/step "
          f"{' '.join(f'{x:.3f}' for x in ms)}; peak memory {peak:.3f} GiB; "
          f"launches B1 {counts[0]}, dq {counts[1]}, dkv {counts[2]} (want "
          f"{want})", flush=True)
    check(counts == want, f"vlm train launches {counts}, want {want}")
    check(all(math.isfinite(x) for x in losses), "non-finite vlm loss")
    torch.cuda.reset_peak_memory_stats()
    state, r_losses, r_ms, r_counts = train_run(
        counters, steps, cfg, [batch_of(VLM_TRAIN_STEPS, B)],
        dict(precision="bf16", remat="block", microbatches=2), opt, state)
    r_counts = tuple(r_counts.values())
    r_want = (2 * L * 2, L * 2, L * 2)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    print(f"[vlm] remat block, 2 microbatches of {B // 2}x{S}: loss "
          f"{r_losses[0]:.4f}, {r_ms[0]:.3f} ms, launches B1 {r_counts[0]}, "
          f"dq {r_counts[1]}, dkv {r_counts[2]} (want {r_want}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (allocator "
          f"retries so far {retries})", flush=True)
    check(r_counts == r_want, f"vlm remat launches {r_counts}")
    check(math.isfinite(r_losses[0]), "non-finite vlm remat loss")
    total = tuple(a + b for a, b in zip(counts, r_counts))

    params = state["params"]
    del state
    torch.cuda.empty_cache()
    batch = batch_of(n_steps, 1)

    def grads(**kw):
        out = loss_grads(params, batch, cfg, T.SystemConfig(**kw))
        torch.cuda.synchronize()
        return out

    exact = grads(precision="fp32", use_pallas=False)
    unused = [p for p, e in exact.items() if not bool(e.any())]
    check(unused == ["embed"], f"vlm leaves with zero gradients: {unused}")

    def dist(**kw):
        g = grads(**kw)
        check(not bool(g["embed"].any()), "the vlm's embed got a gradient")
        return {p: float((g[p] - e).abs().max() / e.abs().max())
                for p, e in exact.items() if p not in unused}

    d_k = dist(precision="bf16")
    d_p = dist(precision="bf16", use_pallas=False)
    kernel_bwd = fa_bwd.flash_attention_bwd
    fa_bwd.flash_attention_bwd = (
        lambda q, k, v, out, lse, do, *, causal=True, window=None, **_:
        dense_attention_bwd(q, k, v, do, causal, window, FAULT))
    try:
        d_f = dist(precision="bf16")
    finally:
        fa_bwd.flash_attention_bwd = kernel_bwd
    ratio = {p: d_k[p] / d_p[p] for p in d_k}
    f_ratio = {p: d_f[p] / d_p[p] for p in d_k}
    worst = max(ratio, key=ratio.get)
    worst_f = max(f_ratio, key=f_ratio.get)
    for p in d_k:
        print(f"[vlm] grad {p:24s} distance kernel {d_k[p]:.3e}, plain "
              f"{d_p[p]:.3e} ({ratio[p]:.2f}x), fault {d_f[p]:.3e} "
              f"({f_ratio[p]:.2f}x)", flush=True)
    ok = ratio[worst] <= GRAD_RATIO
    caught = f_ratio[worst_f] > GRAD_RATIO
    print(f"[vlm] loss gradients (1x{S}) against the fp32 plain path: embed "
          f"zero on every path (unused: the forward starts at the adapter); "
          f"worst leaf {worst} at {ratio[worst]:.2f}x the bf16 plain path's "
          f"distance (limit {GRAD_RATIO:g}x) {'ok' if ok else 'FAIL'}; "
          f"planted backward fault: worst leaf {worst_f} at "
          f"{f_ratio[worst_f]:.2f}x {'caught' if caught else 'MISSED'}",
          flush=True)
    check(ok, "vlm kernel-path gradients disagree with the plain path")
    check(caught, "the vlm gradient check misses a dropped tile")
    del params, exact
    torch.cuda.empty_cache()
    return total


def phase_vlm(fa, fa_bwd, steps, card):
    """[vlm]: internvl2-26b served at full width and depth through
    launch.steps (launch.serve refuses a vlm: its prompts are embeddings),
    checked and trained cut in depth; within VLM_PHASE_LIMIT_S. Returns
    (B1 launches serving, (B1, B2, B3) launches training)."""
    t_phase = time.perf_counter()
    serve_b1, params, emb = vlm_serve(fa, fa_bwd, steps, card)
    t_serve = time.perf_counter()
    vlm_checks(fa, steps, card, params, emb)
    del params, emb
    t_checks = time.perf_counter()
    train_counts = vlm_train(fa, fa_bwd, steps, card)
    phase_s = time.perf_counter() - t_phase
    print(f"[vlm] phase {phase_s:.1f} s (limit {VLM_PHASE_LIMIT_S:.0f} s: "
          f"serve {t_serve - t_phase:.1f}, checks {t_checks - t_serve:.1f}, "
          f"train {time.perf_counter() - t_checks:.1f})", flush=True)
    check(phase_s < VLM_PHASE_LIMIT_S, f"the vlm phase took {phase_s:.1f} s")
    return serve_b1, train_counts


def enc_frames(B, cfg, seed, dtype):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, cfg.n_enc_frames, cfg.d_model), generator=g,
                       device="cuda").to(dtype)


def encdec_serve(counters, steps, card):
    """Full-width, full-depth whisper-small: ENC_SERVE requests of frames
    and ENC_PROMPT tokens prefilled (encode, decoder, cross cache), then
    ENC_GEN tokens decoded greedily past the prompt through the reference's
    handover: the self cache is ENC_PROMPT long, so the ring and the
    position embedding wrap. Returns the launch counts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch import device as device_lib
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    sys_ = T.SystemConfig()
    cfg = dataclasses.replace(configs.get(ENC_ARCH), dtype=sys_.compute_dtype)
    B, S = ENC_SERVE, ENC_PROMPT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = steps.model_init(torch.Generator(device="cuda").manual_seed(0),
                              cfg, "cuda")
    n_params = sum(a.numel() for a in tree_leaves(params))
    batch = {"frames": enc_frames(B, cfg, 1, torch.bfloat16),
             "tokens": torch.from_numpy(np.random.default_rng(1).integers(
                 0, cfg.vocab, (B, S))).to("cuda")}
    prefill = steps.make_prefill_step(cfg, sys_, max_len=S + ENC_GEN)
    decode = steps.make_decode_step(cfg, sys_)
    reset_all(counters)
    logits, cache = prefill(params, batch)                  # warm-up
    decode(params, cache, logits[:, -1].argmax(-1)[:, None], S)
    with device_lib.Timer(dev) as t_prefill:
        logits, cache = prefill(params, batch)
    L, H, D, V = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.padded_vocab
    check(tuple(cache["self_k"].shape) == (L, B, S, H, D)
          and tuple(cache["cross_k"].shape) == (L, B, cfg.n_enc_frames, H, D),
          f"encdec caches {tuple(cache['self_k'].shape)}, "
          f"{tuple(cache['cross_k'].shape)}")
    tok = logits[:, -1].argmax(-1)[:, None]
    out, dec = [tok], [logits]
    with device_lib.Timer(dev) as t_decode:
        for i in range(ENC_GEN - 1):
            step_logits, cache = decode(params, cache, tok, S + i)
            tok = step_logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
            dec.append(step_logits)
    counts = read_all(counters)
    tokens, dec = torch.cat(out, dim=1), torch.cat(dec, dim=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    decode_ms = t_decode.ms / (ENC_GEN - 1)
    print(f"[encdec] {ENC_ARCH}: {L} + {L} layers (d {cfg.d_model}, {H} "
          f"heads of {D}, d_ff {cfg.d_ff}, {cfg.n_enc_frames} frames), "
          f"{n_params:,} parameters (bf16); launches over 2 prefills and "
          f"{ENC_GEN} decode steps: {counts} (want all 0)", flush=True)
    print(f"[encdec] {card} | {ENC_ARCH} {B} requests of {cfg.n_enc_frames} "
          f"frames + {S} tokens: encode + prefill {t_prefill.ms:.3f} ms; "
          f"decode {ENC_GEN - 1} steps past the prompt (slots 0.."
          f"{ENC_GEN - 2} of the {S}-slot ring overwritten, positions "
          f"wrapped) {B / (decode_ms / 1e3):.1f} tok/s ({decode_ms:.3f} ms a "
          f"step); peak memory {peak:.3f} GiB", flush=True)
    check(not any(counts.values()), f"the encdec launched kernels: {counts}")
    check(bool(torch.isfinite(dec).all()), "encdec logits not finite")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < V,
          "encdec tokens out of range")
    del params, cache
    torch.cuda.empty_cache()
    return counts


def encdec_train(counters, steps, card):
    """Full-width, full-depth whisper-small (fp32 masters, bf16 compute,
    adamw): ENC_TRAIN_STEPS steps of ENC_SERVE x (frames, ENC_PROMPT
    tokens) and one at remat block with 2 microbatches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.tree import tree_leaves
    cfg = configs.get(ENC_ARCH)
    B, S = ENC_SERVE, ENC_PROMPT
    n_steps = ENC_TRAIN_STEPS + 1
    opt = adamw_for(n_steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.make_train_state(
        torch.Generator(device="cuda").manual_seed(2), cfg, opt, "cuda")
    n_params = sum(a.numel() for a in tree_leaves(state["params"]))
    rng = np.random.default_rng(2)

    def batch_of(i):
        toks = rng.integers(0, cfg.vocab, (B, S))
        return {"frames": enc_frames(B, cfg, 10 + i, torch.bfloat16),
                "tokens": torch.from_numpy(toks).to("cuda"),
                "labels": torch.from_numpy(np.roll(toks, -1, -1)).to("cuda")}

    state, losses, ms, counts = train_run(
        counters, steps, cfg, [batch_of(i) for i in range(ENC_TRAIN_STEPS)],
        dict(precision="bf16"), opt, state)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[encdec] {card} | train {ENC_ARCH} ({n_params:,} parameters, "
          f"fp32 masters, bf16 compute, adamw), {ENC_TRAIN_STEPS} steps of "
          f"{B} x ({cfg.n_enc_frames} frames, {S} tokens): losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; ms/step "
          f"{' '.join(f'{x:.3f}' for x in ms)}; peak memory {peak:.3f} GiB; "
          f"launches {counts} (want all 0)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    state, r_losses, r_ms, r_counts = train_run(
        counters, steps, cfg, [batch_of(ENC_TRAIN_STEPS)],
        dict(precision="bf16", remat="block", microbatches=2), opt, state)
    print(f"[encdec] remat block, 2 microbatches of {B // 2}: loss "
          f"{r_losses[0]:.4f}, {r_ms[0]:.3f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, launches "
          f"{r_counts}", flush=True)
    check(all(math.isfinite(x) for x in losses + r_losses),
          "non-finite encdec loss")
    check(not any(counts.values()) and not any(r_counts.values()),
          f"encdec training launched kernels: {counts}, {r_counts}")
    del state
    torch.cuda.empty_cache()
    return {k: counts[k] + r_counts[k] for k in counts}


@contextlib.contextmanager
def cross_half_hidden(encdec_lib):
    """The planted fault of [encdec]: every cross-attention sees only the
    first half of the frames."""
    mha = encdec_lib._mha

    def hidden(p, xq, xkv, **kw):
        if xkv is not xq:
            xkv = xkv[:, :xkv.shape[1] // 2]
        return mha(p, xq, xkv, **kw)
    encdec_lib._mha = hidden
    try:
        yield
    finally:
        encdec_lib._mha = mha


def encdec_card_cpu(steps, card):
    """whisper-small at full width cut to ENC_CHECK_LAYERS + as many
    layers, card against CPU in fp32 (TF32 off) at 1 request of 1500
    frames and ENC_CHECK_TOKENS tokens: the forward logits, the
    teacher-forced decode from init_cache with build_cross_cache, the loss
    gradients; the planted fault hides the later half of the frames from
    the cross-attention on the card side."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(configs.get(ENC_ARCH),
                              n_layers=ENC_CHECK_LAYERS)
    S = ENC_CHECK_TOKENS
    cpu_exp_warmed()
    params = steps.model_init(torch.Generator().manual_seed(3), cfg, "cpu")
    gpu_params = tree_map(lambda a: a.to("cuda"), params)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (1, S))
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (1, cfg.n_enc_frames, cfg.d_model))).float(),
             "tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, -1))}
    gpu_batch = {k: v.to("cuda") for k, v in batch.items()}
    sys_ = T.SystemConfig(precision="fp32")

    @torch.no_grad()
    def forward(p, b):
        return E.forward(p, b, cfg, sys_)[0]

    @torch.no_grad()
    def teacher_forced(p, b):
        dev = b["tokens"].device
        enc = E.encode(p, b["frames"], cfg, sys_)
        cache = E.init_cache(cfg, 1, S, dtype=torch.float32, device=dev)
        cache["cross_k"], cache["cross_v"] = E.build_cross_cache(
            p, enc, cfg, dtype=torch.float32)
        decode = steps.make_decode_step(cfg, sys_)
        dec = []
        for t in range(S):
            logits, cache = decode(p, cache, b["tokens"][:, t:t + 1], t)
            dec.append(logits)
        return torch.cat(dec, dim=1)

    with tf32_off():
        fwd_cpu, dec_cpu = forward(params, batch), teacher_forced(params,
                                                                  batch)
        fwd_gpu = forward(gpu_params, gpu_batch)
        dec_gpu = teacher_forced(gpu_params, gpu_batch)
        with cross_half_hidden(E):
            fwd_fault = forward(gpu_params, gpu_batch)
        g_cpu = loss_grads(params, batch, cfg, sys_)
        g_gpu = loss_grads(gpu_params, gpu_batch, cfg, sys_)
    e_fwd, e_dec = rel_dist(fwd_gpu, fwd_cpu), rel_dist(dec_gpu, dec_cpu)
    e_fault = rel_dist(fwd_fault, fwd_cpu)
    drift = float((dec_gpu - fwd_gpu).abs().max())
    e_grads = {p: rel_dist(g_gpu[p], g) for p, g in g_cpu.items()}
    worst = max(e_grads, key=e_grads.get)
    ok = max(e_fwd, e_dec, e_grads[worst]) <= ENC_CARD_CPU_TOL
    caught = e_fault > ENC_CARD_CPU_TOL
    print(f"[encdec] {card} | card against CPU, fp32 (TF32 off), {ENC_ARCH} "
          f"cut to {cfg.n_layers} + {cfg.n_layers} layers (CPU side) at full "
          f"width, 1 x ({cfg.n_enc_frames} frames, {S} tokens): forward "
          f"logits {e_fwd:.3e}, teacher-forced decode from init_cache "
          f"{e_dec:.3e}, worst gradient leaf {worst} {e_grads[worst]:.3e} "
          f"(max|d| / max|CPU|, limit {ENC_CARD_CPU_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}; decode against the card's forward "
          f"max|d| {drift:.3e} (limit {ENC_DECODE_TOL:g}); planted fault "
          f"(cross-attention without the later half of the frames) "
          f"{e_fault:.3e} {'caught' if caught else 'MISSED'}", flush=True)
    check(ok, "the encdec on the card disagrees with the CPU")
    check(drift < ENC_DECODE_TOL, "encdec decode strays from the forward")
    check(caught, "the encdec card-vs-CPU check misses hidden frames")
    del gpu_params, g_gpu
    torch.cuda.empty_cache()


def phase_encdec(counters, steps, card):
    """[encdec]: whisper-small served and trained at full width and depth
    through launch.steps (launch.serve refuses it: its prompts are frames
    plus tokens), held card against CPU cut in depth; within
    ENC_PHASE_LIMIT_S. Returns the launch counts serving and training."""
    t_phase = time.perf_counter()
    serve_counts = encdec_serve(counters, steps, card)
    train_counts = encdec_train(counters, steps, card)
    encdec_card_cpu(steps, card)
    phase_s = time.perf_counter() - t_phase
    print(f"[encdec] phase {phase_s:.1f} s (limit {ENC_PHASE_LIMIT_S:.0f} "
          f"s)", flush=True)
    check(phase_s < ENC_PHASE_LIMIT_S,
          f"the encdec phase took {phase_s:.1f} s")
    return serve_counts, train_counts


def sdpa_flash():
    """The context that pins SDPA to its flash backend; a shape it refuses
    raises instead of falling to another backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel(SDPBackend.FLASH_ATTENTION)


def sdpa_gqa(q, k, v):
    """Causal SDPA on the kernels' layouts, the kv heads shared through
    ``enable_gqa``: (B, H, S, D)."""
    import torch.nn.functional as F
    B, S, K, G, D = q.shape
    qh = q.reshape(B, S, K * G, D).transpose(1, 2)
    kh, vh = (x.transpose(1, 2) for x in (k, v))
    return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                          enable_gqa=True)


def time_attention(fa, fa_bwd, card, name, B, S, K, G, D, window, dtype):
    """B1, B2 and B3 at one causal shape: each kernel's ms beside its
    bound, its plain version and SDPA with ``enable_gqa`` (timed here only:
    the port never calls it), B1 against its forward, B2, B3 and B2 + B3
    back to back against its whole backward. In bf16 SDPA has its flash
    backend pinned, and what its backward picks unpinned is printed as
    information; flash takes no fp32, so there SDPA runs unpinned and the
    backend it picked is printed. Returns {id: row}."""
    import torch
    q, k, v = attention_inputs(B, S, S, K, G, D, dtype, seed=600)
    do = attention_inputs(B, S, S, K, G, D, dtype, seed=601)[0]
    size = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    pairs = B * K * G * visible_pairs(S, S, True, window)
    # each input read once, each output written once: B1 reads q, k, v and
    # writes out and lse (fp32); B2 and B3 read q, dO, k, v, lse and delta
    # and write dq, or dk and dv
    rows_ = B * S * K * G
    io = size * (2 * q.numel() + 2 * k.numel())
    fwd_bytes = io + 4 * rows_
    dq_bytes = io + 8 * rows_ + size * q.numel()
    dkv_bytes = io + 8 * rows_ + size * 2 * k.numel()
    out, lse = fa.flash_attention(q, k, v, causal=True, window=window,
                                  return_lse=True)
    delta = fa_bwd.attention_delta(out, do)
    kw = dict(causal=True, window=window, scale=D ** -0.5)
    args = (q, k, v, do, lse, delta)
    bf16 = dtype == torch.bfloat16
    iters = 20 if bf16 else 3
    with sdpa_flash() if bf16 else contextlib.nullcontext():
        lib_fwd = cuda_ms(lambda: sdpa_gqa(q, k, v), iters=iters)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out_h = sdpa_gqa(*leaves)
    backend = type(out_h.grad_fn).__name__
    if bf16:
        check("Flash" in backend, f"SDPA's backward is {backend}, not flash")
    elif "Attention" not in backend:    # the composite math path
        backend = f"math ({backend})"
    pinned = "flash pinned" if bf16 else "unpinned"
    do_h = do.reshape(B, S, K * G, D).transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        out_h, leaves, do_h, retain_graph=True), iters=iters)
    if bf16:
        # not the yardstick: what SDPA's backward picks unpinned
        out_d = sdpa_gqa(*leaves)
        default_ms = cuda_ms(lambda: torch.autograd.grad(
            out_d, leaves, do_h, retain_graph=True), iters=iters)
        print(f"[timing] {card} | {name}: SDPA unpinned (not the "
              f"yardstick): backward {type(out_d.grad_fn).__name__} "
              f"{default_ms:.4f} ms ({default_ms.spread()})", flush=True)
        del out_d
    rows = {}
    for kid, kernel, plain, products, nbytes, lib in (
            ("B1", lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=window),
             lambda: fa.flash_attention_reference(q, k, v, causal=True,
                                                  window=window),
             2, fwd_bytes, lib_fwd),
            ("B2", lambda: fa_bwd.dq_kernel(*args, **kw),
             lambda: fa_bwd.dq_reference(*args, **kw), 3, dq_bytes, lib_bwd),
            ("B3", lambda: fa_bwd.dkv_kernel(*args, **kw),
             lambda: fa_bwd.dkv_reference(*args, **kw), 4, dkv_bytes,
             lib_bwd)):
        ms = cuda_ms(kernel, iters=iters)
        plain_ms = cuda_ms(plain, iters=1)
        flops = 2.0 * D * products * pairs
        bound_ms, bound_by = bound(flops, nbytes, peak)
        what = "its forward" if kid == "B1" else f"{backend}: dq, dk, dv"
        print(f"[timing] {card} | {kid} {name} B={B} S=T={S} K={K} G={G} "
              f"D={D} {str(dtype)[6:]} causal window={window}: kernel "
              f"{ms:.4f} ms ({ms.spread()}; {flops / ms / 1e9:.1f} TFLOP/s), "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops:.3e} FLOP, "
              f"{nbytes:.3e} B), plain {plain_ms:.4f} ms "
              f"({plain_ms.spread()}), library (SDPA, {pinned}, enable_gqa,"
              f" {what}) {lib:.4f} ms ({lib.spread()})", flush=True)
        rows[kid] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib)
    both = cuda_ms(lambda: (fa_bwd.dq_kernel(*args, **kw),
                            fa_bwd.dkv_kernel(*args, **kw)), iters=iters)
    print(f"[timing] {card} | B2 + B3 {name} back to back {both:.4f} ms "
          f"({both.spread()}) against SDPA's whole backward ({backend}) "
          f"{lib_bwd:.4f} ms: {both / lib_bwd:.3f}x", flush=True)
    del out_h, leaves
    return rows


def phase_hybrid_timing(fa, fa_bwd, card):
    """B1-B3 at [hybrid]'s serve shape (head_dim 256, MQA, window 2048) in
    bf16 against SDPA; their fp32 variants at the [lmtune] shapes and at
    head_dim 256. Returns {"d256": rows, "fp32": {shape name: rows}}."""
    import torch
    shape = (*HYBRID_SERVE, *hybrid_attention())
    out = {"d256": time_attention(fa, fa_bwd, card, "hybrid", *shape,
                                  torch.bfloat16),
           "fp32": {}}
    for name, b, k, d in LM_ATTN_SHAPES:
        out["fp32"][name] = time_attention(fa, fa_bwd, card, name, b, 64, k,
                                           2, d, None, torch.float32)
    out["fp32"]["hybrid_fp32"] = time_attention(
        fa, fa_bwd, card, "hybrid_fp32", *shape, torch.float32)
    return out


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
    """{leaf path: fp32 gradient of the model's loss} (``steps.model_loss``;
    a leaf the loss does not use, the vlm's embed, gets zeros, as in the
    train step)."""
    import torch
    from repro_torch import weights
    from repro_torch.launch import steps
    flat = {path: leaf.detach().requires_grad_()
            for path, leaf in weights.flatten(params).items()}
    loss, _ = steps.model_loss(weights.unflatten(flat), batch, cfg, sys)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                materialize_grads=True)
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


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` set to ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield value
    finally:
        setattr(owner, name, old)


def ckpt_layers(cfg, free):
    """The depth whose train state fits twice into ``free`` bytes (two
    checkpoints on disk at once, keep 2), and its checkpoint bytes: full
    depth where it fits; the width is never cut."""
    import math
    from repro_torch import weights
    shapes = weights.leaf_shapes(cfg)
    for layers in range(cfg.n_layers, 0, -1):
        n = sum(math.prod(s[1:]) * layers if p.startswith("layers/")
                else math.prod(s) for p, s in shapes.items())
        nbytes = 3 * 4 * n + 4      # fp32 params, m and v, the int32 step
        if 2 * nbytes <= CKPT_DISK_SHARE * free:
            return layers, nbytes
    raise SmokeFailure(f"{free / 1e9:.1f} GB free cannot hold two "
                       "one-layer checkpoints")


@contextlib.contextmanager
def arch_depth(train, layers):
    """``ARCH`` cut to ``layers`` layers in ``train``'s config lookup (the
    full depth leaves it as it is)."""
    import dataclasses
    get = train.configs.get

    def cut(name):
        cfg = get(name)
        return dataclasses.replace(cfg, n_layers=layers) \
            if name == ARCH and layers != cfg.n_layers else cfg
    with patched(train.configs, "get", cut):
        yield


@contextlib.contextmanager
def captured_state(train, box):
    """``train.main``'s step function recorded in ``box``: "state" after
    each step (the live, in-place-updated tree), "step_fn" and "batch" of
    the last call, and each step's (start, end) on the host clock."""
    make = train.steps_lib.make_train_step
    box["spans"] = []

    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)
        box["step_fn"] = fn

        def step(state, batch):
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            box.update(state=state, batch=batch)
            box["spans"].append((t0, time.perf_counter()))
            return state, metrics
        return step
    with patched(train.steps_lib, "make_train_step", wrapped):
        yield box


def logged_manager(base, log, clone_at=(), lazy=False, zero_moments=False):
    """A ``CheckpointManager`` that times save() (the host snapshot), each
    write (sha256 included) and each restore into ``log``, clones the tree
    on the device at the steps in ``clone_at``, and plants two faults:
    ``lazy`` queues the live tree with no host copy (fault c), and
    ``zero_moments`` zeroes adamw's moments after a restore (fault b)."""
    import torch
    from repro_torch.tree import tree_leaves, tree_map

    class Manager(base):
        def save(self, step, tree, metadata=None, blocking=False):
            if step in clone_at:
                log["clones"][step] = tree_map(
                    lambda x: x.clone() if torch.is_tensor(x) else x, tree)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if lazy:
                self._queue.put((step, tree, metadata))
            else:
                super().save(step, tree, metadata, blocking)
            log["save_s"].append(time.perf_counter() - t0)

        def _write(self, step, tree, metadata):
            t0 = time.perf_counter()
            super()._write(step, tree, metadata)
            log["writes"].append((step, t0, time.perf_counter()))

        def restore(self, like, step=None, **kwargs):
            t0 = time.perf_counter()
            tree, meta = super().restore(like, step, **kwargs)
            torch.cuda.synchronize()
            log["restore_s"].append(time.perf_counter() - t0)
            if zero_moments and tree is not None:
                for t in tree_leaves(tree["opt"]):
                    t.zero_()
            return tree, meta
    log.update(clones={}, save_s=[], writes=[], restore_s=[])
    return Manager


def meta_state(cfg):
    """A train state's structure on the meta device (``load_pytree``'s
    ``like``): parameters in ``cfg.dtype``, adamw's moments in fp32, the
    step an int."""
    import torch
    from repro_torch import weights

    def tree(dtype):
        return weights.unflatten({
            p: torch.empty(s, device="meta", dtype=dtype)
            for p, s in weights.leaf_shapes(cfg).items()})
    moments = tree(torch.float32)
    return {"params": tree(cfg.dtype), "opt": {"m": moments, "v": moments},
            "step": 0}


def flat_state(state, copy=False):
    """{path: leaf} of a train state (the checkpoint's paths), each tensor
    cloned on its device with ``copy``."""
    import torch
    from repro_torch.checkpoint.manager import leaves_with_paths
    return {p: x.detach().clone() if copy and torch.is_tensor(x) else x
            for p, x in leaves_with_paths(state)}


def state_distance(state, ref):
    """(max over tensor leaves of max|x - ref| / max|ref|, the leaves that
    differ in any bit) of a train state against ``flat_state``'s dict; a
    step that differs counts as infinitely far."""
    import torch
    from repro_torch.checkpoint.manager import leaves_with_paths
    worst, differ = 0.0, []
    for p, x in leaves_with_paths(state):
        r = ref[p]
        if not torch.is_tensor(x):
            if x != r:
                worst = math.inf
                differ.append(p)
            continue
        r = r.to(x.device)
        if not torch.equal(x, r):
            differ.append(p)
            worst = max(worst, float((x.float() - r.float()).abs().max()
                                     / r.float().abs().max().clamp_min(
                                         1e-30)))
    return worst, differ


def within_straight(d, d_straight):
    """Bit for bit where the card repeated itself over the two straight
    runs, else within ``CKPT_SLACK`` times their distance."""
    return d == 0.0 if d_straight == 0.0 else d <= CKPT_SLACK * d_straight


def loss_distance(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


def train_child(train, fa, fa_bwd, layers, argv):
    """``--train-child``: ``train.main(argv)`` in this fresh process (what
    ``python -m repro_torch.launch.train argv`` runs), launches counted;
    prints one JSON line."""
    from repro_torch import device as device_lib
    device_lib.resolve("cuda")
    with arch_depth(train, layers):
        reset_counts(fa, fa_bwd)
        res = train.main(argv)
        counts = read_counts(fa, fa_bwd)
    print(json.dumps({"train_child": {
        "start_step": res.start_step, "losses": res.losses,
        "step_ms": res.step_ms, "launches": counts}}), flush=True)
    return 0


def ckpt_runs(fa, fa_bwd, train, card, root, layers, nbytes):
    """[ckpt]'s runs and checks (``phase_ckpt``); returns the in-process
    runs' and the fresh process's B1-B3 launches."""
    import torch
    from repro_torch import checkpoint
    argv = ["--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--precision", "bf16", "--steps",
            str(CKPT_STEPS)]
    ck = ["--ckpt", str(root / "run"), "--ckpt-every",
          str(CKPT_STEPS // 2)]
    L, half = layers, CKPT_STEPS // 2
    total = [0, 0, 0]
    like = meta_state(dataclasses.replace(train.configs.get(ARCH),
                                          n_layers=layers))

    def run(extra, manager=None):
        box = {}
        with contextlib.ExitStack() as stack:
            stack.enter_context(arch_depth(train, layers))
            stack.enter_context(captured_state(train, box))
            if manager is not None:
                stack.enter_context(patched(train, "CheckpointManager",
                                            manager))
            reset_counts(fa, fa_bwd)
            res = train.main(argv + extra)
            counts = read_counts(fa, fa_bwd)
        n = CKPT_STEPS - res.start_step
        check(counts == (L * n,) * 3,
              f"expected {L * n} launches of B1, B2 and B3, got {counts}")
        for i in range(3):
            total[i] += counts[i]
        return res, box

    # 1. twice straight: the card's own run-to-run distance
    s1, box = run([])
    ref = flat_state(box.pop("state"), copy=True)
    s2, box = run([])
    d_straight, diff_straight = state_distance(box.pop("state"), ref)
    l_straight = loss_distance(s1.losses, s2.losses)
    del box
    torch.cuda.empty_cache()
    print(f"[ckpt] {card} | straight runs of {CKPT_STEPS} steps: losses "
          f"{' '.join(f'{x:.6f}' for x in s1.losses)} and "
          f"{' '.join(f'{x:.6f}' for x in s2.losses)} (|diff| "
          f"{l_straight:.3e}); final states "
          f"{'equal bit for bit' if not diff_straight else f'differ in {len(diff_straight)} leaves, relative {d_straight:.3e}'}",
          flush=True)

    # 2. with a checkpoint every CKPT_STEPS / 2 steps, the snapshot cloned
    # on the card at the first save; steps half+1.. run with its write in
    # flight
    log = {}
    manager = logged_manager(checkpoint.CheckpointManager, log,
                             clone_at=(half,))
    c, box = run(ck, manager)
    d_c, _ = state_distance(box.pop("state"), ref)
    spans = box.pop("spans")
    del box
    (w_step, w0, w1), (_, w2, w3) = sorted(log["writes"])
    overlap = [i + 1 for i, (a, b) in enumerate(spans)
               if i >= half and a < w1 and b > w0]
    ckdir = root / "run" / f"step_{half:010d}"
    on_disk = sum(f.stat().st_size for f in ckdir.iterdir())
    mgr = checkpoint.CheckpointManager(str(root / "run"), keep=2,
                                       async_writes=False)
    t0 = time.perf_counter()
    back, meta = mgr.restore(like, half, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _, snap_diff = state_distance(back, flat_state(log["clones"][half]))
    del back, log["clones"][half]
    torch.cuda.empty_cache()
    wait_ms = [c.step_ms[i] for i in range(half, CKPT_STEPS)]
    base_ms = [s.step_ms[i] for s in (s1, s2) for i in range(half,
                                                             CKPT_STEPS)]
    print(f"[ckpt] {card} | checkpoint {on_disk:,} bytes on disk "
          f"({nbytes:,} of leaves, {len(list(ckdir.glob('leaf_*')))} "
          f"leaves, {layers} layers); save() blocking (host snapshot) "
          f"{' / '.join(f'{x * 1e3:.1f}' for x in log['save_s'])} ms; "
          f"writer {w1 - w0:.3f} / {w3 - w2:.3f} s "
          f"({nbytes / (w1 - w0) / 1e9:.3f} / {nbytes / (w3 - w2) / 1e9:.3f}"
          f" GB/s, sha256 included, no fsync); restore "
          f"{restore_s:.3f} s ({nbytes / restore_s / 1e9:.3f} GB/s, sha256 "
          f"and host-to-device included)", flush=True)
    print(f"[ckpt] {card} | ms/step over steps {half + 1}..{CKPT_STEPS}: "
          f"{' '.join(f'{x:.3f}' for x in wait_ms)} with the step-{w_step} "
          f"write in flight (steps {overlap} overlap it) against "
          f"{' '.join(f'{x:.3f}' for x in base_ms)} in the straight runs",
          flush=True)
    check(overlap, "no step ran while the checkpoint was being written")
    ok = within_straight(d_c, d_straight) and within_straight(
        loss_distance(c.losses, s1.losses), l_straight)
    print(f"[ckpt] the run with checkpoints against the first straight run: "
          f"losses |diff| {loss_distance(c.losses, s1.losses):.3e}, final "
          f"state {d_c:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "checkpointing changed the training")
    print(f"[ckpt] snapshot: the step-{half} checkpoint reloaded against "
          f"the state cloned on the card right after step {half}: "
          f"{'equal bit for bit' if not snap_diff else f'{len(snap_diff)} leaves differ'}"
          f" (metadata {meta}) {'ok' if not snap_diff else 'FAIL'}",
          flush=True)
    check(not snap_diff and meta == {"step": half},
          "the checkpoint is not the state at save()")

    # 3. resume in a fresh process from the step-half checkpoint
    last = root / "run" / f"step_{CKPT_STEPS:010d}"
    digests = [r["sha256"] for r in json.loads(
        (last / "manifest.json").read_text())["leaves"]]
    shutil.rmtree(last)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, __file__, "--train-child", str(layers)] + argv + ck
        + ["--resume"], capture_output=True, text=True,
        timeout=CKPT_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    check(out.returncode == 0, f"the resume process failed:\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    child = json.loads([ln for ln in out.stdout.splitlines()
                        if ln.startswith('{"train_child"')][-1])["train_child"]
    resumed = f"resumed from step {half}" in out.stdout
    if d_c == 0.0 and digests == [r["sha256"] for r in json.loads(
            (last / "manifest.json").read_text())["leaves"]]:
        d_r, diff_r = 0.0, []   # the same files as the run that equals ref
    else:
        final, _ = mgr.restore(like, CKPT_STEPS, device="cuda")
        d_r, diff_r = state_distance(final, ref)
        del final
        torch.cuda.empty_cache()
    l_r = loss_distance(child["losses"], s1.losses[half:])
    ok = (resumed and child["start_step"] == half
          and len(child["losses"]) == CKPT_STEPS - half
          and within_straight(d_r, d_straight)
          and within_straight(l_r, l_straight))
    want = [L * (CKPT_STEPS - half)] * 3
    print(f"[ckpt] {card} | fresh process (--resume, {child_s:.1f} s): "
          f"{'printed' if resumed else 'did NOT print'} \"resumed from step "
          f"{half}\", losses {' '.join(f'{x:.6f}' for x in child['losses'])}"
          f" against {' '.join(f'{x:.6f}' for x in s1.losses[half:])} "
          f"(|diff| {l_r:.3e}), final state "
          f"{'equal bit for bit' if not diff_r else f'{d_r:.3e} ({len(diff_r)} leaves differ)'}"
          f" to the first straight run's; its launches B1/B2/B3 "
          f"{child['launches']} (expected {want}); ms/step "
          f"{' '.join(f'{x:.3f}' for x in child['step_ms'])} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "the resumed run does not match the straight run")
    check(child["launches"] == want,
          f"resume process: expected {want} launches, got "
          f"{child['launches']}")
    shutil.rmtree(last)

    # fault (b): a resume that restores the parameters but zeroes adamw's
    # moments (no checkpoint written)
    log_b = {}
    fault_b, box = run(["--ckpt", str(root / "run"), "--ckpt-every",
                        str(10 * CKPT_STEPS), "--resume"],
                       logged_manager(checkpoint.CheckpointManager, log_b,
                                      zero_moments=True))
    d_b, _ = state_distance(box["state"], ref)
    caught_b = not within_straight(d_b, d_straight)
    print(f"[ckpt] planted fault (b), the moments zeroed on resume: final "
          f"state {d_b:.3e} from the straight run's "
          f"{'caught' if caught_b else 'MISSED'}", flush=True)
    check(caught_b, "the resume check misses zeroed moments")

    # fault (c): a snapshot taken without the host copy finished, then one
    # more in-place step while the writer reads the live tensors
    state, step_fn, batch = box.pop("state"), box.pop("step_fn"), \
        box.pop("batch")
    del box, fault_b
    log_c = {}
    lazy = logged_manager(checkpoint.CheckpointManager, log_c,
                          clone_at=(99,), lazy=True)(str(root / "lazy"))
    lazy.save(99, state)
    step_fn(state, batch)
    lazy.wait()
    clone = flat_state(log_c["clones"].pop(99))
    back, _ = lazy.restore(like, 99, device="cuda")
    _, diff_c = state_distance(back, clone)
    del back, state, clone
    torch.cuda.empty_cache()
    print(f"[ckpt] planted fault (c), no host copy at save(): "
          f"{len(diff_c)} of 40 leaves differ from the clone "
          f"{'caught' if diff_c else 'MISSED'}", flush=True)
    check(diff_c, "the snapshot check misses a snapshot taken late")

    # fault (a): one flipped byte in a leaf file
    victim = root / "lazy" / "step_0000000099" / "leaf_00000.npy"
    with open(victim, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    try:
        lazy.restore(like, 99, device="cuda")
        caught_a = "MISSED"
    except IOError as e:
        caught_a = f"caught ({e})"
    print(f"[ckpt] planted fault (a), one flipped byte in leaf_00000.npy: "
          f"{caught_a}", flush=True)
    check(caught_a.startswith("caught"), "a corrupt leaf restored")
    shutil.rmtree(root / "lazy")
    return total, child["launches"]


def phase_ckpt(fa, fa_bwd, train, card):
    """[ckpt]: full-width qwen3-0.6b through launch.train.main with
    --ckpt/--resume (module docstring, 5b), within CKPT_PHASE_LIMIT_S.
    Leaves the step-CKPT_STEPS/2 checkpoint under CKPT_ROOT for [dist];
    returns (in-process launches, the fresh process's launches, layers)."""
    import torch
    from repro_torch import configs
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = CKPT_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    cfg = configs.get(ARCH)
    layers, nbytes = ckpt_layers(cfg, free)
    cut = ("full depth" if layers == cfg.n_layers else
           f"DEPTH CUT to {layers} of {cfg.n_layers} layers")
    print(f"[ckpt] {card} | {free / 1e9:.1f} GB free under {root}; a "
          f"checkpoint holds {nbytes / 1e9:.3f} GB: {cut}", flush=True)
    total, child = ckpt_runs(fa, fa_bwd, train, card, root, layers, nbytes)
    phase_s = time.perf_counter() - t_phase
    print(f"[ckpt] phase {phase_s:.1f} s (limit {CKPT_PHASE_LIMIT_S:.0f} "
          f"s)", flush=True)
    check(phase_s < CKPT_PHASE_LIMIT_S, f"the ckpt phase took {phase_s:.1f} s")
    return total, child, layers


def phase_dist(fa, fa_bwd, card, layers):
    """[dist]: the distributed layer over an NCCL group of one rank
    (module docstring, 5c), within DIST_PHASE_LIMIT_S; returns the B1-B3
    launches of its gradient step."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import checkpoint, configs
    from repro_torch.data import synthetic
    from repro_torch.distributed import (collectives, compression, elastic,
                                         sharding)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import SystemConfig
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=layers)
    like = meta_state(cfg)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(CKPT_ROOT / "dist_store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=60))
    try:
        mgr = checkpoint.CheckpointManager(str(CKPT_ROOT / "run"),
                                           async_writes=False)
        step = CKPT_STEPS // 2
        state, _ = mgr.restore(like, step, device="cuda")
        toks = synthetic.make_lm_dataset(0, TRAIN_BATCH * TRAIN_SEQ,
                                         cfg.vocab).reshape(TRAIN_BATCH,
                                                            TRAIN_SEQ)
        batch = {"tokens": torch.from_numpy(toks).cuda().long(),
                 "labels": torch.from_numpy(np.roll(toks, -1, -1)).cuda()
                 .long()}
        reset_counts(fa, fa_bwd)
        grads = loss_grads(state["params"], batch, cfg,
                           SystemConfig(precision="bf16"))
        counts = read_counts(fa, fa_bwd)
        check(counts == (layers,) * 3,
              f"[dist] gradient step: expected {layers} launches each, "
              f"got {counts}")

        def int8_excess(reduced):
            """max over leaves of |reduced - g| in units of the leaf's int8
            scale, against the half-scale bound."""
            worst = 0.0
            for p, g in grads.items():
                scale = float(g.abs().max() / 127.0 + 1e-12)
                err = float((reduced[p] - g).abs().max())
                worst = max(worst, err / scale)
            return worst

        plain = collectives.compressed_grad_mean(grads, method="none")
        exact = all(torch.equal(plain[p], g) for p, g in grads.items())
        int8 = collectives.compressed_grad_mean(grads, method="int8")
        e8 = int8_excess(int8)
        quantize = compression.quantize_int8
        with patched(compression, "quantize_int8", lambda x: (
                quantize(x)[0], torch.ones((), device=x.device))):
            e_fault = int8_excess(collectives.compressed_grad_mean(
                grads, method="int8"))
        del plain, int8
        n_bytes = {m: compression.compressed_bytes(grads, m)
                   for m in ("none", "int8", "topk")}
        print(f"[dist] {card} | NCCL, world size 1 (the collectives are "
              f"copies here): full-width gradients of one step "
              f"({TRAIN_BATCH} x {TRAIN_SEQ}, {len(grads)} leaves, "
              f"launches B1/B2/B3 {counts}); method none equals the "
              f"gradients {'bit for bit' if exact else 'NOT bit for bit'}; "
              f"int8 within {e8:.6f} of a scale per element (limit "
              f"{DIST_HALF_SCALE:.6f}) {'ok' if e8 <= DIST_HALF_SCALE else 'FAIL'}"
              f"; planted fault, scales dropped on the wire: {e_fault:.3e} "
              f"{'caught' if e_fault > DIST_HALF_SCALE else 'MISSED'}",
              flush=True)
        check(exact, "an all-reduce over one rank changed the gradients")
        check(e8 <= DIST_HALF_SCALE, "int8 reduce beyond half a scale")
        check(e_fault > DIST_HALF_SCALE, "the int8 check misses dropped "
              "scales")
        ratio = n_bytes["int8"] / n_bytes["none"]
        print(f"[dist] compressed_bytes: fp32 {n_bytes['none']:,}, int8 "
              f"{n_bytes['int8']:,} ({ratio:.6f} of fp32), topk 1% "
              f"{n_bytes['topk']:,}", flush=True)
        check(abs(ratio - 0.25) < 1e-3, f"int8 carries {ratio} of fp32")
        ef = compression.init_ef(grads)
        times = {
            "compress_grads int8": cuda_ms(lambda: compression.compress_grads(
                grads, ef, "int8"), 1, warmup=1, windows=3),
            "compress_grads topk 1%": cuda_ms(
                lambda: compression.compress_grads(grads, ef, "topk", 0.01),
                1, warmup=1, windows=3),
            "compressed_grad_mean none": cuda_ms(
                lambda: collectives.compressed_grad_mean(grads,
                                                         method="none"),
                1, warmup=1, windows=3),
            "compressed_grad_mean int8": cuda_ms(
                lambda: collectives.compressed_grad_mean(grads,
                                                         method="int8"),
                1, warmup=1, windows=3)}
        del ef, grads
        torch.cuda.empty_cache()
        for name, t in times.items():
            print(f"[dist] {card} | {name} over the whole gradient "
                  f"({n_bytes['none'] / 1e9:.3f} GB fp32): {t:.3f} ms "
                  f"({t.spread()})", flush=True)

        mesh = mesh_lib.single_device_mesh()
        sys_cfg = SystemConfig(param_sharding="2d")
        specs = sharding.state_specs(state, cfg, mesh, sys_cfg)
        named_dims = sum(1 for s in tree_leaves(specs) for a in s if a)
        on_mesh = elastic.reshard_state(state, cfg, mesh, sys_cfg)
        tensors = [(a, b) for a, b in zip(tree_leaves(state),
                                           tree_leaves(on_mesh))
                   if torch.is_tensor(a)]
        all_dt = all(isinstance(b, DTensor) for _, b in tensors)
        back_ok = all(torch.equal(b.full_tensor(), a) for a, b in tensors)
        del on_mesh, tensors
        restored, meta = mgr.restore(
            like, step, placements=sharding.named(specs, mesh))
        pairs = [(a, b) for a, b in zip(tree_leaves(state),
                                         tree_leaves(restored))
                 if torch.is_tensor(a)]
        restore_ok = all(isinstance(b, DTensor) and torch.equal(
            b.full_tensor(), a) for a, b in pairs)
        del restored, pairs
        print(f"[dist] single_device_mesh {tuple(mesh.mesh_dim_names)} "
              f"{tuple(mesh.shape)}: state_specs name a mesh axis on "
              f"{named_dims} tensor dims; reshard_state onto it: "
              f"{'every leaf a DTensor' if all_dt else 'NOT all DTensors'}"
              f", full_tensor() {'equal bit for bit' if back_ok else 'DIFFERS'}"
              f"; the step-{step} checkpoint restored with placements= "
              f"{'equal bit for bit' if restore_ok else 'DIFFERS'} "
              f"(metadata {meta})", flush=True)
        check(all_dt and back_ok, "reshard_state changed the state")
        check(restore_ok, "restore with placements= changed the state")
        del state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    phase_s = time.perf_counter() - t_phase
    print(f"[dist] phase {phase_s:.1f} s (limit {DIST_PHASE_LIMIT_S:.0f} "
          f"s)", flush=True)
    check(phase_s < DIST_PHASE_LIMIT_S, f"the dist phase took {phase_s:.1f} s")
    return counts


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(least ms the card needs, what sets it), at the operations' peak."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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


def busy_union_ms(prof, skip=()):
    """(device busy ms, device activities) over a torch.profiler window:
    the union of the intervals of every device activity (kernels, copies,
    sets), so that kernels of two lanes that overlap count once. Events
    named in ``skip`` (a user range's span on the device) are left out."""
    from torch.autograd import DeviceType
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and e.name() not in skip)
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
    """A card ``TorchRealBackend`` at ``PAR_SIZES`` that logs every
    step's loss per trial (``.losses[id(TrialState)]``). ``fault`` plants a
    lane fault: the first trial it starts draws its batches in another
    order (the batch generator of the next seed, a wave-mate's stream)."""
    import dataclasses
    from repro_torch.core.backends import TorchRealBackend

    class Logged(TorchRealBackend):
        def __init__(self):
            super().__init__(**PAR_SIZES, device="cuda")
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
                           * PAR_SIZES["n_eval"] for a, b in
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
            .with_backend(FullWidth(steps_per_epoch=LM_FULL_STEPS,
                                    device="cuda"))
            .with_sys_space(space)
            .with_groundtruth(GroundTruth())
            .with_scheduler("random", n_trials=LM_FULL_TRIALS).run())
    wall = time.perf_counter() - t0
    counts = read_all(counters)
    per = lm_launches(FullWidth.log, f"full-width {LM_FULL_ARCH}", card)
    total = tuple(sum(v[i] for v in per.values()) for i in range(3))
    losses = [e.loss for r in full.records.values() for e in r.epochs]
    print(f"[lmtune] {card} | full-width {LM_FULL_ARCH} PipeTune random "
          f"{LM_FULL_TRIALS} x {LM_FULL_EPOCHS} epochs of {LM_FULL_STEPS} "
          f"steps: best final loss "
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

    if sys.argv[1:2] == ["--train-child"]:
        return train_child(train, fa, fa_bwd, int(sys.argv[2]), sys.argv[3:])
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
    counters = [("B1", fa, "launches"), ("B2", fa_bwd, "launches_dq"),
                ("B3", fa_bwd, "launches_dkv"), ("B4", ml, "launches"),
                ("B5", rg, "launches")]
    archs_launches = phase_archs(fa, fa_bwd, serve, steps, card)
    hybrid_serve_b1, hybrid_train_counts = phase_hybrid(fa, fa_bwd, steps,
                                                        card)
    vlm_serve_b1, vlm_train_counts = phase_vlm(fa, fa_bwd, steps, card)
    ssm_counts = phase_ssm(counters, steps, card, ml)
    phase_encdec(counters, steps, card)
    _, train_counts = phase_train(fa, fa_bwd, train, card)
    phase_grad(fa_bwd)
    try:
        ckpt_counts, resume_counts, ckpt_depth = phase_ckpt(fa, fa_bwd,
                                                            train, card)
        dist_counts = phase_dist(fa, fa_bwd, card, ckpt_depth)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # B1 at the serve shape, B2 and B3 at the train shape (each call times
    # all three)
    timing = time_attention(fa, fa_bwd, card, "serve", *SERVE_SHAPE, None,
                            torch.bfloat16)["B1"]
    bwd_timing = time_attention(fa, fa_bwd, card, "train", *TRAIN_SHAPE,
                                None, torch.bfloat16)
    hybrid_timing = phase_hybrid_timing(fa, fa_bwd, card)
    vlm_timing = time_attention(fa, fa_bwd, card, "vlm", *VLM_SERVE,
                                *vlm_shapes()[0][3:], None, torch.bfloat16)
    mlstm_errs = phase_mlstm(ml)
    rglru_errs = phase_rglru(rg)
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
    train_errs, rg_errs = bwd_errs["train"], bwd_errs["rg_serve"]
    vlm_errs = bwd_errs["vlm_serve"]

    def hybrid_rows(kid, err):
        """A kernel's [hybrid] readings: head_dim 256 at the serve shape
        (bf16, beside SDPA) and its fp32 variant's times."""
        return {"d256": {"max_abs_err": err, **hybrid_timing["d256"][kid]},
                "fp32": {name: rows[kid]
                         for name, rows in hybrid_timing["fp32"].items()}}
    kernels = [
        {"name": "flash_attention", "id": "B1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:28",
         "launches": launches, "launches_archs": archs_launches,
         "launches_lmtune": lm_counts[0],
         "launches_hybrid": hybrid_serve_b1 + hybrid_train_counts[0],
         "launches_vlm": vlm_serve_b1 + vlm_train_counts[0],
         "launches_ckpt": ckpt_counts[0],
         "launches_ckpt_resume": resume_counts[0],
         "launches_dist": dist_counts[0],
         "vlm": {"max_abs_err": errs["vlm_serve"], **vlm_timing["B1"]},
         "max_abs_err": errs["serve"], **timing,
         **hybrid_rows("B1", errs["rg_serve"])},
        {"name": "flash_attention_bwd_dq", "id": "B2", "route": "cuda",
         "source": src_bwd,
         "replaces": "src/repro/kernels/flash_attention_bwd.py:43",
         "launches": train_counts[1], "launches_lmtune": lm_counts[1],
         "launches_hybrid": hybrid_train_counts[1],
         "launches_vlm": vlm_train_counts[1],
         "launches_ckpt": ckpt_counts[1],
         "launches_ckpt_resume": resume_counts[1],
         "launches_dist": dist_counts[1],
         "vlm": {"max_abs_err": vlm_errs[0][0], **vlm_timing["B2"]},
         "max_abs_err": train_errs[0][0],
         **bwd_timing["B2"], **hybrid_rows("B2", rg_errs[0][0])},
        {"name": "flash_attention_bwd_dkv", "id": "B3", "route": "cuda",
         "source": src_bwd,
         "replaces": "src/repro/kernels/flash_attention_bwd.py:87",
         "launches": train_counts[2], "launches_lmtune": lm_counts[2],
         "launches_hybrid": hybrid_train_counts[2],
         "launches_vlm": vlm_train_counts[2],
         "launches_ckpt": ckpt_counts[2],
         "launches_ckpt_resume": resume_counts[2],
         "launches_dist": dist_counts[2],
         "vlm": {"max_abs_err": max(vlm_errs[1][0], vlm_errs[2][0]),
                 **vlm_timing["B3"]},
         "max_abs_err": max(train_errs[1][0], train_errs[2][0]),
         **bwd_timing["B3"],
         **hybrid_rows("B3", max(rg_errs[1][0], rg_errs[2][0]))},
        {"name": "mlstm", "id": "B4", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mlstm.cu",
         "replaces": "src/repro/kernels/mlstm.py:27",
         "launches": tune_counts["B4"],
         "launches_ssm": sum(c["B4"] for c in ssm_counts[:2]),
         "ssm_plain_mlstm_ms": ssm_counts[2],
         "max_abs_err": mlstm_errs["full_c128"],
         **rec_timing[("mlstm", "tuned")]},
        {"name": "rglru", "id": "B5", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru.cu",
         "replaces": "src/repro/kernels/rglru.py:24",
         "launches": tune_counts["B5"],
         "launches_ssm": sum(c["B5"] for c in ssm_counts[:2]),
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
