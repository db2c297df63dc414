#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. print the card (nvidia-smi name and power limit); build every kernel of
     ``src/repro_torch/kernels/csrc`` with nvcc and print the build time and
     ptxas's register report;
  2. hold each kernel against its plain PyTorch version on the card, at the
     serve shape and at ragged, windowed, non-causal, fp32 and other
     group-size shapes;
  3. serve full-width qwen3-0.6b (seeded bf16 weights, 8 requests of 2048
     prompt tokens, 32 generated) through ``repro_torch.launch.serve.main``,
     with every launch counter set to 0 just before and read just after; the
     flash kernel must have run 28 times (one per layer) per prefill. Then
     recompute the prefill logits on the plain attention path
     (``use_pallas=False``) in bf16 and in fp32, and hold both bf16 paths
     against the fp32 one (``LOGITS_RATIO``). A planted fault (one kv tile
     hidden from the later rows) must fail both this check and phase 2's;
  4. time the kernel at the serve shape beside its bound, its plain version
     and one PyTorch library call of the same function
     (``scaled_dot_product_attention`` with the kv heads expanded, timed here
     only: the port never calls it).
Then it prints the ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the repo's
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
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

ARCH = "qwen3-0.6b"
REQUESTS, PROMPT_LEN, GEN = 8, 2048, 32


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


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_serve(fa, serve, steps):
    import dataclasses
    import torch
    fa.launches = 0
    res = serve.main(["--arch", ARCH, "--requests", str(REQUESTS),
                      "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN),
                      "--seed", "0"])
    torch.cuda.synchronize()
    launches = fa.launches
    cfg = res.cfg
    print(f"[serve] flash_attention launches: {launches} over "
          f"{res.prefills} prefills of {cfg.n_layers} layers", flush=True)
    check(launches == cfg.n_layers * res.prefills,
          f"expected {cfg.n_layers * res.prefills} kernel launches, "
          f"got {launches}")
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


def phase_timing(fa, card):
    import torch
    import torch.nn.functional as F
    B, S, K, G, D = REQUESTS, PROMPT_LEN, 8, 2, 128
    H = K * G
    q, k, v = attention_inputs(B, S, S, K, G, D, torch.bfloat16, seed=100)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=3,
                       warmup=1)
    qh = q.reshape(B, S, H, D).transpose(1, 2).contiguous()
    kh = k[:, :, :, None].expand(B, S, K, G, D).reshape(B, S, H, D)
    vh = v[:, :, :, None].expand(B, S, K, G, D).reshape(B, S, H, D)
    kh, vh = kh.transpose(1, 2).contiguous(), vh.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), iters=20)
    flops = 4.0 * B * H * D * visible_pairs(S, S, True, None)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * S * H
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[timing] {card} | flash_attention B={B} S=T={S} H={H} K={K} "
          f"D={D} bf16 causal: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
          f"({bound_by}; {flops:.3e} FLOP, {nbytes:.3e} B), plain "
          f"{plain_ms:.4f} ms, library (SDPA, kv heads expanded) "
          f"{library_ms:.4f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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
    from repro_torch.launch import serve, steps

    card = card_line()
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
        log = lib.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)

    errs = phase_kernels(fa)
    res, launches = phase_serve(fa, serve, steps)
    print(f"[serve] {card} | prefill {res.prefill_tok_s:.1f} tok/s "
          f"({res.prefill_ms:.3f} ms for {REQUESTS}x{PROMPT_LEN}), decode "
          f"{res.decode_tok_s:.1f} tok/s ({res.decode_ms / (GEN - 1):.3f} "
          f"ms/step at batch {REQUESTS})", flush=True)
    del res
    torch.cuda.empty_cache()
    timing = phase_timing(fa, card)

    kernels = [{
        "name": "flash_attention", "id": "B1", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches, "max_abs_err": errs["serve"], **timing}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
