"""Where serve time goes on the card: a ``torch.profiler`` trace of one prefill
and a few decode steps of ``repro_torch.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [serve flags] [--trace-dir build/traces]

For one prefill and for the next four decode steps it prints the window's
wall time (host clock around work that ends in a synchronise, profiler on),
the device's busy time (the sum of kernel times: one stream, so kernels do
not overlap), the idle share, and the fifteen kernels that take the most
device time. The Chrome traces go to ``--trace-dir``. It needs the card:
the CPU has no device time to read.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve as serve_lib
from repro_torch.launch import steps as steps_lib

DECODE_STEPS = 4
TOP = 15


def _report(name, prof, wall_ms):
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {name}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        ms = e.self_device_time_total / 1e3
        print(f"[profile] {name}:   {ms:9.3f} ms {ms / busy_ms:6.1%} "
              f"x{e.count:<5d} {e.key[:100]}")


def main(argv=None):
    ap = serve_lib.parser()
    ap.add_argument("--trace-dir", default="build/traces")
    args = ap.parse_args(argv)
    cfg, sys, params, prompts = serve_lib.setup(args)
    if prompts.device.type != "cuda":
        raise RuntimeError("profile_serve reads device time: run it on the "
                           "card")
    S = prompts.shape[1]
    prefill = steps_lib.make_prefill_step(cfg, sys, max_len=S + args.gen)
    decode = steps_lib.make_decode_step(cfg, sys)
    logits, cache = prefill(params, {"tokens": prompts})          # warm-up
    tok = logits[:, -1].argmax(-1)[:, None]
    decode(params, cache, tok, S)
    del cache, logits
    torch.cuda.synchronize()

    out = Path(args.trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts})
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out / "serve_prefill_trace.json"))
    _report("prefill", prof, wall)

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS):
            step_logits, cache = decode(params, cache, tok, S + i)
            tok = step_logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out / "serve_decode_trace.json"))
    _report(f"decode x{DECODE_STEPS}", prof, wall)


if __name__ == "__main__":
    main()
