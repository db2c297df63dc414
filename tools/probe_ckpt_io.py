"""Where a checkpoint's time goes on the card's host, one leaf at a time.

    python3 tools/probe_ckpt_io.py [--elements 155582464]

Times, for one fp32 tensor the size of full-width qwen3-0.6b's embedding
(622 MB), each part of ``repro_torch.checkpoint``'s save and restore: the
device-to-host copy into fresh pageable memory (what ``save()`` does), into
pageable memory already touched and into pinned memory (with the pinned
allocation itself); ``np.save``, a read back, sha256 over bytes in memory
(and on 2, 4 and 8 threads at once), ``np.load`` and the host-to-device
copy. Each line gives seconds and GB/s, twice, after the host's core count
and whether its CPU has SHA instructions. Files go under
``build/probe_ckpt_io`` (removed at the end). Needs a GPU.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

OUT = Path(__file__).resolve().parents[1] / "build" / "probe_ckpt_io"


def timed(name, nbytes, fn, reps=2):
    out = None
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{name} (rep {rep}): {dt:.3f} s, {nbytes / dt / 1e9:.2f} GB/s",
              flush=True)
    return out


def on_threads(n, fn):
    threads = [threading.Thread(target=fn) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elements", type=int, default=155_582_464)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ckpt_io: needs a CUDA device")
    flags = Path("/proc/cpuinfo").read_text() if Path(
        "/proc/cpuinfo").exists() else ""
    print(f"cores {os.cpu_count()}, sha_ni {'sha_ni' in flags}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    n = args.elements
    nbytes = 4 * n
    x = torch.randn(n, device="cuda")
    timed("device to fresh pageable host memory", nbytes,
          lambda: torch.empty(n).copy_(x))
    touched = torch.zeros(n)
    timed("device to touched pageable host memory", nbytes,
          lambda: touched.copy_(x))
    pinned = timed("pinned allocation", nbytes,
                   lambda: torch.empty(n, pin_memory=True), reps=1)
    timed("device to pinned host memory", nbytes, lambda: pinned.copy_(x))
    OUT.mkdir(parents=True, exist_ok=True)
    try:
        arr, path = touched.numpy(), OUT / "leaf.npy"
        timed("np.save", nbytes,
              lambda: np.save(path, arr, allow_pickle=False))
        raw = timed("read back", nbytes, path.read_bytes)
        timed("sha256 in memory", nbytes,
              lambda: hashlib.sha256(raw).hexdigest())
        for k in (2, 4, 8):
            timed(f"sha256 on {k} threads at once (total)", k * nbytes,
                  lambda k=k: on_threads(
                      k, lambda: hashlib.sha256(raw).hexdigest()), reps=1)
        back = timed("np.load", nbytes, lambda: np.load(path))
        timed("host to device", nbytes,
              lambda: torch.from_numpy(back).to("cuda"))
    finally:
        shutil.rmtree(OUT, ignore_errors=True)


if __name__ == "__main__":
    main()
