#!/usr/bin/env python3
"""Is a lenet-mnist trial of ``TorchRealBackend`` bit-reproducible on the
card, with cuDNN free to pick nondeterministic convolution algorithms and
with ``torch.backends.cudnn.deterministic`` set?

    python3 tools/probe_lenet_determinism.py [REPS]

For each batch size of the tuning launcher's search space (32, 64, 256,
1024) it trains the same trial (2 epochs of 8 steps, fixed hparams and
seed) REPS times in this process, each on a fresh backend, in each mode,
and prints how many distinct (losses, accuracies) outcomes the repeats
gave, the largest distance between them, and the median epoch time. The
backend is built with the flag as the mode sets it after construction, so
the probe reads cuDNN, not the backend's own choice. Needs a GPU.
"""
import statistics
import struct
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def trial(backend_cls, bs, deterministic):
    import torch
    be = backend_cls(device="cuda")
    torch.backends.cudnn.deterministic = deterministic
    ts = be.init_trial("lenet-mnist", {"batch_size": bs,
                                       "learning_rate": 0.02,
                                       "dropout": 0.25}, seed=3)
    out, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        ts, res = be.run_epoch(ts, {"remat": "none", "microbatches": 1,
                                    "precision": "fp32"})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out += [res.loss, res.accuracy]
    return tuple(out), times


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_lenet_determinism: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.backends import TorchRealBackend
    reps = int(sys.argv[1]) if sys.argv[1:] else 5
    print(f"[card] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, cudnn {torch.backends.cudnn.version()}",
          flush=True)
    trial(TorchRealBackend, 64, False)          # warm-up: context, kernels
    for deterministic in (False, True):
        for bs in (32, 64, 256, 1024):
            runs = [trial(TorchRealBackend, bs, deterministic)
                    for _ in range(reps)]
            outs = [r[0] for r in runs]
            bits = {tuple(struct.pack(">d", x) for x in o) for o in outs}
            dist = max(abs(a - b) for o in outs for a, b in zip(o, outs[0]))
            ms = statistics.median(t for r in runs for t in r[1]) * 1e3
            print(f"cudnn.deterministic={deterministic} batch {bs}: "
                  f"{len(bits)} distinct outcome(s) of {reps}, largest "
                  f"distance {dist:.3e}, median epoch {ms:.2f} ms",
                  flush=True)
    torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
