"""Run one cell of the port's benchmark once, on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its files are found by name (``bench/harness/spec.py``). Set-up makes the
weights and batches on the card from ``--seed`` and warms the cell's
shapes; the window then runs for ``--seconds``; the outputs of its steps
are compared with the plain reference once it has closed. The last line
of standard output is one JSON object: ``correct``, ``attempted`` and
``failed`` (train steps), ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also end standard error.

Without a CUDA card the command fails; it never runs on the CPU. It fails
too if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _NoEnergy:
    def read(self):
        return None

    def power_limit_w(self):
        return None


def make_context(traffic, cfg, seed, seconds, trace, device, wrap_step=None,
                 t_start=None):
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        from bench.harness import nvml
        energy = nvml.Energy(dev.index or 0, nvml.card_uuid(dev))
    else:
        energy = _NoEnergy()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    return types.SimpleNamespace(
        traffic=traffic, cfg=cfg, seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=dev, cuda=cuda, energy=energy,
        t_start=T_START if t_start is None else t_start,
        wrap_step=wrap_step or (lambda f: f),
        sync=(lambda: torch.cuda.synchronize(dev)) if cuda else
        (lambda: None),
        peak_bytes=(lambda: torch.cuda.max_memory_allocated(dev)) if cuda
        else (lambda: 0),
        free=free)


def run_cell(cell, seed, seconds, trace, device="cuda", wrap_step=None,
             traffic=None, cfg=None, bench=None, t_start=None) -> dict:
    """One run of ``cell``: the result object, the run's record under
    ``"record"``. ``traffic``, ``cfg`` and ``bench`` replace the files
    (the CPU tests run tiny cells through here)."""
    from bench.harness import check, spec
    bench = bench or spec.load_benchmark()
    entry = spec.workload_entry(bench, cell)
    traffic = traffic or spec.traffic(cell)
    cfg = cfg or spec.config(entry["config"])
    ctx = make_context(traffic, cfg, seed, seconds, trace, device, wrap_step,
                       t_start)
    rec = spec.driver(traffic["kind"]).run(ctx)
    correct, checks = check.verdict(rec["readings"], traffic["limits"])
    metrics = spec.read_metrics(spec.metrics_of(bench, cell, bool(trace)),
                                rec)
    import torch
    dev_info = {"platform": "gpu" if ctx.cuda else "cpu",
                "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": bool(correct and rec["failed"] == 0),
           "attempted": rec["steps"], "failed": rec["failed"],
           "metrics": metrics, "device": dev_info}
    if rec["trace"] is not None:
        dev_info.update(busy_s=rec["trace"]["busy_s"],
                        window_s=rec["trace"]["window_s"])
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = checks
    out["record"] = rec
    out["power_limit_w"] = ctx.energy.power_limit_w()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness import spec
    bench = spec.load_benchmark()
    entry = spec.workload_entry(bench, args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < entry["chips"]:
        print(f"bench: {entry['chips']} CUDA card(s) needed, {cards} found; "
              "the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, args.trace,
                   bench=bench)
    rec = out.pop("record")
    power = out.pop("power_limit_w")
    found = forbidden_modules()
    if found:
        print(f"bench: loaded after the window: {found}", file=sys.stderr)
        return 3
    info = {k: v for k, v in rec.items()
            if k not in ("trace", "readings", "leaves")}
    if rec["trace"] is not None:
        info["trace"] = {k: v for k, v in rec["trace"].items()
                         if k not in ("device_ops", "idle_gaps")}
    info["power_limit_w"] = power
    print("bench: record " + json.dumps(info, default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
