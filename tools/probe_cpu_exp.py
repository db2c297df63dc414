"""Probe PyTorch's CPU exp on its first call in a fresh process, and the
LM example's epoch on the CPU and on the card from one initial state.

    PYTHONPATH=src python tools/probe_cpu_exp.py [--runs 240] [--jobs 8]
    PYTHONPATH=src python tools/probe_cpu_exp.py --modes lm,lm-1 --runs 40
    PYTHONPATH=src python tools/probe_cpu_exp.py --modes lm-cuda --runs 16

Each run is a new Python process whose first torch op is one of:

  fp32      torch.exp of a (2, 254, 128) fp32 slice on the default threads
  fp32-1    the same after torch.set_num_threads(1)
  fp64      the same in float64
  rglru     repro_torch's rglru_reference at (2, 256, 128), against a
            float64 loop at the rglru test's tolerance (1e-5 + 1e-5|h|)
  lm        one epoch (6 steps, remat none, 1 microbatch, fp32, lr 2e-3,
            seed 0) of examples/torch_tune_llm_sysparams.py's LMBackend on
            the CPU, on the default threads
  lm-1      the same after torch.set_num_threads(1)
  lm-cuda   the same epoch on the card (B1-B3 in fp32, built beforehand
            under build/torch_kernels), from the CPU trial's initial state

and prints a line when an element is off (exp: relative error above 1e-6;
lm: a step loss further than 1e-6 * (1 + |loss|) from the reference
epoch, which one lm-1 process runs first). The summary gives, per mode,
the runs with an element off and the worst error: relative for exp, the
share of the tolerance for rglru, the step loss distance for lm; for the
lm modes also the number of distinct loss sequences among the runs.
``--jobs`` processes run at once, so that the runs compete for the cores
as a parallel test suite's workers do.
"""
import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CHILD = r'''
import sys, numpy as np, torch
mode = sys.argv[1]
rng = np.random.default_rng(0)
la = (-np.abs(rng.standard_normal((2, 256, 128))) * 0.1).astype(np.float32)
if mode.startswith("lm"):
    import importlib.util, json
    if mode == "lm-1":
        torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location("example", sys.argv[2])
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    from repro_torch.launch import steps
    from repro_torch.models.transformer import SystemConfig
    from repro_torch.tree import tree_map
    sys_cfg = {"remat": "none", "microbatches": 1, "precision": "fp32"}
    be = example.LMBackend(device="cpu")
    ts = be.init_trial("tune-lm", {"learning_rate": 2e-3}, seed=0)
    if mode == "lm-cuda":
        state = ts.params[0]
        be = example.LMBackend(device="cuda")
        ts = be.init_trial("tune-lm", {"learning_rate": 2e-3}, seed=0)
        ts.params = ({"params": tree_map(lambda a: a.to("cuda", copy=True),
                                         state["params"]),
                      "opt": tree_map(lambda a: a.to("cuda", copy=True),
                                      state["opt"]),
                      "step": state["step"]}, ts.params[1])
    step = steps.make_train_step(ts.cfg, SystemConfig(**sys_cfg),
                                 ts.params[1])
    log = []

    def logged(state, batch):
        state, m = step(state, batch)
        log.append(float(m["loss"]))
        return state, m
    be._cache[("step", str(sys_cfg), 2e-3)] = logged
    be.run_epoch(ts, sys_cfg)
    print(json.dumps(log))
    sys.exit(0)
if mode == "rglru":
    from repro_torch.kernels import rglru
    b = rng.standard_normal((2, 256, 128)).astype(np.float32)
    got = rglru.rglru_reference(torch.from_numpy(la),
                                torch.from_numpy(b))[0].numpy()
    h, want = np.zeros((2, 128)), []
    for t in range(256):
        h = np.exp(la[:, t].astype(np.float64)) * h + b[:, t]
        want.append(h)
    want = np.stack(want, 1)
    used = np.abs(got - want) / (1e-5 + 1e-5 * np.abs(want))
    off, err = used > 1, float(used.max())
else:
    if mode == "fp32-1":
        torch.set_num_threads(1)
    x = la[:, 2:].astype(np.float64 if mode == "fp64" else np.float32)
    got = torch.exp(torch.from_numpy(x)).numpy().astype(np.float64)
    want = np.exp(x.astype(np.float64))
    rel = np.abs(got - want) / want
    off, err = rel > 1e-6, float(rel.max())
print(f"{int(off.sum())} {err:.3e}")
'''

EXAMPLE = str(Path(__file__).resolve().parent.parent / "examples"
              / "torch_tune_llm_sysparams.py")
LM_TOL = 1e-6


def child(mode):
    out = subprocess.run([sys.executable, "-c", CHILD, mode, EXAMPLE],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(out.stderr)
    return out.stdout


def run(mode, ref=None):
    """(elements off, worst error, the lm losses or None)."""
    if mode.startswith("lm"):
        got = json.loads(child(mode))
        dist = [abs(g - w) / (1 + abs(w)) for g, w in zip(got, ref)]
        return sum(d > LM_TOL for d in dist), max(dist), tuple(got)
    n, err = child(mode).split()
    return int(n), float(err), None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=240)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--modes", default="fp32,fp32-1,fp64,rglru")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    ref = (json.loads(child("lm-1")) if any(m.startswith("lm")
                                             for m in modes) else None)
    summary = {}
    for mode in modes:
        with ThreadPoolExecutor(args.jobs) as pool:
            got = list(pool.map(lambda m: run(m, ref), [mode] * args.runs))
        bad = [(n, e) for n, e, _ in got if n]
        for n, e in bad:
            print(f"{mode}: {n} elements off, worst error {e:.3e}",
                  flush=True)
        summary[mode] = {"runs": args.runs, "runs_off": len(bad),
                         "worst": max(e for _, e, _ in got)}
        if mode.startswith("lm"):
            summary[mode]["distinct"] = len({g for _, _, g in got})
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
