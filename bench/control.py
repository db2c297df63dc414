"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 bench/control.py --workload <cell> --program-seeds a,b,... \\
        --control-seeds x,y,z [--seconds 2] [--out FILE]

* the program: a whole run of the cell (``run.run_cell``: set-up, a short
  window, the comparison) on each program seed; its compared numbers are
  the lower readings;
* the control: the reference in the program's place, computed in float8
  e4m3 where the program computes in bf16 (the precision below the
  configuration's), against the cell's reference on the same steps;
* the planted fault "half of the batch left out": the reference in the
  program's place with the labels of half of the batch ignored, so that
  the mean is taken over the rest (half the rows, or of a one-row batch
  half its tokens);
* the reference's own witness, where the cell's reference runs its
  products in TF32 (``reference_mode``): the same steps with TF32 off,
  read against it as the program is.

The control, the fault and the witness are read against the cell's own
reference, on the steps the cell's check compares.

The other fault a training cell can have, a step that returns its state
unchanged, reads 1 on ``grad_gap`` and ``change_gap`` by their
definition and needs no run (``bench/tests/test_faults.py`` runs it).
Each line of output is one JSON record; the benchmark's own runs never run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import run as bench_run  # noqa: E402
from bench.harness import check, spec, weights  # noqa: E402


def half_batch(batch: dict) -> dict:
    """The labels of half the batch set to -1 (ignored): half the rows, or
    half the tokens of a one-row batch."""
    labels = batch["labels"].clone()
    B, S = labels.shape
    if B > 1:
        labels[B // 2:] = -1
    else:
        labels[:, S // 2:] = -1
    return dict(batch, labels=labels)


def checked_steps(traffic: dict, cfg: dict, seed: int, device) -> dict:
    """What the cell's check compares: "batches", "hp", the weight stream
    "names" and "grad" (the reference's reading the first gradient is held
    to: adamw's first moment in the train cell, the gradient the optimizer
    got in the tune cell)."""
    from bench.harness import train, tune
    B, S = traffic["batch"], traffic["seq"]
    if traffic["kind"] == "train":
        feed = weights.batches(cfg, seed, device, B, S)
        return {"batches": [next(feed)
                            for _ in range(traffic["checked_steps"])],
                "hp": train.hyper(traffic), "names": (), "grad": "grad"}
    names = ("trial", tune.CHECKED_TRIAL)
    feed = weights.batches(cfg, seed, device, B, S, *names)
    lr = tune.first_learning_rate(cfg, traffic, seed)
    return {"batches": [next(feed)
                        for _ in range(traffic["steps_per_epoch"])],
            "hp": train.hyper(dict(traffic, lr=lr)), "names": names,
            "grad": "raw_grad"}


def side_readings(cfg, seed, device, plan, feed, mode, ref):
    """The check's numbers of a run of the reference in ``mode`` on
    ``feed``, put in the program's place, against ``ref``."""
    got = check.run_reference(cfg, seed, device, feed, plan["hp"],
                              plan["names"], mode)
    got["grad"] = got[plan["grad"]]
    return check.readings(got, ref), check.leaf_detail(got, ref), \
        got["losses"]


def control_readings(cell: str, seed: int, device="cuda") -> dict:
    bench = spec.load_benchmark()
    entry = spec.workload_entry(bench, cell)
    traffic, cfg = spec.traffic(cell), spec.config(entry["config"])
    ctx = bench_run.make_context(traffic, cfg, seed, 0, False, device)
    plan = checked_steps(traffic, cfg, seed, ctx.device)
    batches, mode = plan["batches"], traffic["reference_mode"]
    out = {"steps": len(batches)}
    t0 = time.perf_counter()
    ref = check.run_reference(cfg, seed, ctx.device, batches, plan["hp"],
                              plan["names"], mode)
    ref["grad"] = ref[plan["grad"]]
    out["reference_s"] = time.perf_counter() - t0
    ctx.free()
    sides = {"control": (batches, "fp8"),
             "fault_half": ([half_batch(b) for b in batches], mode)}
    if mode != "fp32":
        sides["witness_fp32"] = (batches, "fp32")
    losses = {"reference": ref["losses"]}
    for side, (feed, m) in sides.items():
        out[side], out[side + "_leaves"], losses[side] = side_readings(
            cfg, seed, ctx.device, plan, feed, m, ref)
        ctx.free()
    out["losses"] = losses
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for s in filter(None, args.program_seeds.split(",")):
        t0 = time.perf_counter()
        res = bench_run.run_cell(args.workload, int(s), args.seconds, 0,
                                 t_start=t0)
        rec = res.pop("record")
        emit({"workload": args.workload, "seed": int(s), "side": "program",
              "correct": res["correct"], "readings": rec["readings"],
              "leaves": rec.get("leaves"),
              "metrics": res["metrics"], "steps": rec["steps"],
              "tune": rec.get("tune"), "wall_s": time.perf_counter() - t0})
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        rec = control_readings(args.workload, int(s))
        emit({"workload": args.workload, "seed": int(s), "side": "control",
              **rec, "wall_s": time.perf_counter() - t0})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
