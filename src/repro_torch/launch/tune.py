"""HPT-job launcher: run a full PipeTune (or baseline) tuning job, the
counterpart of ``repro.launch.tune``.

    PYTHONPATH=src python -m repro_torch.launch.tune --workload lenet-mnist \\
        --system pipetune --scheduler hyperband --epochs 6 [--device cpu]

Tuners, backends, and schedulers resolve through the ``repro_torch.api``
registries — ``--system``/``--backend``/``--scheduler`` accept anything
registered there, including third-party plugins imported via ``--plugin``.
The defaults are the reference's (PipeTune, hyperband, 6 epochs, the real
backend at n_train 1024, n_eval 256, 8 steps an epoch), and so is the
printout. ``--device`` (cuda by default; without a GPU the command raises
unless ``--device cpu`` is given) goes to the backend. PipeTune tunes
against a fresh in-process ground-truth store. Not ported yet:
``--kernel-db`` (ROADMAP queue A, item 8) and the store flags ``--store``,
``--gt-store`` and ``--store-reset`` (item 12), and every executor but the
serial one (2b (iii)).
"""
from __future__ import annotations

import argparse
import importlib
import json
from typing import Optional, Sequence

from repro_torch.api import (Experiment, available_backends,
                             available_executors, available_schedulers,
                             available_tuners)
from repro_torch.core.groundtruth import GroundTruth
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.core.pipetune import JobResult
from repro_torch.launch.sysargs import add_executor_args, executor_from_args


def main(argv: Optional[Sequence[str]] = None) -> JobResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="lenet-mnist")
    ap.add_argument("--system", default="pipetune",
                    help=f"tuner name; registered: {available_tuners()}")
    ap.add_argument("--scheduler", default="hyperband",
                    help="scheduler name; registered: "
                         f"{available_schedulers()}")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--backend", default="real",
                    help=f"backend name; registered: {available_backends()}")
    add_executor_args(ap)   # --executor / --parallelism
    ap.add_argument("--device", default=None,
                    help="device the backend trains on: cuda (default) or "
                         "cpu")
    ap.add_argument("--plugin", action="append", default=[],
                    help="module to import for register_* side effects")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    for mod in args.plugin:
        importlib.import_module(mod)

    space = SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 128)),
        Param("learning_rate", "log", 0.001, 0.1),
        Param("dropout", "float", 0.0, 0.5),
    ])
    job = HPTJob(workload=args.workload, space=space, max_epochs=args.epochs)

    backend_kw = {"n_train": 1024, "n_eval": 256, "steps_per_epoch": 8} \
        if args.backend == "real" else {}
    if args.device is not None:
        backend_kw["device"] = args.device
    tuner_kw = {"max_probes": 4} if args.system == "pipetune" else {}
    sched_kw = {"n_trials": 6} if args.scheduler == "random" else {}

    exp = (Experiment(job)
           .with_tuner(args.system, **tuner_kw)
           .with_backend(args.backend, **backend_kw)
           .with_scheduler(args.scheduler, **sched_kw))
    if args.system == "pipetune":
        # only attach a store when the tuner consumes one
        exp = exp.with_groundtruth(GroundTruth())
    executor = executor_from_args(args)
    res = exp.run(executor=executor)

    print(f"workload={args.workload} system={args.system} "
          f"scheduler={args.scheduler} "
          f"executor={type(executor).__name__} "
          f"(registered: {available_executors()})")
    print(f"  best accuracy : {res.best_accuracy:.4f}")
    print(f"  best hparams  : {res.best_hparams}")
    print(f"  tuning time   : {res.tuning_time_s:.1f}s "
          f"({len(res.records)} trials)")
    if res.sim_time_s:
        print(f"  cluster makespan: {res.sim_time_s:.1f}s simulated")
    print(f"  energy        : {res.energy_j/1e3:.1f} kJ")
    if args.system == "pipetune":
        print(f"  ground truth  : {res.gt_hits} hits / {res.gt_misses} misses")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"accuracy": res.best_accuracy,
                       "hparams": res.best_hparams,
                       "tuning_time_s": res.tuning_time_s,
                       "energy_j": res.energy_j}, f, indent=1)
    return res


if __name__ == "__main__":
    main()
