"""HPT-job launcher: run a full PipeTune (or baseline) tuning job, the
counterpart of ``repro.launch.tune``.

    PYTHONPATH=src python -m repro_torch.launch.tune --workload lenet-mnist \\
        --system pipetune --scheduler hyperband --epochs 6 [--device cpu] \\
        [--parallelism 4 | --executor cluster --cluster-nodes 4]
    PYTHONPATH=src python -m repro_torch.launch.tune --backend sim \\
        --system pipetune --scheduler hyperband --epochs 9 --parallelism 4
    PYTHONPATH=src python -m repro_torch.launch.tune --backend numeric \\
        --workload jacobi-rodinia --scheduler random [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.tune --store tcp://H:P \\
        [--workers tcp://H:P2,... | --coordinator tcp://H:P3]

Tuners, backends, and schedulers resolve through the ``repro_torch.api``
registries — ``--system``/``--backend``/``--scheduler`` accept anything
registered there, including third-party plugins imported via ``--plugin``.
The defaults are the reference's (PipeTune, hyperband, 6 epochs, the real
backend at n_train 1024, n_eval 256, 8 steps an epoch), and so is the
printout, with the cluster makespan when the job ran on the simulated
cluster. ``--device`` (cuda by default; without a GPU the command raises
unless ``--device cpu`` is given) goes to the real and numeric backends;
``--backend sim`` models the epochs and touches no device. The executor
flags and ``--kernel-db`` (installed before the first trial, so the real
backend's trials pick up tuned ``train_step`` configs for the sys keys a
tuner leaves unset) are ``launch.sysargs``'s, and so are the store flags:
``--store inproc`` (the default: a fresh in-process
``GroundTruthService``, journaled to ``--gt-store`` when given) or
``--store tcp://HOST:PORT`` of a ``python -m repro_torch.service`` that
remote workers (``--workers tcp://...``, ``--coordinator``) share.
"""
from __future__ import annotations

import argparse
import importlib
import json
from typing import Optional, Sequence

from repro_torch.api import (Experiment, available_backends,
                             available_executors, available_schedulers,
                             available_tuners)
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.core.pipetune import JobResult
from repro_torch.launch.sysargs import (add_executor_args, add_kernel_db_arg,
                                        add_store_args, executor_from_args,
                                        install_kernel_db_from_args,
                                        store_client_from_args)


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
    add_executor_args(ap)   # --executor / --parallelism / --cluster-nodes
    add_store_args(ap)      # --store / --gt-store / --store-reset
    add_kernel_db_arg(ap)   # --kernel-db: tuned kernel configs
    ap.add_argument("--device", default=None,
                    help="device the real and numeric backends run on: "
                         "cuda (default) or cpu; sim touches no device")
    ap.add_argument("--plugin", action="append", default=[],
                    help="module to import for register_* side effects")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    for mod in args.plugin:
        importlib.import_module(mod)
    install_kernel_db_from_args(args)

    space = SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 128)),
        Param("learning_rate", "log", 0.001, 0.1),
        Param("dropout", "float", 0.0, 0.5),
    ])
    job = HPTJob(workload=args.workload, space=space, max_epochs=args.epochs)

    backend_kw = {"n_train": 1024, "n_eval": 256, "steps_per_epoch": 8} \
        if args.backend == "real" else {}
    if args.device is not None:
        if args.backend == "sim":
            raise ValueError("--device: the sim backend models its epochs "
                             "and touches no device")
        backend_kw["device"] = args.device
    tuner_kw = {"max_probes": 4} if args.system == "pipetune" else {}
    sched_kw = {"n_trials": 6} if args.scheduler == "random" else {}

    exp = (Experiment(job)
           .with_tuner(args.system, **tuner_kw)
           .with_backend(args.backend, **backend_kw)
           .with_scheduler(args.scheduler, **sched_kw))
    store = None
    if args.system == "pipetune" or args.store != "inproc" or \
            args.gt_store or args.store_reset:
        # only attach a store client when the tuner consumes one (or the
        # user asked for a specific store): a v1 job with remote workers
        # must not trip over a ground-truth client it would never use
        store = store_client_from_args(args)
        exp = exp.with_groundtruth(store)
    try:
        executor = executor_from_args(args)
        try:
            res = exp.run(executor=executor)
        finally:
            executor.close()
    finally:
        if store is not None:
            store.close()

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
