"""Quickstart on the PyTorch port: tune a LeNet-style job with PipeTune.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The job of ``examples/quickstart.py`` on ``repro_torch``: lenet-mnist,
PipeTune (3 probes) over random search (4 trials, 4 epochs), the ``real``
backend at 768 training and 192 eval samples and 6 steps an epoch, remat
none/block x microbatches 1/2 in fp32. Everything goes through the
``Experiment`` facade: tuners ("pipetune", "v1", "v2"), backends ("real",
"sim", "numeric") and schedulers ("hyperband", "random", "grid", "asha",
"pbt") resolve by name through ``repro_torch.api``'s registries. Trials
train on the card; without a GPU the script raises unless ``--device cpu``
is given.
"""
import argparse

from repro_torch.api import Experiment
from repro_torch.core import HPTJob, SearchSpace, SystemSpace
from repro_torch.core.job import Param


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    space = SearchSpace([
        Param("batch_size", "choice", choices=(32, 64)),
        Param("learning_rate", "log", 0.005, 0.05),
        Param("dropout", "float", 0.0, 0.3),
    ])
    job = HPTJob(workload="lenet-mnist", space=space, max_epochs=4)
    res = (Experiment(job)
           .with_tuner("pipetune", max_probes=3)
           .with_backend("real", n_train=768, n_eval=192, steps_per_epoch=6,
                         device=args.device)
           .with_sys_space(SystemSpace(remat=("none", "block"),
                                       microbatches=(1, 2),
                                       precision=("fp32",)))
           .with_scheduler("random", n_trials=4)
           .run())
    print(f"best hyperparameters: {res.best_hparams}")
    print(f"best accuracy:        {res.best_accuracy:.3f}")
    print(f"tuning time:          {res.tuning_time_s:.1f}s "
          f"(ground-truth hits: {res.gt_hits})")
    best = res.best_record
    print(f"system configs used by the best trial: {best.sys_history[-1]}")
    return res


if __name__ == "__main__":
    main()
