"""Name-based registries for schedulers, backends, tuners and executors,
as in ``repro.api.registry``, holding what the port has:

    schedulers  grid, random, hyperband, asha, asha-async, pbt
    backends    kernel-tune
    tuners      v1 (tunev1)
    executors   serial

A name the reference registers and the port does not yet (``sim``,
``real``, ``v2``, ``pipetune``, ``parallel``, ...) raises a ``KeyError``
that lists the registered names and the ROADMAP item that brings it.
Third-party code extends the port by registering a factory.

Factory conventions
-------------------
scheduler factory(job: HPTJob, **kw) -> AskTellScheduler
backend   factory(**kw)              -> Backend
tuner     factory(backend, **kw)     -> TrialRunner
executor  factory(**kw)              -> object with run_wave
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.core.executor import SerialTrialExecutor
from repro_torch.core.job import HPTJob
from repro_torch.core.pipetune import TrialRunner, TuneV1
from repro_torch.core.schedulers import (ASHA, AskTellScheduler, AsyncASHA,
                                         GridSearch, HyperBand, PBT,
                                         RandomSearch)

__all__ = [
    "register_scheduler", "register_backend", "register_tuner",
    "register_executor",
    "make_scheduler", "make_backend", "make_tuner", "make_executor",
    "available_schedulers", "available_backends",
    "available_tuners", "available_executors",
]

_SCHEDULERS: Dict[str, Callable[..., AskTellScheduler]] = {}
_BACKENDS: Dict[str, Callable[..., Any]] = {}
_TUNERS: Dict[str, Callable[..., TrialRunner]] = {}
_EXECUTORS: Dict[str, Callable[..., Any]] = {}

# names the reference registers that the port does not have yet, and the
# ROADMAP item (queue A) that brings each
_LATER = {
    "backend": {"real": "2b (RealBackend)",
                "sim": "2b (SimBackend, the cluster simulation)",
                "numeric": "9 (Type-III numeric workloads)"},
    "tuner": {"v2": "2b (TuneV2)", "tunev2": "2b (TuneV2)",
              "pipetune": "2b (PipeTune)"},
    "executor": {"parallel": "2b (the parallel executor)",
                 "cluster": "2b (the cluster executor)",
                 "sharded": "2b (the sharded executor)",
                 "workers": "2b (the worker-pool executors)"},
}


def _lookup(table: Dict[str, Any], kind: str, name: str):
    try:
        return table[name]
    except KeyError:
        later = _LATER.get(kind, {}).get(name)
        note = (f"; the port does not have it yet: ROADMAP queue A, item "
                f"{later}" if later else "")
        raise KeyError(f"unknown {kind} {name!r}; available: "
                       f"{sorted(table)}{note}") from None


# -- registration ----------------------------------------------------------

def register_scheduler(name: str,
                       factory: Callable[..., AskTellScheduler]) -> None:
    _SCHEDULERS[name] = factory


def register_backend(name: str, factory: Callable[..., Any]) -> None:
    _BACKENDS[name] = factory


def register_tuner(name: str, factory: Callable[..., TrialRunner]) -> None:
    _TUNERS[name] = factory


def register_executor(name: str, factory: Callable[..., Any]) -> None:
    _EXECUTORS[name] = factory


# -- resolution ------------------------------------------------------------

def make_scheduler(name: str, job: HPTJob, **kw) -> AskTellScheduler:
    return _lookup(_SCHEDULERS, "scheduler", name)(job, **kw)


def make_backend(name: str, **kw):
    return _lookup(_BACKENDS, "backend", name)(**kw)


def make_tuner(name: str, backend, **kw) -> TrialRunner:
    return _lookup(_TUNERS, "tuner", name)(backend, **kw)


def make_executor(name: str, **kw):
    return _lookup(_EXECUTORS, "executor", name)(**kw)


def available_executors():
    return sorted(_EXECUTORS)


def available_schedulers():
    return sorted(_SCHEDULERS)


def available_backends():
    return sorted(_BACKENDS)


def available_tuners():
    return sorted(_TUNERS)


# -- built-ins -------------------------------------------------------------

register_scheduler("grid", lambda job, **kw: GridSearch(
    job.space, epochs=job.max_epochs, **kw))
register_scheduler("random", lambda job, **kw: RandomSearch(
    job.space, epochs=job.max_epochs, seed=job.seed, **kw))
register_scheduler("hyperband", lambda job, **kw: HyperBand(
    job.space, R=job.max_epochs, seed=job.seed, **kw))
register_scheduler("asha", lambda job, **kw: ASHA(
    job.space, max_epochs=job.max_epochs, seed=job.seed, **kw))
register_scheduler("asha-async", lambda job, **kw: AsyncASHA(
    job.space, max_epochs=job.max_epochs, seed=job.seed, **kw))
register_scheduler("pbt", lambda job, **kw: PBT(
    job.space, total_epochs=job.max_epochs, seed=job.seed, **kw))


def _make_kernel_tune_backend(**kw):
    # lazy: importing the registry loads no kernel module
    from repro_torch.kernels.tune import KernelTuneBackend
    return KernelTuneBackend(**kw)


# trials time kernel variants (see repro_torch.kernels.tune)
register_backend("kernel-tune", _make_kernel_tune_backend)
register_tuner("v1", TuneV1)
register_tuner("tunev1", TuneV1)

register_executor("serial", SerialTrialExecutor)
