"""Name-based registries for schedulers, backends, tuners and executors,
as in ``repro.api.registry``, holding what the port has:

    schedulers  grid, random, hyperband, asha, asha-async, pbt
    backends    real (TorchRealBackend), kernel-tune
    tuners      v1 (tunev1), v2 (tunev2), pipetune
    executors   serial

A name the reference registers and the port does not yet (``sim``,
``numeric``, ``parallel``, ...) raises a ``KeyError`` that lists the
registered names and the ROADMAP item that brings it. Third-party code
extends the port by registering a factory:

    from repro_torch.api import register_backend
    register_backend("my-cluster", MyBackend, sys_space=my_system_space)

Factory conventions
-------------------
scheduler factory(job: HPTJob, **kw) -> AskTellScheduler
backend   factory(**kw)              -> Backend
          sys_space(**kw)            -> SystemSpace, called with the
                                        backend's keyword arguments (the
                                        "real" space depends on its device)
tuner     factory(backend, sys_space=None, groundtruth=None, **kw)
                                     -> TrialRunner
executor  factory(**kw)              -> object with run_wave
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from repro_torch import device as device_lib
from repro_torch.core.backends import TorchRealBackend
from repro_torch.core.executor import SerialTrialExecutor
from repro_torch.core.job import HPTJob, SystemSpace
from repro_torch.core.pipetune import PipeTune, TrialRunner, TuneV1, TuneV2
from repro_torch.core.schedulers import (ASHA, AskTellScheduler, AsyncASHA,
                                         GridSearch, HyperBand, PBT,
                                         RandomSearch)

__all__ = [
    "register_scheduler", "register_backend", "register_tuner",
    "register_executor",
    "make_scheduler", "make_backend", "make_tuner", "make_executor",
    "default_sys_space", "available_schedulers", "available_backends",
    "available_tuners", "available_executors",
]

_SCHEDULERS: Dict[str, Callable[..., AskTellScheduler]] = {}
_BACKENDS: Dict[str, Dict[str, Any]] = {}
_TUNERS: Dict[str, Callable[..., TrialRunner]] = {}
_EXECUTORS: Dict[str, Callable[..., Any]] = {}

# names the reference registers that the port does not have yet, and the
# ROADMAP item (queue A) that brings each
_LATER = {
    "backend": {"sim": "2b (iii) (SimBackend, the cluster simulation)",
                "numeric": "9 (Type-III numeric workloads)"},
    "executor": {"parallel": "2b (iii) (the parallel executor)",
                 "cluster": "2b (iii) (the cluster executor)",
                 "sharded": "2b (iii) (the sharded executor)",
                 "workers": "2b (iii) (the worker-pool executors)"},
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


def register_backend(name: str, factory: Callable[..., Any],
                     sys_space: Optional[Callable[..., SystemSpace]] = None
                     ) -> None:
    """`sys_space` builds the system-parameter space this backend's knobs
    live in, from the backend's keyword arguments; tuners that probe system
    configs (PipeTune, TuneV2) use it when the caller doesn't supply one."""
    _BACKENDS[name] = {"factory": factory, "sys_space": sys_space}


def register_tuner(name: str, factory: Callable[..., TrialRunner]) -> None:
    _TUNERS[name] = factory


def register_executor(name: str, factory: Callable[..., Any]) -> None:
    _EXECUTORS[name] = factory


# -- resolution ------------------------------------------------------------

def make_scheduler(name: str, job: HPTJob, **kw) -> AskTellScheduler:
    return _lookup(_SCHEDULERS, "scheduler", name)(job, **kw)


def make_backend(name: str, **kw):
    return _lookup(_BACKENDS, "backend", name)["factory"](**kw)


def default_sys_space(name: str, **backend_kw) -> Optional[SystemSpace]:
    """The registered system space of backend `name`, for a backend built
    with `backend_kw` (None if it registered none)."""
    maker = _lookup(_BACKENDS, "backend", name)["sys_space"]
    return maker(**backend_kw) if maker is not None else None


def make_tuner(name: str, backend, sys_space=None, groundtruth=None,
               **kw) -> TrialRunner:
    return _lookup(_TUNERS, "tuner", name)(
        backend, sys_space=sys_space, groundtruth=groundtruth, **kw)


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


def _real_sys_space(device=None, **_):
    """remat none/block x microbatches 1/2/4 x precision: fp32 only on the
    CPU, as the reference registers it (there bf16 is emulated in software,
    a host artifact the tuner should not learn), fp32 and bf16 on a card."""
    on_card = device_lib.resolve(device).type == "cuda"
    return SystemSpace(remat=("none", "block"), microbatches=(1, 2, 4),
                       precision=("fp32", "bf16") if on_card else ("fp32",))


register_backend("real", TorchRealBackend, sys_space=_real_sys_space)
# trials time kernel variants (see repro_torch.kernels.tune)
register_backend("kernel-tune", _make_kernel_tune_backend)


def _make_v1(backend, sys_space=None, groundtruth=None, **kw):
    return TuneV1(backend, **kw)


def _make_v2(backend, sys_space=None, groundtruth=None, **kw):
    if sys_space is None:
        raise ValueError("tuner 'v2' needs a sys_space (use a registered "
                         "backend with a default, or .with_sys_space())")
    return TuneV2(backend, sys_space, **kw)


def _make_pipetune(backend, sys_space=None, groundtruth=None, **kw):
    if sys_space is None:
        raise ValueError("tuner 'pipetune' needs a sys_space (use a "
                         "registered backend with a default, or "
                         ".with_sys_space())")
    return PipeTune(backend, sys_space, groundtruth=groundtruth, **kw)


register_tuner("v1", _make_v1)
register_tuner("tunev1", _make_v1)
register_tuner("v2", _make_v2)
register_tuner("tunev2", _make_v2)
register_tuner("pipetune", _make_pipetune)

register_executor("serial", SerialTrialExecutor)
