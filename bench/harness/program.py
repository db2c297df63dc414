"""The system under test: the only module of the benchmark that imports
``repro_torch``. It maps a configuration file onto the program's
``ModelConfig``, and builds the program's train step, optimizer and
system config. Nothing of the program's own weights or data is used: the
benchmark makes them (``weights``)."""
from __future__ import annotations

from repro_torch.launch import steps
from repro_torch.models.transformer import ModelConfig, SystemConfig
from repro_torch.optim import optimizers

B1 = 0.9        # adamw's betas, the program's defaults, which the
B2 = 0.95       # reference mirrors


def model_config(cfg: dict) -> ModelConfig:
    """The program's ``ModelConfig`` of a configuration file."""
    return ModelConfig(
        name=cfg["name"], family=cfg["family"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg.get("head_dim"), rope_theta=cfg["rope_theta"],
        window=cfg.get("sliding_window"),
        tie_embeddings=cfg.get("tie_word_embeddings", False))


def system_config(remat: str, microbatches: int, precision: str
                  ) -> SystemConfig:
    return SystemConfig(remat=remat, microbatches=int(microbatches),
                        precision=precision)


def optimizer(lr: float, warmup: int, total: int, weight_decay: float,
              wrap=None):
    """The program's adamw over ``warmup_cosine``; ``wrap(update)``, where
    given, wraps its update call (a trace range around the optimizer)."""
    opt = optimizers.adamw(optimizers.warmup_cosine(lr, warmup, total),
                           weight_decay=weight_decay)
    return opt if wrap is None else optimizers.Optimizer(opt.init,
                                                         wrap(opt.update))


def train_step(mcfg: ModelConfig, sys: SystemConfig, opt):
    return steps.make_train_step(mcfg, sys, opt)


def train_state(params, opt):
    """The program's train state around the benchmark's parameters."""
    return {"params": params, "opt": opt.init(params), "step": 0}


def first_moment(state):
    """The program's adamw first moment, a tree like the parameters."""
    return state["opt"]["m"]


def load_kernels() -> None:
    """Build (on a checkout's first run) and load B1-B3's library."""
    from repro_torch.kernels import build
    for name in ("flash_attention", "flash_attention_bwd"):
        build.load(name)


def launches() -> dict:
    """The kernel wrappers' launch counters."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    return {"B1": fa.launches, "B2": fab.launches_dq, "B3": fab.launches_dkv}


def leaf_shapes(mcfg: ModelConfig) -> dict:
    from repro_torch import weights as program_weights
    return program_weights.leaf_shapes(mcfg)


# -- the tuning loop: PipeTune over a backend of the benchmark's own ------

def tuning_api():
    """The program's tuning API, as a user's job script imports it."""
    from repro_torch.api import Experiment, register_backend
    from repro_torch.api.registry import make_scheduler
    from repro_torch.core import GroundTruth, SystemSpace
    from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                           TrialState)
    from repro_torch.core.job import HPTJob, Param, SearchSpace
    from repro_torch.core.profiler import Profiler
    return dict(Experiment=Experiment, register_backend=register_backend,
                GroundTruth=GroundTruth, SystemSpace=SystemSpace,
                BackendCapabilities=BackendCapabilities,
                EpochResult=EpochResult, TrialState=TrialState,
                HPTJob=HPTJob, Param=Param, SearchSpace=SearchSpace,
                Profiler=Profiler, make_scheduler=make_scheduler)
