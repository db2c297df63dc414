"""HPT job definitions: hyperparameter + system-parameter search spaces."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    kind: str                       # float | int | log | choice
    low: float = 0.0
    high: float = 1.0
    choices: Optional[tuple] = None

    def sample(self, rng: np.random.RandomState):
        if self.kind == "choice":
            return self.choices[rng.randint(len(self.choices))]
        if self.kind == "int":
            return int(rng.randint(int(self.low), int(self.high) + 1))
        if self.kind == "log":
            return float(np.exp(rng.uniform(np.log(self.low),
                                            np.log(self.high))))
        return float(rng.uniform(self.low, self.high))

    def grid(self, n: int) -> List[Any]:
        if self.kind == "choice":
            return list(self.choices)
        if self.kind == "int":
            return sorted({int(round(v)) for v in
                           np.linspace(self.low, self.high, n)})
        if self.kind == "log":
            return [float(v) for v in
                    np.exp(np.linspace(np.log(self.low), np.log(self.high), n))]
        return [float(v) for v in np.linspace(self.low, self.high, n)]


class SearchSpace:
    def __init__(self, params: Sequence[Param]):
        self.params = list(params)

    def sample(self, rng) -> Dict[str, Any]:
        return {p.name: p.sample(rng) for p in self.params}

    def grid(self, per_dim: int = 3) -> List[Dict[str, Any]]:
        axes = [p.grid(per_dim) for p in self.params]
        return [dict(zip([p.name for p in self.params], combo))
                for combo in itertools.product(*axes)]


def paper_hparam_space() -> SearchSpace:
    """The 5 hyperparameters of paper §7.1.3 with their published ranges."""
    return SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 128, 256, 512, 1024)),
        Param("dropout", "float", 0.0, 0.5),
        Param("embed_dim", "choice", choices=(50, 100, 200, 300)),
        Param("learning_rate", "log", 0.001, 0.1),
        Param("epochs", "int", 10, 100),
    ])


@dataclasses.dataclass
class SystemSpace:
    """System-parameter grid (paper §7.1.4, TPU edition — DESIGN.md §2).

    The paper used {cores in [4..16], memory in [4..32GB]} -> 12 combos; ours
    is the same cardinality class: O(n) probing, one config per epoch.
    """
    remat: tuple = ("none", "dots", "block")
    microbatches: tuple = (1, 2, 4, 8)
    precision: tuple = ("bf16", "fp32")
    donate: tuple = (True,)

    def configs(self) -> List[Dict[str, Any]]:
        out = []
        for r in self.remat:
            for m in self.microbatches:
                for p in self.precision:
                    out.append({"remat": r, "microbatches": m, "precision": p})
        return out


@dataclasses.dataclass
class HPTJob:
    """One hyperparameter-tuning job (paper §5.1).

    Type-I: same model, different datasets; Type-II: same dataset, different
    models; Type-III: short-epoch numeric kernels.
    """
    workload: str                    # arch/config id, e.g. "lenet-mnist"
    space: SearchSpace
    objective: str = "accuracy"      # accuracy | accuracy_per_time
    max_epochs: int = 9
    arrival_time: float = 0.0        # for multi-tenancy simulation
    job_id: str = ""
    seed: int = 0

    @property
    def jtype(self) -> str:
        if self.workload.startswith("lenet"):
            return "I"
        if self.workload.endswith("news20"):
            return "II"
        return "III"
