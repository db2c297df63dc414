"""Trial executors: run one scheduler wave against a TrialRunner; the
counterpart of ``repro.core.executor``.

A wave (see ``repro_torch.core.schedulers.AskTellScheduler``) is a list of
independent ``TrialProposal``s. Executors return ``[(proposal, score),
...]`` **in wave order** regardless of completion order, so scheduler
decisions (rung promotion, PBT exploit, best tracking) never depend on
scheduling noise.

As in the reference, the executors are thin placement policies over a
``repro_torch.core.worker.WorkerPool``: serial is a pool of one
``InprocWorker``, parallel a pool of one ``ThreadWorker`` with N lanes. The
pool owns the drive loop; see ``repro_torch.core.worker`` for the protocol
and ``repro_torch.cluster`` for the simulated-cluster executor; the sharded
executor and remote workers live in ``repro_torch.service``.

Reproducibility: on a backend whose capabilities declare ``deterministic``
(``SimBackend``) and a runner without cross-trial shared state
(TuneV1/TuneV2), ``parallelism=N`` gives the serial results exactly.
PipeTune couples concurrent trials through its shared GroundTruth store —
the lookup a trial sees depends on which wave-mates finished first — so its
ground-truth hit/miss counts and locked system configs (hence tuning time)
can vary across parallel runs. ``TorchRealBackend`` is not deterministic in
time (step times are measured), but its losses and accuracies are pure
functions of the trial: each lane trains on its own CUDA stream from
explicitly seeded weights, batches and dropout masks.

Clone requests (``proposal.clone_from``, the PBT exploit) are applied
serially *before* any trial in the wave starts: the cloned state must be
the source's snapshot at the wave boundary, not mid-training.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.schedulers import TrialProposal
from repro_torch.core.worker import InprocWorker, ThreadWorker, WorkerPool

__all__ = ["SerialTrialExecutor", "ParallelTrialExecutor", "make_executor"]


class SerialTrialExecutor:
    """Default executor: trials of a wave run one after another in order
    (a pool of one synchronous in-process worker)."""

    parallelism = 1

    def __init__(self):
        self.pool = WorkerPool([InprocWorker()])

    def run_wave(self, runner, workload: str,
                 proposals: Sequence[TrialProposal]
                 ) -> List[Tuple[TrialProposal, float]]:
        return self.pool.run_wave(runner, workload, proposals)

    def close(self) -> None:
        self.pool.close()


class ParallelTrialExecutor:
    """Thread-lane executor over a wave's independent proposals.

    Threads (not processes) because runner and backend state (step cache,
    ground-truth store) is shared; runner bookkeeping is serialized by the
    runner's own hook lock. On the card each lane trains on its own CUDA
    stream. Results are merged back in proposal order — deterministic
    regardless of which trial finishes first.
    """

    def __init__(self, parallelism: int = 4):
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        self.parallelism = parallelism
        self.pool = WorkerPool([ThreadWorker(capacity=parallelism)])

    def run_wave(self, runner, workload: str,
                 proposals: Sequence[TrialProposal]
                 ) -> List[Tuple[TrialProposal, float]]:
        return self.pool.run_wave(runner, workload, proposals)

    def close(self) -> None:
        self.pool.close()


def make_executor(parallelism: int = 1):
    """Serial executor for parallelism<=1, thread lanes otherwise."""
    if parallelism <= 1:
        return SerialTrialExecutor()
    return ParallelTrialExecutor(parallelism)
