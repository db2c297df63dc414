"""The serial trial executor of ``repro.core.executor``: run one scheduler
wave against a TrialRunner.

A wave (see ``repro_torch.core.schedulers.AskTellScheduler``) is a list of
independent ``TrialProposal``s. The executor returns ``[(proposal, score),
...]`` **in wave order**, so scheduler decisions (rung promotion, PBT
exploit, best tracking) never depend on scheduling noise.

The reference runs the serial executor as a pool of one in-process worker;
with one worker and one executor the port runs the wave directly. The
worker protocol and pool, and the parallel, cluster, sharded and elastic
executors, wait for the slice that ports a second executor (ROADMAP queue
A, 2b (iii)); on the card the kernel tuner times one variant at a time anyway, as
the reference serializes its timings under one lock.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.schedulers import TrialProposal

__all__ = ["SerialTrialExecutor"]


class SerialTrialExecutor:
    """Trials of a wave run one after another, in wave order, on the
    caller's thread."""

    def run_wave(self, runner, workload: str,
                 proposals: Sequence[TrialProposal]
                 ) -> List[Tuple[TrialProposal, float]]:
        # clone sources must be wave-boundary snapshots, so apply them for
        # the whole wave before any of it runs
        for p in proposals:
            if p.clone_from is not None:
                runner.clone_trial(p.trial_id, p.clone_from)
        out = []
        for p in proposals:
            rec = runner.run_trial(workload, p.trial_id, p.hparams, p.epochs)
            out.append((p, rec.score(runner.objective)))
        return out
