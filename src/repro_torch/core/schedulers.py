"""HPT trial schedulers: GridSearch, RandomSearch, HyperBand, ASHA, PBT.

Every scheduler speaks the ask/tell protocol (``AskTellScheduler``):

    suggest() -> list[TrialProposal]     # next wave of independent trials
    report(trial_id, score)              # feed one result back

A *wave* is a set of proposals with no data dependencies between them — the
executor may run them serially, threaded, or (later) across workers, as long
as every proposal is reported before the next ``suggest()``. This is what
exposes the paper's "high parallelism" of HPT jobs to the runtime: HyperBand
rungs, grid/random batches, and PBT generations are all waves.

``run(evaluate)`` is a thin compatibility shim that drives the protocol
serially in wave order — it reproduces the historical blocking behavior
(same RNG draws, same tie-breaking, same winner) so existing callers and
tests keep working. One deliberate divergence: PBT no longer performs the
exploit/explore bookkeeping after the *final* generation (see the PBT
docstring) — that pass could never influence the returned winner.

The trial *runner* (Tune V1/V2 or PipeTune) decides how each trial executes.
Survivor trials resume from their checkpointed state, so a rung promotion
costs only the additional epochs (paper's Tune/HyperBand semantics).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.job import SearchSpace

# evaluate(trial_id: str, hparams: dict, total_epochs: int) -> score: float
Evaluator = Callable[[str, Dict[str, Any], int], float]


@dataclasses.dataclass(frozen=True)
class TrialProposal:
    """One unit of schedulable work: train `trial_id` under `hparams` until
    it has seen `epochs` total epochs (runners resume, so a re-proposal of an
    existing trial costs only the delta). `clone_from` asks the executor to
    copy trial state from another trial *before any trial in the wave starts*
    (PBT exploit)."""
    trial_id: str
    hparams: Dict[str, Any]
    epochs: int
    clone_from: Optional[str] = None


class AskTellScheduler:
    """Protocol contract:

    * ``suggest()`` returns the next wave of proposals, ``[]`` once the
      search is exhausted (or while a wave is still outstanding).
    * Proposals within a wave are independent and never share a trial_id;
      they may execute in any order. Scores must be **reported in wave
      order** for bit-reproducible results (executors guarantee this).
    * Every proposal must be reported before the next ``suggest()``.
    """

    _best: Optional[Dict[str, Any]] = None
    _best_score: float = -math.inf

    def suggest(self) -> List[TrialProposal]:
        raise NotImplementedError

    def report(self, trial_id: str, score: float) -> None:
        raise NotImplementedError

    @property
    def done(self) -> bool:
        raise NotImplementedError

    def best(self) -> Tuple[Optional[Dict[str, Any]], float]:
        return self._best, self._best_score

    # -- legacy blocking API -------------------------------------------------
    def run(self, evaluate: Evaluator, clone=None
            ) -> Tuple[Optional[Dict[str, Any]], float]:
        """Serial shim over suggest/report. ``clone(dst_id, src_id)`` copies
        trial state for proposals carrying ``clone_from``; clones are applied
        for the whole wave up front (state snapshots predate any training in
        the wave, matching PBT's exploit-at-decision-time semantics)."""
        while True:
            wave = self.suggest()
            if not wave:
                break
            for p in wave:
                if p.clone_from is not None and clone is not None:
                    clone(p.trial_id, p.clone_from)
            for p in wave:
                self.report(p.trial_id,
                            evaluate(p.trial_id, p.hparams, p.epochs))
        return self.best()


class GridSearch(AskTellScheduler):
    def __init__(self, space: SearchSpace, per_dim: int = 3, epochs: int = 9):
        self.space, self.per_dim, self.epochs = space, per_dim, epochs
        self._proposed = False
        self._outstanding: Dict[str, Dict[str, Any]] = {}

    def suggest(self) -> List[TrialProposal]:
        if self._proposed:
            return []
        self._proposed = True
        wave = [TrialProposal(f"grid-{i}", hp, self.epochs)
                for i, hp in enumerate(self.space.grid(self.per_dim))]
        self._outstanding = {p.trial_id: p.hparams for p in wave}
        return wave

    def report(self, trial_id: str, score: float) -> None:
        hp = self._outstanding.pop(trial_id)
        if score > self._best_score:
            self._best, self._best_score = hp, score

    @property
    def done(self) -> bool:
        return self._proposed and not self._outstanding


class RandomSearch(AskTellScheduler):
    def __init__(self, space: SearchSpace, n_trials: int = 16, epochs: int = 9,
                 seed: int = 0):
        self.space, self.n, self.epochs = space, n_trials, epochs
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._proposed = False
        self._outstanding: Dict[str, Dict[str, Any]] = {}

    def suggest(self) -> List[TrialProposal]:
        if self._proposed:
            return []
        self._proposed = True
        wave = [TrialProposal(f"rand-{i}", self.space.sample(self._rng),
                              self.epochs) for i in range(self.n)]
        self._outstanding = {p.trial_id: p.hparams for p in wave}
        return wave

    def report(self, trial_id: str, score: float) -> None:
        hp = self._outstanding.pop(trial_id)
        if score > self._best_score:
            self._best, self._best_score = hp, score

    @property
    def done(self) -> bool:
        return self._proposed and not self._outstanding


class HyperBand(AskTellScheduler):
    """Li et al. (JMLR'17) — the paper's default scheduler (§6).

    R: max resource (epochs) per trial; eta: downsampling rate. Each rung of
    each bracket is one wave: its trials are independent and rung-parallel.
    """

    def __init__(self, space: SearchSpace, R: int = 9, eta: int = 3,
                 seed: int = 0):
        self.space, self.R, self.eta, self.seed = space, R, eta, seed
        self.s_max = int(math.floor(math.log(R, eta)))
        self.B = (self.s_max + 1) * R
        self._rng = np.random.RandomState(seed)
        self._bi = 0                 # bracket index into brackets()
        self._ri = 0                 # rung index within the bracket
        self._trials: List[Tuple[str, Dict[str, Any]]] = []
        self._wave: List[Tuple[str, Dict[str, Any]]] = []
        self._scores: Dict[str, float] = {}

    def brackets(self) -> List[dict]:
        out = []
        for s in range(self.s_max, -1, -1):
            n = int(math.ceil(self.B / self.R * (self.eta ** s) / (s + 1)))
            r = self.R * (self.eta ** (-s))
            out.append({"s": s, "n": n, "r": r})
        return out

    def suggest(self) -> List[TrialProposal]:
        if self._wave:
            return []
        brackets = self.brackets()
        if self._bi >= len(brackets):
            return []
        b = brackets[self._bi]
        if self._ri == 0 and not self._trials:
            self._trials = [(f"hb{b['s']}-{i}", self.space.sample(self._rng))
                            for i in range(b["n"])]
        n_i = int(math.floor(b["n"] * self.eta ** (-self._ri)))
        r_i = int(round(b["r"] * self.eta ** self._ri))
        self._wave = list(self._trials[:max(1, n_i)])
        self._scores = {}
        return [TrialProposal(tid, hp, max(1, r_i)) for tid, hp in self._wave]

    def report(self, trial_id: str, score: float) -> None:
        self._scores[trial_id] = score
        if len(self._scores) < len(self._wave):
            return
        # rung complete: promote the top 1/eta (stable sort = legacy ties)
        b = self.brackets()[self._bi]
        scores = [(self._scores[tid], tid, hp) for tid, hp in self._wave]
        scores.sort(key=lambda t: -t[0])
        if scores and scores[0][0] > self._best_score:
            self._best_score, _, self._best = scores[0]
        n_i = int(math.floor(b["n"] * self.eta ** (-self._ri)))
        keep = max(1, int(math.floor(n_i / self.eta)))
        kept_ids = {tid for _, tid, _ in scores[:keep]}
        self._trials = [(tid, hp) for tid, hp in self._trials
                        if tid in kept_ids]
        self._wave = []
        self._ri += 1
        if self._ri > b["s"]:
            self._bi += 1
            self._ri = 0
            self._trials = []

    @property
    def done(self) -> bool:
        return self._bi >= len(self.brackets()) and not self._wave


class PBT(AskTellScheduler):
    """Population-based training (Jaderberg et al., cited by the paper §1):
    a population trains in parallel; every `interval` epochs the bottom
    quantile exploits (copies) a top performer's state+hparams and explores
    (perturbs) them. Each generation is one wave; exploit clones ride on the
    next wave's proposals as ``clone_from`` (applied before the wave runs).
    Requires resumable trials — our TrialRunner gives that for free, and
    PipeTune's per-epoch system tuning composes under it.

    Divergence from the pre-ask/tell implementation: no exploit/explore
    runs after the final generation (there is no next wave to carry the
    clones). The legacy version did one more bookkeeping pass there, which
    inflated ``clone_events`` by one generation's worth and overwrote the
    bottom trials' records without ever re-evaluating — the returned winner
    was unaffected.
    """

    def __init__(self, space: SearchSpace, population: int = 8,
                 total_epochs: int = 9, interval: int = 3, quantile=0.25,
                 perturb=1.25, seed: int = 0):
        self.space, self.n, self.R = space, population, total_epochs
        self.interval, self.quantile, self.perturb = interval, quantile, perturb
        self.seed = seed
        self.clone_events = 0
        self._rng = np.random.RandomState(seed)
        self._pop: Optional[List[Tuple[str, Dict[str, Any]]]] = None
        self._scores: Dict[str, float] = {}
        self._epoch = 0                      # epoch target of current wave
        self._pending_clones: Dict[str, str] = {}
        self._wave_left: List[str] = []

    def _explore(self, hp, rng):
        out = dict(hp)
        for k, v in out.items():
            if isinstance(v, float):
                out[k] = v * (self.perturb if rng.rand() < 0.5
                              else 1.0 / self.perturb)
        return out

    def suggest(self) -> List[TrialProposal]:
        if self._wave_left:
            return []
        if self._epoch + self.interval > self.R:
            return []
        if self._pop is None:
            self._pop = [(f"pbt-{i}", self.space.sample(self._rng))
                         for i in range(self.n)]
        self._epoch += self.interval
        self._wave_left = [tid for tid, _ in self._pop]
        wave = [TrialProposal(tid, hp, self._epoch,
                              clone_from=self._pending_clones.get(tid))
                for tid, hp in self._pop]
        self._pending_clones = {}
        return wave

    def report(self, trial_id: str, score: float) -> None:
        self._scores[trial_id] = score
        self._wave_left.remove(trial_id)
        if self._wave_left:
            return
        if self._epoch + self.interval > self.R:
            return               # final generation: nothing left to exploit
        ranked = sorted(self._pop, key=lambda t: -self._scores[t[0]])
        k = max(1, int(self.n * self.quantile))
        tops, bottoms = ranked[:k], ranked[-k:]
        for i, (tid, hp) in enumerate(bottoms):
            src_tid, src_hp = tops[i % len(tops)]
            self._pending_clones[tid] = src_tid
            new_hp = self._explore(src_hp, self._rng)
            self._pop[self._pop.index((tid, hp))] = (tid, new_hp)
            self.clone_events += 1

    @property
    def done(self) -> bool:
        return (self._pop is not None and not self._wave_left
                and self._epoch + self.interval > self.R)

    def best(self) -> Tuple[Optional[Dict[str, Any]], float]:
        if not self._pop:
            return None, 0.0
        best_tid, best_hp = max(self._pop,
                                key=lambda t: self._scores.get(t[0], -1e9))
        return best_hp, self._scores.get(best_tid, 0.0)


class ASHA(AskTellScheduler):
    """Asynchronous successive halving — promotes greedily, tolerates
    stragglers (a trial stuck at a rung never blocks others). Proposals are
    issued one at a time: each decision depends on the rung state left by
    every earlier report, which is exactly the legacy sequential-greedy
    behavior."""

    def __init__(self, space: SearchSpace, max_epochs: int = 9, eta: int = 3,
                 n_trials: int = 27, seed: int = 0):
        self.space, self.R, self.eta, self.n = space, max_epochs, eta, n_trials
        self.seed = seed
        self.rungs: Dict[int, List[Tuple[float, str]]] = {}
        self._rng = np.random.RandomState(seed)
        self._levels = self._rung_levels()
        self._i = 0                     # next trial index to start
        self._li = 0                    # current trial's rung level
        self._cur: Optional[Tuple[str, Dict[str, Any]]] = None
        self._outstanding: Optional[str] = None

    def _rung_levels(self):
        levels, r = [], 1
        while r < self.R:
            levels.append(r)
            r *= self.eta
        return levels + [self.R]

    def suggest(self) -> List[TrialProposal]:
        if self._outstanding is not None:
            return []
        if self._cur is None:
            if self._i >= self.n:
                return []
            self._cur = (f"asha-{self._i}", self.space.sample(self._rng))
            self._li = 0
        tid, hp = self._cur
        self._outstanding = tid
        return [TrialProposal(tid, hp, self._levels[self._li])]

    def report(self, trial_id: str, score: float) -> None:
        self._outstanding = None
        tid, hp = self._cur
        rung = self.rungs.setdefault(self._li, [])
        rung.append((score, tid))
        rung.sort(key=lambda t: -t[0])
        k = max(1, len(rung) // self.eta)
        advance = (score, tid) in rung[:k]
        if advance and self._li < len(self._levels) - 1:
            self._li += 1
            return
        # trial finished (pruned or topped out): legacy compares its last
        # observed score against the incumbent
        if score > self._best_score:
            self._best, self._best_score = hp, score
        self._cur = None
        self._i += 1

    @property
    def done(self) -> bool:
        return (self._i >= self.n and self._cur is None
                and self._outstanding is None)


class AsyncASHA(AskTellScheduler):
    """Truly asynchronous successive halving (the ASHA of Li et al.,
    MLSys'20): all ``n_trials`` start at the bottom rung as one
    rung-parallel wave, and *every* report re-ranks that trial's rung —
    any trial now in the top ``1/eta`` of its rung is immediately proposed
    for promotion, without waiting for wave-mates. A straggling trial
    therefore never blocks a promotion, which is the property the
    sequential legacy ``ASHA`` (one outstanding proposal at a time) cannot
    express and a barrier scheduler (HyperBand) pays for in rung-synchronous
    waits.

    Under a barrier executor the promotions accumulate and ship as the next
    wave (rung-batched behavior, deterministic); under the event-driven
    cluster executor each promotion dispatches at the simulated moment its
    report arrives. Because promotion checks happen per-report as the rung
    grows, a trial promoted early may later fall out of its rung's top
    ``1/eta`` — asynchronous halving's documented aggressiveness, traded
    for never idling a worker.

    ``best()`` tracks the maximum reported score (on monotone-in-epochs
    surfaces that is a final-rung trial).
    """

    def __init__(self, space: SearchSpace, max_epochs: int = 9, eta: int = 3,
                 n_trials: int = 27, seed: int = 0):
        self.space, self.R, self.eta, self.n = space, max_epochs, eta, n_trials
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._levels = self._rung_levels()
        self.rungs: Dict[int, List[Tuple[float, str]]] = {}
        self._promoted: Dict[int, set] = {}
        self._hp: Dict[str, Dict[str, Any]] = {}
        self._level: Dict[str, int] = {}
        self._pending: List[TrialProposal] = []
        self._outstanding: set = set()
        self._started = False

    def _rung_levels(self):
        levels, r = [], 1
        while r < self.R:
            levels.append(r)
            r *= self.eta
        return levels + [self.R]

    def suggest(self) -> List[TrialProposal]:
        if not self._started:
            self._started = True
            wave = []
            for i in range(self.n):
                tid = f"asha-{i}"
                self._hp[tid] = self.space.sample(self._rng)
                self._level[tid] = 0
                wave.append(TrialProposal(tid, self._hp[tid], self._levels[0]))
            self._outstanding = {p.trial_id for p in wave}
            return wave
        wave, self._pending = self._pending, []
        self._outstanding |= {p.trial_id for p in wave}
        return wave

    def report(self, trial_id: str, score: float) -> None:
        self._outstanding.discard(trial_id)
        li = self._level[trial_id]
        rung = self.rungs.setdefault(li, [])
        rung.append((score, trial_id))
        if score > self._best_score:
            self._best, self._best_score = self._hp[trial_id], score
        if li >= len(self._levels) - 1:
            return                              # topped out
        promoted = self._promoted.setdefault(li, set())
        ranked = sorted(rung, key=lambda t: -t[0])
        k = len(rung) // self.eta               # top 1/eta are promotable
        for s, tid in ranked[:k]:
            if tid not in promoted:
                promoted.add(tid)
                self._level[tid] = li + 1
                self._pending.append(TrialProposal(
                    tid, self._hp[tid], self._levels[li + 1]))

    @property
    def done(self) -> bool:
        return (self._started and not self._outstanding
                and not self._pending)
