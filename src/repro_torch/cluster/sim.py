"""Discrete-event cluster simulation: multi-tenancy, faults, stragglers;
the counterpart of ``repro.cluster.sim``.

Reproduces the paper's §7.4 setting — a shared cluster receiving HPT jobs
with exponential inter-arrival times, FIFO dispatch — and adds the
fault-tolerance machinery required at 1000+ node scale:

  * node failures (exponential MTBF): the running job loses its current
    epoch, restores from the last epoch checkpoint, re-queues; PipeTune's
    ground-truth store makes the re-tuned system config a warm hit, so
    recovery skips probing (the paper's mechanism doubling as a
    fault-tolerance accelerant).
  * stragglers: an epoch is slowed k-x with probability p; mitigation
    launches a backup epoch when the epoch exceeds median + 3*MAD, capping
    the effective time (speculative re-execution).
  * elastic allocation (``ClusterSim(elastic=ElasticPolicy())``): when the
    queue is long, full nodes split into fractional ones — every job placed
    there runs on fewer chips (slower epochs, sublinear per Fig 3b) but more
    jobs run at once; a job caught on a splitting node re-shards at its next
    epoch boundary (restore + reconfig charge, the same machinery as
    system-param switching) and re-queues. When the queue drains, idle
    fractional nodes merge back into full ones.

Times are modeled seconds of the paper's cluster (``perfmodel``), not card
times, and no epoch touches a device. The modeled nodes' chips are H100
cards: ``SimBackend`` charges each epoch ``power_w(util, chips) *
duration`` through the port's ``core.energy``, whose constants are the
H100's (P_IDLE 71.87 W, P_DYN 628.13 W) where the reference's are a TPU's.
Durations, utilisations, accuracies and profiles are the reference's
exactly; energies are the port's power model at those durations and
utilisations.

The simulator runs each job's *tuner for real* (PipeTune / TuneV1 / TuneV2
over SimBackend's modeled epochs), so tuning-policy differences — probing
epochs, ground-truth hits, system configs chosen — translate directly into
service times and hence response times.

Two execution modes (``ClusterSim(mode=...)``):

* ``"event"`` (default) — jobs run on the shared ``EventEngine``: each
  job is a task whose tuner executes epoch-by-epoch on its node, with
  stragglers/failures/reconfig charges injected *as epochs execute*.
* ``"legacy"`` — the pre-engine behavior: run the tuner to completion on
  the host, then rewrite its epoch-duration trace with faults post hoc.
  Kept as a regression baseline; scores are identical between modes (faults
  only ever perturb time), only timing differs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster import perfmodel
from repro_torch.cluster.engine import (ClusterConfig, EventEngine,
                                        NodeSpec, charged_epoch_durations,
                                        reconfig_charge_s)
from repro_torch.core import energy as energy_lib
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       TrialState)
from repro_torch.core.job import HPTJob, SystemSpace
from repro_torch.core.profiler import EpochProfile, Profiler


# ---------------------------------------------------------------------------
# simulated backend (same interface as TorchRealBackend)
# ---------------------------------------------------------------------------

class SimSystemSpace(SystemSpace):
    """Paper §7.1.4 space: chips (cores analogue) x memory."""

    def __init__(self, chips=(4, 8, 16), memory_gb=(4, 8, 16, 32)):
        self.chips = chips
        self.memory_gb = memory_gb

    def configs(self) -> List[dict]:
        return [{"chips": c, "memory_gb": m}
                for c in self.chips for m in self.memory_gb]


# the paper's trials default to the full node (all cores / all memory);
# PipeTune's win is discovering when LESS parallelism is faster (Fig 3b)
SIM_SYS_DEFAULT = {"chips": 16, "memory_gb": 32}


class SimBackend:
    """Modeled epochs: duration from perfmodel, energy from the port's power
    model at perfmodel's utilisation, accuracy from the seeded response
    surface, profiles from the family-signature generator. No device."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.profiler = Profiler()

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(async_precompile=False, simulated=True,
                                   deterministic=True)

    def init_trial(self, workload: str, hparams: dict, seed: int = 0
                   ) -> TrialState:
        return TrialState(workload=workload, hparams=dict(hparams), cfg=None,
                          params=None, opt_state=None, step=0, epoch=0,
                          data=None, eval_batch={}, seed=seed)

    def run_epoch(self, ts: TrialState, sys_cfg: dict, collect_profile=True
                  ) -> Tuple[TrialState, EpochResult]:
        cfg = {**SIM_SYS_DEFAULT, **sys_cfg}
        bs = int(ts.hparams.get("batch_size", 64))
        dur = perfmodel.epoch_time_s(ts.workload, bs, cfg["chips"],
                                     cfg["memory_gb"])
        util = perfmodel.utilization(ts.workload, bs, cfg["chips"])
        acc = perfmodel.accuracy_at(ts.workload, ts.hparams, ts.epoch,
                                    self.seed)
        e = energy_lib.power_w(util, cfg["chips"]) * dur
        vec = perfmodel.profile_vector(ts.workload, bs, cfg["chips"],
                                       seed=ts.seed * 1000 + ts.epoch)
        # SimBackend vectors are already in log-ish space: raw mode returns
        # them verbatim instead of re-logging
        profile = EpochProfile.from_vector(vec)
        ts.epoch += 1
        ts.loss_last = 1.0 - acc
        return ts, EpochResult(
            duration_s=dur, energy_j=e, loss=1.0 - acc, accuracy=acc,
            profile=profile, sys_config=dict(cfg), step_times=[dur],
            compile_s=0.0)


# ---------------------------------------------------------------------------
# discrete-event cluster
# ---------------------------------------------------------------------------

# ClusterConfig lives in repro_torch.cluster.engine (the engine owns the
# fault model); re-exported here as in the reference.


@dataclasses.dataclass
class JobOutcome:
    job_id: str
    workload: str
    jtype: str
    arrival: float
    start: float
    finish: float
    service_s: float
    n_epochs: int
    n_failures: int
    n_stragglers: int
    best_accuracy: float
    energy_j: float
    n_preemptions: int = 0      # epoch-boundary reshard/migrations (elastic)

    @property
    def response_s(self) -> float:
        return self.finish - self.arrival


class ElasticPolicy:
    """Elastic node allocation on the event engine (the §7.4 "shrink to
    fewer chips when the queue is long" story, made real).

    Invoked by the engine after every arrival and completion:

    * **shrink under queue pressure** — while ``split_queue`` or more jobs
      wait, retire one full node and add ``split_factor`` nodes running at
      ``split_speed`` of it. Each job placed there gets a fraction of the
      chips — slower epochs — but ``split_factor`` jobs run concurrently.
      ``split_speed`` defaults above ``1/split_factor`` because chip scaling
      is sublinear for these workloads (perfmodel, Fig 3b): half the chips
      keeps well over half the throughput. A job already on the splitting
      node re-shards at its next epoch boundary (restore + reconfig charge)
      and re-queues — the reference's ``distributed/elastic.py`` machinery
      (ROADMAP item 11 in the port).
    * **grow when idle** — when the queue is empty, any split whose
      fractional nodes are all idle merges back into the original node
      (free: nothing is running, nothing re-shards).

    Deterministic: a pure function of engine state, so two runs with the
    same seed and arrivals reconfigure identically.
    """

    def __init__(self, split_queue: int = 2, split_factor: int = 2,
                 split_speed: float = 0.65, max_splits: Optional[int] = None):
        if split_queue < 1:
            raise ValueError("split_queue must be >= 1")
        if split_factor < 2:
            raise ValueError("split_factor must be >= 2")
        if not 0.0 < split_speed < 1.0:
            raise ValueError("split_speed must be in (0, 1)")
        self.split_queue = split_queue
        self.split_factor = split_factor
        self.split_speed = split_speed
        self.max_splits = max_splits
        self.n_splits = 0
        self.n_merges = 0
        self._groups: List[dict] = []       # live splits: {kids, spec}
        self._children: set = set()         # node ids created by splits

    def __call__(self, engine: EventEngine) -> None:
        while engine.n_waiting >= self.split_queue and self._split(engine):
            pass
        if engine.n_waiting == 0:
            self._merge(engine)

    # ------------------------------------------------------------ internals
    def _splittable(self, engine: EventEngine) -> Optional[int]:
        """Lowest-id full (non-child, non-retiring) node; idle ones first so
        a split never forces a re-shard it could avoid."""
        full = [i for i in engine.node_ids() if i not in self._children]
        idle = [i for i in full if engine.node_busy(i) == 0]
        return idle[0] if idle else (full[0] if full else None)

    def _split(self, engine: EventEngine) -> bool:
        if self.max_splits is not None and \
                len(self._groups) >= self.max_splits:
            return False
        node = self._splittable(engine)
        if node is None:
            return False
        spec = engine.node_spec(node)
        engine.retire_node(node)
        kids = [engine.add_node(NodeSpec(speed=spec.speed * self.split_speed,
                                         tag=spec.tag,
                                         capacity=spec.capacity))
                for _ in range(self.split_factor)]
        self._children.update(kids)
        self._groups.append({"kids": kids, "spec": spec})
        self.n_splits += 1
        return True

    def _merge(self, engine: EventEngine) -> None:
        for g in list(self._groups):
            if all(engine.node_active(k) and engine.node_busy(k) == 0
                   for k in g["kids"]):
                for k in g["kids"]:
                    engine.retire_node(k)
                engine.add_node(g["spec"])
                self._groups.remove(g)
                self.n_merges += 1


class ClusterSim:
    def __init__(self, cfg: ClusterConfig, runner_factory: Callable[[], Any],
                 mode: str = "event", elastic: Optional[ElasticPolicy] = None):
        """runner_factory builds a fresh TrialRunner per job (they may share
        a GroundTruth store — that's PipeTune's cross-job learning).
        ``mode`` selects the event engine (default) or the legacy
        post-hoc-fault path (see module docstring); ``elastic`` attaches an
        ``ElasticPolicy`` reconfiguring nodes as queue pressure changes
        (event mode only)."""
        if mode not in ("event", "legacy"):
            raise ValueError(f"mode must be 'event' or 'legacy', got {mode!r}")
        if elastic is not None and mode != "event":
            raise ValueError("elastic allocation needs the event engine "
                             "(mode='event')")
        self.cfg = cfg
        self.runner_factory = runner_factory
        self.mode = mode
        self.elastic = elastic
        self.rng = np.random.RandomState(cfg.seed)

    # -------------------------------------------------------------- service
    def _service_job(self, job: HPTJob, scheduler="hyperband", **kw):
        """Run the tuner; collect the per-epoch duration trace including
        reconfiguration charges (paper §4: V2 'requires the resources used by
        each trial to be manually controlled'; PipeTune compiles candidate
        configs asynchronously, hiding most of the switch cost)."""
        runner = self.runner_factory()
        result = runner.run_job(job, scheduler=scheduler, **kw)
        overlap = self.cfg.async_overlap if getattr(
            runner, "overlap_reconfig", False) else 0.0
        charge = self.cfg.reconfig_s * (1.0 - overlap)
        durations = []
        for rec in result.records.values():
            prev_sys = None
            for i, (e, scfg) in enumerate(zip(rec.epochs, rec.sys_history)):
                d = e.duration_s
                if i == 0:
                    # trial-level resource reallocation if not the default
                    nondefault = any(scfg.get(k) not in (None, v)
                                     for k, v in SIM_SYS_DEFAULT.items())
                    if nondefault:
                        d += charge
                elif scfg != prev_sys:          # epoch-boundary switch
                    d += charge
                prev_sys = scfg
                durations.append(d)
        return result, durations

    def _apply_faults(self, durations: List[float]) -> Tuple[float, int, int]:
        """Inject stragglers + failures into an epoch trace; returns
        (total service time, n_failures, n_stragglers)."""
        cfg = self.cfg
        med = float(np.median(durations)) if durations else 0.0
        mad = float(np.median(np.abs(np.asarray(durations) - med))) \
            if durations else 0.0
        total, nfail, nstrag = 0.0, 0, 0
        for d in durations:
            eff = d
            if cfg.straggler_prob and self.rng.rand() < cfg.straggler_prob:
                nstrag += 1
                slow = d * cfg.straggler_slowdown
                if cfg.mitigate_stragglers:
                    # speculative backup capped at median+3*MAD+overhead
                    eff = min(slow, max(d, med + 3 * mad)
                              + cfg.backup_overhead * d)
                else:
                    eff = slow
            if cfg.mtbf_s:
                # failure arrives within this epoch with p = 1-exp(-d/mtbf)
                if self.rng.rand() < 1.0 - math.exp(-eff / cfg.mtbf_s):
                    nfail += 1
                    # lose a uniform fraction of the epoch, restore, redo
                    eff += self.rng.rand() * eff + cfg.restore_s \
                        + cfg.requeue_s
            total += eff
        return total, nfail, nstrag

    # ------------------------------------------------------------------ run
    def run(self, jobs: List[HPTJob], scheduler="hyperband", **kw
            ) -> List[JobOutcome]:
        """FIFO dispatch onto n_nodes; jobs processed in arrival order."""
        if self.mode == "legacy":
            return self._run_legacy(jobs, scheduler, **kw)
        return self._run_event(jobs, scheduler, **kw)

    def _run_legacy(self, jobs, scheduler, **kw) -> List[JobOutcome]:
        free_at = [0.0] * self.cfg.n_nodes      # next-free time per node
        outcomes = []
        for job in sorted(jobs, key=lambda j: j.arrival_time):
            node = int(np.argmin(free_at))
            start = max(job.arrival_time, free_at[node])
            result, durations = self._service_job(job, scheduler, **kw)
            service, nfail, nstrag = self._apply_faults(durations)
            finish = start + service
            free_at[node] = finish
            outcomes.append(JobOutcome(
                job_id=job.job_id or job.workload, workload=job.workload,
                jtype=job.jtype, arrival=job.arrival_time, start=start,
                finish=finish, service_s=service, n_epochs=len(durations),
                n_failures=nfail, n_stragglers=nstrag,
                best_accuracy=result.best_accuracy, energy_j=result.energy_j))
        return outcomes

    # ----------------------------------------------------------- event mode
    def _run_event(self, jobs, scheduler, **kw) -> List[JobOutcome]:
        """Every job is an engine task: its tuner executes epoch-by-epoch on
        the node that picked it up, and the scheduler inside the job observes
        epochs that already carry straggler/failure/reconfig costs."""
        engine = EventEngine(self.cfg)
        engine.policy = self.elastic
        entries = []                            # (job, holder, stats)
        for job in sorted(jobs, key=lambda j: j.arrival_time):
            holder: Dict[str, float] = {}
            process = self._job_process(job, scheduler, holder, kw)
            stats = engine.submit(job.job_id or job.workload, process,
                                  at=job.arrival_time)
            entries.append((job, holder, stats))
        engine.run()
        return [JobOutcome(
            job_id=job.job_id or job.workload, workload=job.workload,
            jtype=job.jtype, arrival=job.arrival_time, start=stats.start_s,
            finish=stats.finish_s, service_s=stats.service_s,
            n_epochs=stats.n_epochs, n_failures=stats.n_failures,
            n_stragglers=stats.n_stragglers,
            n_preemptions=stats.n_preemptions,
            best_accuracy=holder.get("best_accuracy", 0.0),
            energy_j=holder.get("energy_j", 0.0))
            for job, holder, stats in entries]

    def _job_process(self, job: HPTJob, scheduler, holder: Dict[str, float],
                     sched_kw: dict):
        """Generator yielding one charged base duration per tuner epoch;
        the engine injects faults and advances the node clock around it."""
        runner = self.runner_factory()
        if isinstance(scheduler, str):
            from repro_torch.api.registry import make_scheduler
            sched = make_scheduler(scheduler, job, **sched_kw)
        else:
            sched = scheduler
        charge = reconfig_charge_s(self.cfg, runner)
        prev_sys: Dict[str, dict] = {}
        while True:
            wave = sched.suggest()
            if not wave:
                break
            for p in wave:          # wave-boundary clone sources
                if p.clone_from is not None:
                    runner.clone_trial(p.trial_id, p.clone_from)
            for p in wave:
                yield from charged_epoch_durations(
                    runner.trial_epochs(job.workload, p.trial_id, p.hparams,
                                        p.epochs),
                    p.trial_id, prev_sys, charge, SIM_SYS_DEFAULT)
                sched.report(p.trial_id,
                             runner.records[p.trial_id].score(
                                 runner.objective))
        records = runner.records.values()
        best = max(records, key=lambda r: r.score(runner.objective),
                   default=None)
        holder["best_accuracy"] = best.accuracy if best else 0.0
        holder["energy_j"] = float(sum(r.energy for r in records))


def make_arrivals(workloads: List[str], n_jobs: int,
                  mean_interarrival_s: float, space, max_epochs: int = 9, seed: int = 0,
                  unseen_frac: float = 0.2) -> List[HPTJob]:
    """Poisson arrivals, round-robin workloads within type (paper §7.4);
    `unseen_frac` of jobs get a perturbed seed (the paper's 20% unseen)."""
    rng = np.random.RandomState(seed)
    t = 0.0
    jobs = []
    for i in range(n_jobs):
        t += rng.exponential(mean_interarrival_s)
        wl = workloads[i % len(workloads)]
        unseen = rng.rand() < unseen_frac
        jobs.append(HPTJob(workload=wl, space=space, max_epochs=max_epochs,
                           arrival_time=t, job_id=f"job-{i}",
                           seed=seed + (1000 + i if unseen else 0)))
    return jobs
