"""The reusable chaos scenario pack: the reference's
(``repro.obs.scenarios``), with its topologies and SLO budgets.

Each entry is a declarative ``ChaosScenario`` (topology + one fault + an
``SLOBudget``) runnable via ``run_scenario`` or from the CLI:

    python -m repro_torch.obs chaos sigkill_worker --trace /tmp/chaos.jsonl

``sigkill_worker`` is the CI smoke scenario — the smallest topology that
still exercises the whole recovery path (transport-death *or* heartbeat
retirement, trial re-placement, deterministic results). Every case runs
through the one orchestrator, so each is re-run, traced and judged
alike.
"""
from __future__ import annotations

from repro_torch.obs.chaos import (ChaosScenario, KillWorkers,
                             PartitionCoordinator, PartitionStore,
                             PartitionWorker, SLOBudget, SlowWorker)

__all__ = ["SCENARIOS"]

_PACK = [
    ChaosScenario(
        name="sigkill_worker",
        description="SIGKILL one of two workers mid-run; its trials must "
                    "re-place and results stay bit-identical",
        fault=KillWorkers(victims=1),
        n_workers=2, ttl_s=2.0,
    ),
    ChaosScenario(
        name="sigkill_storm",
        description="SIGKILL two of three workers at once; the survivor "
                    "absorbs every orphaned trial",
        fault=KillWorkers(victims=2),
        n_workers=3, ttl_s=2.0,
    ),
    ChaosScenario(
        name="partition_worker",
        description="sever one worker's dispatch path mid-run (a proxy "
                    "refuses and closes its connections; the worker stays "
                    "alive and heartbeating, so the roster never prunes "
                    "it): the next run_many batch dies mid-batch and the "
                    "transport-death path must retire the worker and "
                    "re-place every member — no trial lost, none "
                    "double-run, results bit-identical",
        fault=PartitionWorker(mode="refuse"),
        # a TTL far longer than the run proves heartbeat pruning is not
        # what saved it — only transport-death retirement can, and the
        # tight retire budget (well under the TTL) pins that down
        n_workers=2, ttl_s=30.0,
        slo=SLOBudget(retire_within_s=10.0),
    ),
    ChaosScenario(
        name="partition_coordinator",
        description="refuse the coordinator for several seconds; the pool "
                    "keeps running on its roster, heartbeats provably miss, "
                    "and the run completes unchanged",
        fault=PartitionCoordinator(duration_s=5.0, mode="refuse"),
        n_workers=2, ttl_s=2.0,
        slo=SLOBudget(require_replacement=False, min_heartbeats_missed=1),
    ),
    ChaosScenario(
        name="partition_store",
        description="blackhole the shared ground-truth store for a second "
                    "mid-run; lookups ride it out and pipetune's results "
                    "do not change",
        fault=PartitionStore(duration_s=1.0, mode="blackhole"),
        n_workers=1, tuner="pipetune", with_store=True,
        slo=SLOBudget(require_replacement=False),
    ),
    ChaosScenario(
        name="slow_node",
        description="a 4x-degraded worker joins the pool; weighted "
                    "placement sheds load onto the fast nodes and results "
                    "do not change",
        fault=SlowWorker(speed_factor=0.25),
        n_workers=2,
        slo=SLOBudget(require_replacement=False, max_dispatch_share=0.34),
    ),
]

SCENARIOS = {s.name: s for s in _PACK}
