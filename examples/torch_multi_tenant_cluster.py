"""Multi-tenant cluster demo on the port: PipeTune vs Tune V1/V2 under
load, faults and elastic allocation (the counterpart of
``examples/multi_tenant_cluster.py``).

    PYTHONPATH=src python examples/torch_multi_tenant_cluster.py

12 HPT jobs arrive (Poisson, mean 600 s apart) at a simulated cluster of 4
nodes; each job runs its tuner for real over ``SimBackend``'s modeled
epochs, so every time printed is simulated seconds of the paper's cluster
and no device is touched. Energies are the port's power model (the H100's
constants). Runner factories come from ``Experiment.build_runner`` —
``ClusterSim`` builds a fresh runner per job, while PipeTune's shared
GroundTruth store carries its cross-job learning.
"""
import numpy as np

from repro_torch.api import Experiment
from repro_torch.cluster.sim import (ClusterConfig, ClusterSim,
                                     ElasticPolicy, make_arrivals)
from repro_torch.core import GroundTruth, SearchSpace
from repro_torch.core.job import HPTJob, Param


def main():
    space = SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        Param("learning_rate", "log", 0.001, 0.1),
        Param("dropout", "float", 0.0, 0.5),
    ])
    jobs = make_arrivals(
        ["lenet-mnist", "cnn-news20", "lenet-fashion", "lstm-news20"],
        n_jobs=12, mean_interarrival_s=600.0, space=space, max_epochs=9,
        seed=0)

    def report(label, factory, elastic=None, **cluster_kw):
        sim = ClusterSim(ClusterConfig(n_nodes=4, seed=0, **cluster_kw),
                         factory, elastic=elastic)
        out = sim.run(jobs, scheduler="hyperband")
        resp = np.mean([o.response_s for o in out])
        acc = np.mean([o.best_accuracy for o in out])
        energy = sum(o.energy_j for o in out) / 1e6
        extras = ""
        nf = sum(o.n_failures for o in out)
        ns = sum(o.n_stragglers for o in out)
        npre = sum(o.n_preemptions for o in out)
        if nf or ns:
            extras += f" failures={nf} stragglers={ns}"
        if npre:
            extras += f" reshards={npre}"
        print(f"{label:24s} mean_response={resp:8.1f}s mean_acc={acc:.3f} "
              f"energy={energy:.2f}MJ{extras}")
        return resp

    gt = GroundTruth()
    proto_job = HPTJob(workload="lenet-mnist", space=space)

    def factory(tuner):
        exp = Experiment(proto_job).with_tuner(tuner, **(
            {"max_probes": 6} if tuner == "pipetune" else {}))
        exp.with_backend("sim").with_groundtruth(gt)
        return exp.build_runner

    r1 = report("TuneV1", factory("v1"))
    report("TuneV2", factory("v2"))
    rp = report("PipeTune", factory("pipetune"))
    print(f"\nPipeTune response-time reduction vs TuneV1: "
          f"{100 * (1 - rp / r1):.1f}% (paper: up to 30%)")

    print("\n--- with node failures (MTBF 20000s) + 5% stragglers ---")
    report("PipeTune+faults", factory("pipetune"),
           mtbf_s=20000.0, straggler_prob=0.05)
    report("PipeTune+faults+nomit", factory("pipetune"),
           mtbf_s=20000.0, straggler_prob=0.05, mitigate_stragglers=False)

    print("\n--- elastic allocation (split nodes under queue pressure) ---")
    policy = ElasticPolicy(split_queue=2)
    report("PipeTune+elastic", factory("pipetune"), elastic=policy)
    print(f"elastic policy: {policy.n_splits} splits, {policy.n_merges} "
          "merges")


if __name__ == "__main__":
    main()
