"""The port's tuning core: PipeTune (Algorithm 1) and its baselines TuneV1
and TuneV2 (``pipetune``), the trial schedulers, the executors and the
worker pool (``executor``, ``worker``), the ground-truth and find-db
stores (``groundtruth``), probing, the epoch profiler, the energy model
and the backends (``TorchRealBackend`` trains the paper's Table-3
workloads, ``TorchNumericBackend`` the Type-III ones;
``repro_torch.cluster.sim.SimBackend`` models them) and the metrics store
(``store.MetricsStore``).

Public surface, as in ``repro.core``:
    PipeTune           — Algorithm 1 trial runner + HPT job driver
    TuneV1 / TuneV2    — the paper's baselines (§4)
    GroundTruth        — k-means similarity store over epoch profiles
    Profiler           — epoch-level profile vectors
    HyperBand/ASHA/... — trial schedulers
    SystemSpace        — the system-parameter search space
"""
from repro_torch.core.groundtruth import (  # noqa: F401
    CentroidModel, GroundTruth, GroundTruthError, KMeans)
from repro_torch.core.profiler import Profiler, PROFILE_EVENTS  # noqa: F401
from repro_torch.core.schedulers import (  # noqa: F401
    AskTellScheduler, GridSearch, RandomSearch, HyperBand, ASHA, PBT,
    TrialProposal)
from repro_torch.core.backends import (  # noqa: F401
    BackendCapabilities, backend_capabilities)
from repro_torch.core.numeric_backend import TorchNumericBackend  # noqa: F401
from repro_torch.core.pipetune import (  # noqa: F401
    JobResult, PipeTune, TrialRunner, TuneV1, TuneV2)
from repro_torch.core.job import HPTJob, SearchSpace, SystemSpace  # noqa: F401
