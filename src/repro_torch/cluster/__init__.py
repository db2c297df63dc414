"""The simulated cluster of the port (a copy of ``repro.cluster``): the
discrete-event engine, the cluster trial executor, ``SimBackend`` and the
multi-tenant ``ClusterSim``. Modeled seconds of the paper's cluster; no
device is touched.
"""
from repro_torch.cluster.engine import (  # noqa: F401
    ClusterConfig, EventEngine, NodeSpec)
from repro_torch.cluster.executor import ClusterTrialExecutor  # noqa: F401
from repro_torch.cluster.sim import (  # noqa: F401
    ClusterSim, ElasticPolicy, SimBackend)
