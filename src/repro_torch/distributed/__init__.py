"""The distributed layer of the port: sharding rules and DTensor placements
(``sharding``), elastic re-sharding (``elastic``), gradient compression
(``compression``) and compressed reductions over ``torch.distributed``
(``collectives``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    BATCH_AXES, batch_specs, cache_specs, param_specs, state_specs)
