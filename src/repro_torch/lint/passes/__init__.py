"""Built-in lint passes.

Importing this package registers every pass with the engine registry.
"""

from repro_torch.lint.passes import (  # noqa: F401
    capability,
    determinism,
    events,
    locks,
    serve,
    wire,
)
