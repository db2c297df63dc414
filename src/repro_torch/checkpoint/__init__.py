"""Checkpoints in the reference's on-disk format (``manager``)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, load_pytree, save_pytree)
