"""Checkpoints in the reference's npz + JSON-spec format
(``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (
    CheckpointManager,
    load_checkpoint,
    load_named,
    save_checkpoint,
    save_named,
    to_tensor,
)

__all__ = [
    "save_checkpoint", "load_checkpoint", "save_named", "load_named",
    "CheckpointManager", "to_tensor",
]
