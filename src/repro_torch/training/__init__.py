"""Training substrate of the port: so far checkpointing (the atomic-publish
format the streaming snapshots ride).  The optimizer and the train loop
wait for ROADMAP A15."""

from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint, save_checkpoint_async)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "save_checkpoint_async"]
