"""Training substrate of the port: AdamW (``optimizer``), the microbatched
train step on one device (``train_loop``), and checkpointing (the
atomic-publish format the streaming snapshots ride too).  The mesh-sharded
step (sharded state, ``jit_train_step``, the int8 cross-pod gradient
compression) waits for the LM mesh, ROADMAP A15."""

from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint, save_checkpoint_async)
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .train_loop import TrainOptions, init_train_state, make_train_step

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "save_checkpoint_async", "AdamWConfig",
           "adamw_init", "adamw_update", "cosine_lr", "TrainOptions",
           "init_train_state", "make_train_step"]
