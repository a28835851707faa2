"""Training substrate of the port: AdamW (``optimizer``), the microbatched
train step on one device or sharded on an LM mesh (``train_loop``: the
sharded state, ``jit_train_step``, the int8 cross-pod gradient
compression), and checkpointing (the atomic-publish format the streaming
snapshots ride too; a sharded state saves from one writer and restores
onto any mesh)."""

from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint, save_checkpoint_async)
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .train_loop import (TrainOptions, init_train_state,
                         init_train_state_sharded, jit_train_step,
                         make_train_step, state_shardings)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint", "save_checkpoint_async", "AdamWConfig",
           "adamw_init", "adamw_update", "cosine_lr", "TrainOptions",
           "init_train_state", "make_train_step",
           "init_train_state_sharded", "jit_train_step", "state_shardings"]
