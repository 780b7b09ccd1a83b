"""Training: the SSM train step, the optimizer, the Trainer and its
checkpoints."""

from sdeflow_tpu_torch.training.checkpoint import (
    checkpoint_exists, delete_checkpoint, load_checkpoint, save_checkpoint)
from sdeflow_tpu_torch.training.train import (
    Trainer, TrainState, build_optimizer, ema_rate_at, make_train_chunk,
    make_train_step, update_ema)

__all__ = ["TrainState", "Trainer", "build_optimizer", "checkpoint_exists",
           "delete_checkpoint", "ema_rate_at", "load_checkpoint",
           "make_train_chunk", "make_train_step", "save_checkpoint",
           "update_ema"]
