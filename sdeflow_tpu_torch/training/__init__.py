"""Training: the SSM train step, the optimizer and the Trainer."""

from sdeflow_tpu_torch.training.train import (
    Trainer, TrainState, build_optimizer, ema_rate_at, make_train_chunk,
    make_train_step, update_ema)

__all__ = ["TrainState", "Trainer", "build_optimizer", "ema_rate_at",
           "make_train_chunk", "make_train_step", "update_ema"]
