"""Trainers of the PyTorch port (counterpart of `vspbfr_tpu/train`):
stage 2 (`diffuser_train`, the code diffuser) and stage 3
(`restore_train`, RestoreNet GAN training without ADA)."""

from vspbfr_tpu_torch.train.state import (
    EMA_DECAY_DEFAULT,
    TrainState,
    ema_update,
    make_adam,
)

__all__ = ["EMA_DECAY_DEFAULT", "TrainState", "ema_update", "make_adam"]
