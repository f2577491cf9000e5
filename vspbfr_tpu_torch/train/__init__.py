"""Trainers of the PyTorch port (counterpart of `vspbfr_tpu/train`):
stage 2 (code diffuser). Stage 3 (RestoreNet GAN training) waits."""

from vspbfr_tpu_torch.train.state import (
    EMA_DECAY_DEFAULT,
    TrainState,
    ema_update,
    make_adam,
)

__all__ = ["EMA_DECAY_DEFAULT", "TrainState", "ema_update", "make_adam"]
