"""Checkpoints, logging and run-time helpers of the PyTorch port
(counterpart of `vspbfr_tpu/utils`)."""

from vspbfr_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vspbfr_tpu_torch.utils.logging import Logger
from vspbfr_tpu_torch.utils.runtime import GracefulShutdown

__all__ = ["GracefulShutdown", "Logger", "load_checkpoint", "save_checkpoint"]
