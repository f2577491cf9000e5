"""Losses of the PyTorch port (counterpart of `vspbfr_tpu/losses`): the
stage-2 terms, and stage 3's GAN losses and R1. ADA and the inception
features wait."""

from vspbfr_tpu_torch.losses.gan import (
    d_logistic_loss,
    g_nonsaturating_loss,
    r1_penalty,
)
from vspbfr_tpu_torch.losses.id_loss import ResNet101Embedder, embed_l2, id_loss
from vspbfr_tpu_torch.losses.kd import kd_loss
from vspbfr_tpu_torch.losses.lpips import LPIPS, VGG16Features

__all__ = ["LPIPS", "ResNet101Embedder", "VGG16Features",
           "d_logistic_loss", "embed_l2", "g_nonsaturating_loss", "id_loss",
           "kd_loss", "r1_penalty"]
