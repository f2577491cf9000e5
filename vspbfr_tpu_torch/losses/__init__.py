"""Losses of the PyTorch port (counterpart of `vspbfr_tpu/losses`): the
stage-2 terms. The GAN losses, R1, ADA and the inception features wait for
stage 3."""

from vspbfr_tpu_torch.losses.id_loss import ResNet101Embedder, embed_l2, id_loss
from vspbfr_tpu_torch.losses.kd import kd_loss
from vspbfr_tpu_torch.losses.lpips import LPIPS, VGG16Features

__all__ = ["LPIPS", "ResNet101Embedder", "VGG16Features", "embed_l2",
           "id_loss", "kd_loss"]
