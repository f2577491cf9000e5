"""Losses of the PyTorch port (counterpart of `vspbfr_tpu/losses`): the
stage-2 terms, stage 3's GAN losses, R1 and ADA, and the InceptionV3
features of standard FID."""

from vspbfr_tpu_torch.losses.ada import (
    ADAState,
    ada_update,
    augment,
    draw_augment,
)
from vspbfr_tpu_torch.losses.gan import (
    d_logistic_loss,
    g_nonsaturating_loss,
    r1_penalty,
)
from vspbfr_tpu_torch.losses.id_loss import ResNet101Embedder, embed_l2, id_loss
from vspbfr_tpu_torch.losses.inception import (
    InceptionV3Features,
    make_inception_feature_fn,
)
from vspbfr_tpu_torch.losses.kd import kd_loss
from vspbfr_tpu_torch.losses.lpips import LPIPS, VGG16Features

__all__ = ["ADAState", "InceptionV3Features", "LPIPS", "ResNet101Embedder",
           "VGG16Features", "ada_update", "augment", "d_logistic_loss",
           "draw_augment", "embed_l2", "g_nonsaturating_loss", "id_loss",
           "kd_loss", "make_inception_feature_fn", "r1_penalty"]
