"""Shared plumbing of the trainer CLIs (counterpart of
`vspbfr_tpu/cli/common.py`)."""

from __future__ import annotations

import warnings

from torch import nn

from vspbfr_tpu_torch.models.e4e import TINY_STAGES
from vspbfr_tpu_torch.utils import load_checkpoint


def tiny_pipeline_kwargs(tiny: bool) -> dict:
    """`RestorationPipeline` arguments of the CLIs' `--tiny` (test-size
    networks for runs on the CPU: one-unit IR-SE body, 64 px encode, conv
    towers / 8)."""
    return (dict(encode_size=64, encoder_stages=TINY_STAGES, channel_div=8)
            if tiny else {})


def wire_loss_nets(lpips: nn.Module, id_net: nn.Module,
                   lpips_ckpt: str | None, arcface_ckpt: str | None,
                   percept_weight: float, id_weight: float) -> None:
    """Load converted loss-net weights into the nets, in place.

    The reference builds LPIPS from its vendored calibrated weights
    (`my_lpips/dist_model.py:61-73`) and the ID loss from `Arcface.pth`
    (`Loss/id_loss.py:13-15`). Training against randomly initialised loss
    nets optimises a meaningless metric, so an active weight without its
    checkpoint warns. The checkpoints are the nets' port state_dicts
    (`torch.save`; from a flax tree through
    `vspbfr_tpu_torch.convert.state_dict_from_jax`)."""
    if lpips_ckpt:
        lpips.load_state_dict(load_checkpoint(lpips_ckpt))
    elif percept_weight > 0:
        warnings.warn(
            "percept_loss_weight > 0 but no --lpips_ckpt: the LPIPS net is "
            "RANDOMLY initialized, so the perceptual loss is meaningless. "
            "Pass the converted VGG16 + lin weights with --lpips_ckpt.",
            stacklevel=2)
    if arcface_ckpt:
        id_net.load_state_dict(load_checkpoint(arcface_ckpt))
    elif id_weight > 0:
        warnings.warn(
            "id_loss_weight > 0 but no --arcface_ckpt: the ArcFace net is "
            "RANDOMLY initialized, so the ID loss is meaningless. Pass the "
            "converted Arcface.pth weights with --arcface_ckpt.",
            stacklevel=2)
