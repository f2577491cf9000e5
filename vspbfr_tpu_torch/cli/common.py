"""Shared plumbing of the trainer CLIs (counterpart of
`vspbfr_tpu/cli/common.py`)."""

from __future__ import annotations

import warnings

import torch
from torch import nn

from vspbfr_tpu_torch.data import DataLoader, DeviceDegradeLoader
from vspbfr_tpu_torch.models.e4e import TINY_STAGES
from vspbfr_tpu_torch.utils import load_checkpoint


def tiny_pipeline_kwargs(tiny: bool) -> dict:
    """`RestorationPipeline` arguments of the CLIs' `--tiny` (test-size
    networks for runs on the CPU: one-unit IR-SE body, 64 px encode, conv
    towers / 8)."""
    return (dict(encode_size=64, encoder_stages=TINY_STAGES, channel_div=8)
            if tiny else {})


def add_packed_min_res(p) -> None:
    """The CLIs' `--packed_min_res` (the JAX CLIs' flag)."""
    p.add_argument(
        "--packed_min_res", type=int, default=0,
        help="space-to-depth layout threshold: the decoder's and "
             "RestoreNet's resolutions at or above it run packed; 0 (the "
             "default) for none, else a power of two above 4 and at most "
             "the larger of --size and --decoder_size. The JAX CLIs default "
             "to 512 (a TPU choice: it fills the 128-lane channel axis); on "
             "the H100 a packed stride-1 3x3 conv does 4x the multiply-adds "
             "of the unpacked one, so the port defaults to 0 (PERF.md has "
             "the measured cost of 512)")


def check_packed_min_res(p, args) -> None:
    """Refuse a `--packed_min_res` the models cannot take (parser error)."""
    v, top = args.packed_min_res, max(args.size, args.decoder_size)
    if v and not (4 < v <= top and v & (v - 1) == 0):
        p.error(f"--packed_min_res {v}: 0, or a power of two above 4 and at "
                f"most {top}")


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


def add_loader_flags(p) -> None:
    """The data-chain flags both trainer CLIs take."""
    p.add_argument("--loader", choices=("auto", "device", "host"),
                   default="auto",
                   help="'device' runs blur, resize and noise on the "
                        "training device (data/device_degrade.py), leaving "
                        "the host image loading and, with --jpeg host, the "
                        "small-size JPEG; 'host' runs the whole chain on "
                        "the CPU (the C++ engine for the default config, "
                        "else numpy; no OpenCV); 'auto' = device unless "
                        "--device cpu")
    p.add_argument("--jpeg", choices=("device", "host"), default="device",
                   help="with the device chain: 'device' simulates the "
                        "JPEG round-trip on the device (data/device_jpeg.py, "
                        "float, approximates libjpeg); 'host' runs libjpeg's "
                        "exact integer round-trip on the CPU "
                        "(data/host_jpeg.py) between the device stages")


def build_loader(args, ds, device: torch.device, dp):
    """The training loader `--loader` / `--jpeg` describe, on rank
    `dp.rank`'s shard: the host chain is the `DataLoader` over the dataset
    (batches (lq_1 .. lq_n, gt) of numpy arrays), the device chain a
    `DeviceDegradeLoader` (batches (lq, gt) on `device`). `train_batch`
    takes either's batch to the device."""
    shard = dict(seed=args.seed, shard_index=dp.rank,
                 shard_count=dp.world_size)
    if args.loader == "host" or (args.loader == "auto"
                                 and device.type == "cpu"):
        return DataLoader(ds, args.batch, **shard)
    return DeviceDegradeLoader(ds, args.batch, device=device, jpeg=args.jpeg,
                               **shard)


def train_batch(batch, device: torch.device) -> tuple:
    """(lq, gt) on `device` from a `build_loader` batch: lq_1 and the GT
    (the reference degrades twice and consumes the first,
    `restoration_train.py:160` upstream)."""
    return tuple(torch.as_tensor(x).to(device) for x in (batch[0], batch[-1]))
