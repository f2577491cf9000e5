"""ArcFace identity loss over a ResNet-101 embedder, NHWC.

Counterpart of `vspbfr_tpu/losses/id_loss.py` (`Loss/id_loss.py`
upstream): a torchvision-style resnet101 with a 256-dim head, frozen, in
inference form; both images are resized to 112 px, embedded and
L2-normalised; the loss is mean |1 - <z_fake, z_real>| with the real
embedding detached. Parameter names mirror the flax tree (flax
`layer3_5/conv2/kernel` is port `layer3.5.conv2.kernel`).

`compute_dtype` (bf16) runs the conv trunk in that dtype; the global pool
and the fc head stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vspbfr_tpu_torch.models.e4e import FrozenBatchNorm
from vspbfr_tpu_torch.models.layers import Conv, Dense
from vspbfr_tpu_torch.models.psp import resize_bilinear

# torchvision ResNet-101: (planes, bottlenecks) per stage
RESNET101_STAGES = ((64, 3), (128, 4), (256, 23), (512, 3))
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int, project: bool):
        super().__init__()
        out_ch = planes * EXPANSION
        if project:
            self.down_conv = Conv(in_ch, out_ch, 1, stride=stride,
                                  use_bias=False)
            self.down_bn = FrozenBatchNorm(out_ch)
        else:
            self.down_conv = None
        self.conv1 = Conv(in_ch, planes, 1, use_bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1,
                          use_bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, out_ch, 1, use_bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)

    def forward(self, x):
        identity = x if self.down_conv is None else self.down_bn(
            self.down_conv(x))
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + identity)


class ResNet101Embedder(nn.Module):
    """torchvision resnet101(num_classes=embed_dim), inference form."""

    def __init__(self, embed_dim: int = 256,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stem_conv = Conv(3, 64, 7, stride=2, padding=3, use_bias=False)
        self.stem_bn = FrozenBatchNorm(64)
        in_ch = 64
        for s, (planes, blocks) in enumerate(RESNET101_STAGES):
            units = []
            for b in range(blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                project = b == 0 and (stride != 1
                                      or in_ch != planes * EXPANSION)
                units.append(Bottleneck(in_ch, planes, stride, project))
                in_ch = planes * EXPANSION
            self.add_module(f"layer{s + 1}", nn.ModuleList(units))
        self.fc = Dense(in_ch, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        h = F.relu(self.stem_bn(self.stem_conv(x)))
        # -inf pad then an unpadded 3x3 / 2 max-pool (flax's form)
        h = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), value=float("-inf"))
        h = F.max_pool2d(h, 3, stride=2).permute(0, 2, 3, 1)
        for s in range(len(RESNET101_STAGES)):
            for unit in getattr(self, f"layer{s + 1}"):
                h = unit(h)
        # the head in f32 (a bf16 trunk's pooled features), or wider
        acc = torch.promote_types(h.dtype, torch.float32)
        return self.fc(torch.mean(h.to(acc), dim=(1, 2)))


def embed_l2(net: nn.Module, img: torch.Tensor) -> torch.Tensor:
    """Resize to 112 px, embed, unit-normalise."""
    z = net(resize_bilinear(img, (112, 112)))
    return z / torch.linalg.norm(z, dim=-1, keepdim=True)


def id_loss(net: nn.Module, fake: torch.Tensor,
            real: torch.Tensor) -> torch.Tensor:
    """mean |1 - <z_fake, z_real>| with the real embedding detached."""
    z_fake = embed_l2(net, fake)
    with torch.no_grad():
        z_real = embed_l2(net, real)
    return torch.mean(torch.abs(1.0 - torch.sum(z_fake * z_real, dim=-1)))
