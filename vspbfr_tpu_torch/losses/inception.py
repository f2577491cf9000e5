"""InceptionV3 feature extractor for standard FID, NHWC.

Counterpart of `vspbfr_tpu/losses/inception.py`: torchvision's
inception_v3 trunk up to the 2048-d global-average-pooled Mixed_7c output
(pool3, the FID feature) at 299 x 299. Module names mirror the flax tree
(`Mixed_6b/branch7x7_2/conv/kernel`, `.../bn/scale`), so
`convert.state_dict_from_jax` carries a flax parameter tree over. Convs are
`models.layers.Conv` (no bias) and the batch norms the frozen inference
form of `models/e4e.py` with eps 1e-3. No weights ship with the repo: a
scorer loads a local state_dict.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from vspbfr_tpu_torch.models.e4e import FrozenBatchNorm
from vspbfr_tpu_torch.models.layers import Conv
from vspbfr_tpu_torch.models.psp import resize_bilinear

FID_SIZE = 299


def _rows(k: int) -> tuple:
    """The pads of a (k, 1) conv that keeps the size."""
    return ((k // 2, k // 2), (0, 0))


def _cols(k: int) -> tuple:
    """The pads of a (1, k) conv that keeps the size."""
    return ((0, 0), (k // 2, k // 2))


class BasicConv2d(nn.Module):
    """Conv (no bias) -> frozen BN (eps 1e-3) -> ReLU."""

    def __init__(self, in_ch: int, features: int, kernel=(3, 3),
                 stride: int = 1, padding=0):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride=stride,
                         padding=padding, use_bias=False)
        self.bn = FrozenBatchNorm(features, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _chain(*convs: BasicConv2d) -> nn.ModuleDict:
    """Convs applied in turn, keyed "1", "2", ...: flax's `branch5x5_2`
    is `branch5x5.2` in the port's state_dict (`convert.port_key`)."""
    return nn.ModuleDict({str(i + 1): c for i, c in enumerate(convs)})


def _run(chain: nn.ModuleDict, x):
    for conv in chain.values():
        x = conv(x)
    return x


def _nchw(fn, x, *args, **kw):
    return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def _avgpool3(x):
    """3x3 mean, stride 1, pad 1, the pad counted (flax `avg_pool`)."""
    return _nchw(F.avg_pool2d, x, 3, stride=1, padding=1,
                 count_include_pad=True)


def _maxpool3s2(x):
    return _nchw(F.max_pool2d, x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5 = _chain(BasicConv2d(in_ch, 48, (1, 1)),
                                BasicConv2d(48, 64, (5, 5), padding=2))
        self.branch3x3dbl = _chain(
            BasicConv2d(in_ch, 64, (1, 1)),
            BasicConv2d(64, 96, (3, 3), padding=1),
            BasicConv2d(96, 96, (3, 3), padding=1))
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x):
        return torch.cat([self.branch1x1(x), _run(self.branch5x5, x),
                          _run(self.branch3x3dbl, x),
                          self.branch_pool(_avgpool3(x))], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl = _chain(
            BasicConv2d(in_ch, 64, (1, 1)),
            BasicConv2d(64, 96, (3, 3), padding=1),
            BasicConv2d(96, 96, (3, 3), stride=2))

    def forward(self, x):
        return torch.cat([self.branch3x3(x), _run(self.branch3x3dbl, x),
                          _maxpool3s2(x)], dim=-1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7 = _chain(
            BasicConv2d(in_ch, c7, (1, 1)),
            BasicConv2d(c7, c7, (1, 7), padding=_cols(7)),
            BasicConv2d(c7, 192, (7, 1), padding=_rows(7)))
        self.branch7x7dbl = _chain(
            BasicConv2d(in_ch, c7, (1, 1)),
            BasicConv2d(c7, c7, (7, 1), padding=_rows(7)),
            BasicConv2d(c7, c7, (1, 7), padding=_cols(7)),
            BasicConv2d(c7, c7, (7, 1), padding=_rows(7)),
            BasicConv2d(c7, 192, (1, 7), padding=_cols(7)))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        return torch.cat([self.branch1x1(x), _run(self.branch7x7, x),
                          _run(self.branch7x7dbl, x),
                          self.branch_pool(_avgpool3(x))], dim=-1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = _chain(BasicConv2d(in_ch, 192, (1, 1)),
                                BasicConv2d(192, 320, (3, 3), stride=2))
        self.branch7x7x3 = _chain(
            BasicConv2d(in_ch, 192, (1, 1)),
            BasicConv2d(192, 192, (1, 7), padding=_cols(7)),
            BasicConv2d(192, 192, (7, 1), padding=_rows(7)),
            BasicConv2d(192, 192, (3, 3), stride=2))

    def forward(self, x):
        return torch.cat([_run(self.branch3x3, x), _run(self.branch7x7x3, x),
                          _maxpool3s2(x)], dim=-1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, (1, 1))
        self.branch3x3 = _chain(BasicConv2d(in_ch, 384, (1, 1)))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=_cols(3))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=_rows(3))
        self.branch3x3dbl = _chain(BasicConv2d(in_ch, 448, (1, 1)),
                                   BasicConv2d(448, 384, (3, 3), padding=1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=_cols(3))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=_rows(3))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b3 = _run(self.branch3x3, x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=-1)
        bd = _run(self.branch3x3dbl, x)
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=-1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avgpool3(x))], dim=-1)


class InceptionV3Features(nn.Module):
    """(B, 299, 299, 3) in [-1, 1] (torchvision's normalised form) -> the
    (B, 2048) pool3 feature."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        x = _maxpool3s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(1, 2))


def make_inception_feature_fn(net: InceptionV3Features
                              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """FID feature function over [-1, 1] NHWC images on net's device:
    bilinear resize to 299 (antialiased when shrinking, as the JAX
    package's `resize_bilinear`), then the pool3 feature, without a
    graph."""

    @torch.no_grad()
    def feature_fn(img: torch.Tensor) -> torch.Tensor:
        return net(resize_bilinear(img.float(), (FID_SIZE, FID_SIZE)))

    return feature_fn
