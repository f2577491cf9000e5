"""e4e style encoder over an IR-SE body, NHWC.

Counterpart of `vspbfr_tpu/models/e4e.py` (`Encoder4Editing`; the pSp
`GradualStyleEncoder` variant is not on the serving path). Maps a face at
`encode_size` to a (B, style_count, 512) W+ code: IR-SE body with taps at
the end of stages 2/3/4, GradualStyleBlock heads, and an FPN whose adds use
bilinear align_corners=True resizes. The encoder is frozen, so BatchNorm
runs in inference form with its statistics as parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vspbfr_tpu_torch.models.layers import Conv, EqualLinear

# (depth, num_units) per stage for IR-50 (`helpers.py:30-38`)
IR50_STAGES = ((64, 3), (128, 4), (256, 14), (512, 3))
# one unit per stage, for small test configs
TINY_STAGES = ((16, 1), (32, 1), (64, 1), (128, 1))


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True, as two small matmuls."""
    b, h, w, c = x.shape
    oh, ow = out_hw

    def interp_matrix(n_out, n_in):
        if n_out == 1 or n_in == 1:
            return np.full((n_out, n_in), 1.0 / n_in, np.float32)
        pos = np.arange(n_out, dtype=np.float32) * (n_in - 1) / (n_out - 1)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
        frac = pos - lo
        m = np.zeros((n_out, n_in), np.float32)
        m[np.arange(n_out), lo] = 1.0 - frac
        m[np.arange(n_out), lo + 1] += frac
        return m

    mh = torch.as_tensor(interp_matrix(oh, h), device=x.device)
    mw = torch.as_tensor(interp_matrix(ow, w), device=x.device)
    out = torch.einsum("oh,bhwc->bowc", mh, x.float())
    out = torch.einsum("ow,bhwc->bhoc", mw, out)
    return out.to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(features))

    def init_from(self, gen):
        self.alpha.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm with its statistics as parameters; neutral
    at init."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name in ("scale", "bias", "mean", "var"):
            setattr(self, name, nn.Parameter(torch.empty(features)))

    def init_from(self, gen):
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x):
        inv = self.scale / torch.sqrt(self.var + self.eps)
        return x * inv.to(x.dtype) + (self.bias - self.mean * inv).to(x.dtype)


class SEModule(nn.Module):
    """Squeeze-excitation (`helpers.py:58-76`)."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv(features, features // reduction, 1, use_bias=False)
        self.fc2 = Conv(features // reduction, features, 1, use_bias=False)

    def forward(self, x):
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class BottleneckIRSE(nn.Module):
    """IR-SE residual unit (`helpers.py:99-120`)."""

    def __init__(self, in_ch: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        if in_ch != depth:
            self.shortcut_conv = Conv(in_ch, depth, 1, stride=stride,
                                      use_bias=False)
            self.shortcut_bn = FrozenBatchNorm(depth)
        else:
            self.shortcut_conv = None
        self.bn1 = FrozenBatchNorm(in_ch)
        self.conv1 = Conv(in_ch, depth, 3, padding=1, use_bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = Conv(depth, depth, 3, stride=stride, padding=1,
                          use_bias=False)
        self.bn2 = FrozenBatchNorm(depth)
        self.se = SEModule(depth)

    def forward(self, x):
        if self.shortcut_conv is None:
            shortcut = x[:, ::self.stride, ::self.stride, :]  # MaxPool2d(1, s)
        else:
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        res = self.conv2(self.prelu(self.conv1(self.bn1(x))))
        return self.se(self.bn2(res)) + shortcut


def _tap_indices(stages) -> tuple[int, int, int]:
    """c1/c2/c3 taps: the last unit of stages 2/3/4 (6/20/23 for IR-50)."""
    ends = np.cumsum([n for _, n in stages]) - 1
    return int(ends[1]), int(ends[2]), int(ends[3])


class GradualStyleBlock(nn.Module):
    """Stride-2 conv stack -> EqualLinear style head (`psp_encoders.py:34-55`)."""

    def __init__(self, in_ch: int, out_features: int, spatial: int):
        super().__init__()
        self.num_pools = int(math.log2(spatial))
        for i in range(self.num_pools):
            self.add_module(f"conv{i}", Conv(in_ch if i == 0 else out_features,
                                             out_features, 3, stride=2,
                                             padding=1))
        self.linear = EqualLinear(out_features, out_features)

    def forward(self, x):
        for i in range(self.num_pools):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.01)
        return self.linear(x.reshape(x.shape[0], -1))


class Encoder4Editing(nn.Module):
    """e4e main style encoder (`psp_encoders.py:124-231`), all deltas active."""

    COARSE_IND = 3
    MIDDLE_IND = 7

    def __init__(self, stylegan_size: int = 1024, input_channels: int = 3,
                 stages=IR50_STAGES, encode_size: int = 256):
        super().__init__()
        self.stages = tuple(tuple(s) for s in stages)
        self.encode_size = encode_size
        self.style_count = 2 * int(math.log2(stylegan_size)) - 2
        input_ch = min(64, self.stages[0][0])
        self.input_conv = Conv(input_channels, input_ch, 3, padding=1,
                               use_bias=False)
        self.input_bn = FrozenBatchNorm(input_ch)
        self.input_prelu = PReLU(input_ch)
        body, in_ch = [], input_ch
        for depth, num_units in self.stages:
            for unit in range(num_units):
                body.append(BottleneckIRSE(in_ch, depth, 2 if unit == 0 else 1))
                in_ch = depth
        self.body = nn.ModuleList(body)
        lat_ch = self.stages[-1][0]
        heads = []
        for i in range(self.style_count):
            spatial = (encode_size // 16 if i < self.COARSE_IND
                       else (encode_size // 8 if i < self.MIDDLE_IND
                             else encode_size // 4))
            heads.append(GradualStyleBlock(lat_ch, 512, spatial))
        self.style = nn.ModuleList(heads)
        self.latlayer1 = Conv(self.stages[2][0], lat_ch, 1)
        self.latlayer2 = Conv(self.stages[1][0], lat_ch, 1)

    def forward(self, x):
        x = self.input_prelu(self.input_bn(self.input_conv(x)))
        tap1, tap2, tap3 = _tap_indices(self.stages)
        for idx, unit in enumerate(self.body):
            x = unit(x)
            if idx == tap1:
                c1 = x
            elif idx == tap2:
                c2 = x
            elif idx == tap3:
                c3 = x
        w0 = self.style[0](c3)
        deltas = [torch.zeros_like(w0)]
        features = c3
        for i in range(1, self.style_count):
            if i == self.COARSE_IND:
                p2 = (resize_bilinear_align_corners(c3, c2.shape[1:3])
                      + self.latlayer1(c2))
                features = p2
            elif i == self.MIDDLE_IND:
                features = (resize_bilinear_align_corners(p2, c1.shape[1:3])
                            + self.latlayer2(c1))
            deltas.append(self.style[i](features))
        return w0[:, None, :] + torch.stack(deltas, dim=1)
