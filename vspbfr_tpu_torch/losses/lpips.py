"""LPIPS perceptual distance (net-lin over VGG16), NHWC.

Counterpart of `vspbfr_tpu/losses/lpips.py` (the reference's vendored
`my_lpips/networks_basic.py:27-92`): scaling layer -> VGG16 taps
(relu1_2/2_2/3_3/4_3/5_3) -> channel unit-normalise -> squared difference
-> 1x1 lin heads (no bias) -> spatial mean -> sum over taps. Parameter
names mirror the flax tree: flax `vgg/conv1_2/kernel` is port
`vgg.conv1.2.kernel`, `lin3` is `lin3`.

`compute_dtype` (bf16) runs the VGG16 trunk in that dtype with f32
parameters cast at use; the unit-normalise, the lin heads and the
reductions stay f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vspbfr_tpu_torch.models.layers import Conv

# (features, convs) per block; taps at each block's end
VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# ImageNet-calibrated input affine (the reference's ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 conv trunk returning the 5 LPIPS taps (post-ReLU) in the
    input's dtype."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for b, (feat, n_convs) in enumerate(VGG16_BLOCKS):
            convs = []
            for _ in range(n_convs):
                convs.append(Conv(in_ch, feat, 3, padding=1))
                in_ch = feat
            self.add_module(f"conv{b}", nn.ModuleList(convs))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for b in range(len(VGG16_BLOCKS)):
            for conv in getattr(self, f"conv{b}"):
                x = F.relu(conv(x))
            taps.append(x)
            if b < len(VGG16_BLOCKS) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return taps


class LPIPS(nn.Module):
    """Calibrated perceptual distance; inputs (B, H, W, 3) in [-1, 1].
    Returns per-sample distances (B,); callers reduce."""

    def __init__(self, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.vgg = VGG16Features()
        for k, (feat, _) in enumerate(VGG16_BLOCKS):
            setattr(self, f"lin{k}", nn.Parameter(torch.empty(feat, 1)))

    def init_from(self, gen):
        for k in range(len(VGG16_BLOCKS)):
            getattr(self, f"lin{k}").fill_(1.0)

    def _taps(self, v: torch.Tensor) -> list[torch.Tensor]:
        """The trunk's taps, returned in at least f32."""
        acc = torch.promote_types(v.dtype, torch.float32)
        shift = torch.tensor(_SHIFT, device=v.device)
        scale = torch.tensor(_SCALE, device=v.device)
        v = (v - shift) / scale
        if self.compute_dtype is not None:
            v = v.to(self.compute_dtype)
        return [t.to(acc) for t in self.vgg(v)]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for k, (fx, fy) in enumerate(zip(self._taps(x), self._taps(y))):
            def unit(v):
                return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)
                                      + 1e-10)
            diff = (unit(fx) - unit(fy)) ** 2
            d = diff @ getattr(self, f"lin{k}")
            total = total + torch.mean(d, dim=(1, 2))
        return total[:, 0]
