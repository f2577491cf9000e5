"""StyleGAN2 generator: the frozen FFHQ decoder of the pipeline.

Counterpart of `vspbfr_tpu/models/stylegan2.py` (unpacked layout). Driven
with W+ codes (input_is_latent); `return_features` collects the
per-resolution features the RestoreNet skip fusion reads. Eager torch runs
every layer it is asked for, so a caller that needs only the features up to
some resolution (and no image) says so with `return_image=False,
max_feature_res=...` and the levels above are not computed.
"""

from __future__ import annotations

import math
import torch
from torch import nn

from vspbfr_tpu_torch.models.layers import StyledConv, ToRGB, _normal


def channel_dict(channel_multiplier: int = 2,
                 channel_div: int = 1) -> dict[int, int]:
    """Resolution -> channels (`e4e/models/stylegan2/model.py:395-405`);
    channel_div narrows the towers (floor 8) for small test configs."""
    base = {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }
    if channel_div == 1:
        return base
    return {k: max(8, v // channel_div) for k, v in base.items()}


class Generator(nn.Module):
    """The synthesis network. The z -> w mapping MLP is not ported: the
    frozen decoder is driven by W+ codes only, and the JAX pipeline's
    parameter tree holds no mapping for it."""

    def __init__(self, size: int = 1024, style_dim: int = 512,
                 channel_multiplier: int = 2, channel_div: int = 1):
        super().__init__()
        self.size = size
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        ch = channel_dict(channel_multiplier, channel_div)
        self.const_input = nn.Parameter(torch.empty(1, 4, 4, ch[4]))
        self.conv1 = StyledConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = ToRGB(ch[4], style_dim)
        convs, to_rgbs = [], []
        for i in range(3, self.log_size + 1):
            res = 2 ** i
            convs.append(StyledConv(ch[res // 2], ch[res], style_dim,
                                    upsample=True))
            convs.append(StyledConv(ch[res], ch[res], style_dim))
            to_rgbs.append(ToRGB(ch[res], style_dim))
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(to_rgbs)

    def init_from(self, gen):
        _normal(self.const_input, gen)

    def forward(self, latent: torch.Tensor, noise=None,
                return_features: bool = False, return_image: bool = True,
                max_feature_res: int | None = None,
                generator: torch.Generator | None = None):
        """Decode a (B, n_latent, style_dim) W+ code.

        noise: optional list of num_layers (B, r, r, 1) maps; otherwise each
        layer draws from `generator`. Returns (image (B, size, size, 3) or
        None, features or None); features[0] is the 4x4 map after conv1,
        then one per up-conv at 8, 16, ... With return_image=False the
        decode stops after the up-conv at max_feature_res."""
        b = latent.shape[0]
        if noise is None:
            noise = [None] * self.num_layers
        out = self.const_input.expand(b, -1, -1, -1).contiguous()
        out = self.conv1(out, latent[:, 0], noise=noise[0],
                         generator=generator)
        skip = self.to_rgb1(out, latent[:, 1]) if return_image else None
        features = [out] if return_features else None
        i = 1
        for k in range(0, len(self.convs), 2):
            out = self.convs[k](out, latent[:, i], noise=noise[k + 1],
                                generator=generator)
            if return_features:
                features.append(out)
            if (not return_image and max_feature_res is not None
                    and out.shape[1] >= max_feature_res):
                break
            out = self.convs[k + 1](out, latent[:, i + 1], noise=noise[k + 2],
                                    generator=generator)
            if return_image:
                skip = self.to_rgbs[k // 2](out, latent[:, i + 2], skip)
            i += 2
        return skip, features
