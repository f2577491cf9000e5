"""RestoreNet: the SMART-layer U-Net restoration generator.

Counterpart of `vspbfr_tpu/models/restorenet.py::RestorationNet` (unpacked
layout; the discriminator waits for the training path). Dataflow:

  z -> style MLP -> mixing -> noise_latent (B, n_latent, 512)
  latent = concat(diffused W+ [:n_latent], noise_latent) -> (B, n, 1024)
  encoder, driven by the flipped latent: LargeConvLayer stem ->
    [SMART, StyledConv down] from size to 8 -> LargeConvLayer -> x_global,
    re-injected at 4x4 through final_transfer
  decoder: SMART at 4x4, then per level [StyledConv up + enc_feat +
    decoder feat, SMART, ToRGB skip]; its style is concat(latent[:, i],
    x_global).

Eval only: the encoder head's dropout is not applied.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vspbfr_tpu_torch.models.layers import (
    EqualLinear,
    LargeConvLayer,
    SMARTLayer,
    StyledConv,
    StyleMLP,
    ToRGB,
    styles_to_latent,
)
from vspbfr_tpu_torch.models.stylegan2 import channel_dict


class RestorationNet(nn.Module):
    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, channel_div: int = 1):
        super().__init__()
        self.size = size
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        ch = channel_dict(channel_multiplier, channel_div)
        lat_dim = 2 * style_dim           # W+ code beside the noise latent
        dec_dim = lat_dim + 2 * ch[4]     # ... and x_global
        self.style = StyleMLP(style_dim, n_mlp)

        self.conv1 = SMARTLayer(ch[4], ch[4], dec_dim)
        self.to_rgb1 = ToRGB(ch[4], dec_dim)
        convs, to_rgbs = [], []
        for i in range(3, self.log_size + 1):
            res = 2 ** i
            convs.append(StyledConv(ch[res // 2], ch[res], dec_dim,
                                    upsample=True))
            convs.append(SMARTLayer(ch[res], ch[res], dec_dim))
            to_rgbs.append(ToRGB(ch[res], dec_dim))
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(to_rgbs)

        self.down_from_big = LargeConvLayer(3, ch[size], 1)
        enc = []
        for i in range(self.log_size, 2, -1):
            res = 2 ** i
            enc.append(SMARTLayer(ch[res], ch[res], lat_dim))
            enc.append(StyledConv(ch[res], ch[res // 2], lat_dim,
                                  downsample=True))
        self.encoder_convs = nn.ModuleList(enc)
        self.final_layer = LargeConvLayer(ch[4], ch[4], 3)
        self.final_linear = EqualLinear(ch[4] * 16, ch[4] * 2,
                                        activation=True)
        self.final_transfer = EqualLinear(ch[4] * 2, ch[4] * 16,
                                          activation=True)

    def encoder_forward(self, imgs, latent, generator):
        """`models/RestoreNet.py:915-942`. latent: flipped (B, n, 1024)."""
        b = imgs.shape[0]
        out = self.down_from_big(imgs)
        features = []
        for ii in range(0, len(self.encoder_convs), 2):
            out = self.encoder_convs[ii](out, latent[:, ii],
                                         generator=generator)
            features.append(out)
            out = self.encoder_convs[ii + 1](out, latent[:, ii],
                                             generator=generator)
        out = self.final_layer(out)
        x_global = self.final_linear(out.reshape(b, -1))
        early = self.final_transfer(x_global).reshape(b, 4, 4, -1)
        features.append(out + early)
        return x_global, features[::-1]

    def map_styles(self, styles: torch.Tensor,
                   inject_index: int | None = None) -> torch.Tensor:
        """(S, B, 512) z -> (B, n_latent, 512) mixed w latent."""
        mapped = torch.stack([self.style(styles[s])
                              for s in range(styles.shape[0])])
        return styles_to_latent(mapped, self.n_latent, inject_index)

    def forward(self, images, de_feats, pre_styles, noise_styles,
                inject_index=None, input_is_latent: bool = False,
                generator: torch.Generator | None = None):
        """Restore `images` (B, size, size, 3) in [-1, 1].

        de_feats: decoder features (index 1.. used at 8..size); pre_styles:
        diffused W+ code (B, >= n_latent, 512); noise_styles: (S, B, 512) z,
        or with input_is_latent a (B, n_latent, 512) latent. Every layer
        draws its noise map from `generator` (the reference's
        randomize_noise)."""
        if input_is_latent:
            noise_latent = noise_styles
        else:
            noise_latent = self.map_styles(noise_styles, inject_index)
        latent = torch.cat([pre_styles[:, : self.n_latent], noise_latent],
                           dim=-1)
        x_global, features = self.encoder_forward(
            images, torch.flip(latent, dims=(1,)), generator)

        def sty(i):
            return torch.cat([latent[:, i], x_global], dim=-1)

        out = self.conv1(features[0], sty(0), generator=generator)
        skip = self.to_rgb1(out, sty(1))
        i = 1
        for k in range(0, len(self.convs), 2):
            fi = (i + 1) // 2
            out = self.convs[k](out, sty(i),
                                post_add=(features[fi], de_feats[fi]),
                                generator=generator)
            out = self.convs[k + 1](out, sty(i + 1), generator=generator)
            skip = self.to_rgbs[k // 2](out, sty(i + 2), skip)
            i += 2
        return skip
