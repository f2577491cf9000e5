"""RestoreNet: the SMART-layer U-Net restoration generator, and the
StyleGAN2 discriminator stage 3 trains it against.

Counterpart of `vspbfr_tpu/models/restorenet.py` (`RestorationNet`,
unpacked layout, and `Discriminator`). Dataflow of the generator:

  z -> style MLP -> mixing -> noise_latent (B, n_latent, 512)
  latent = concat(diffused W+ [:n_latent], noise_latent) -> (B, n, 1024)
  encoder, driven by the flipped latent: LargeConvLayer stem ->
    [SMART, StyledConv down] from size to 8 -> LargeConvLayer -> x_global,
    re-injected at 4x4 through final_transfer
  decoder: SMART at 4x4, then per level [StyledConv up + enc_feat +
    decoder feat, SMART, ToRGB skip]; its style is concat(latent[:, i],
    x_global).

Randomness is explicit. The noise maps come from `noise` (a list in the
order the layers run, `noise_shapes`) or from a `torch.Generator`. The
encoder head's Dropout(0.5) on x_global (`restorenet.py:132-133`) runs in
training only, with a keep mask handed in (`dropout_mask`, drawn by
`draw_dropout_mask`): kept units are scaled by 2, as flax's Dropout does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vspbfr_tpu_torch.models.layers import (
    ConvLayer,
    EqualLinear,
    LargeConvLayer,
    ResBlock,
    SMARTLayer,
    StyledConv,
    StyleMLP,
    ToRGB,
    minibatch_stddev,
    styles_to_latent,
)
from vspbfr_tpu_torch.models.stylegan2 import channel_dict


DROPOUT_RATE = 0.5


class RestorationNet(nn.Module):
    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, channel_div: int = 1):
        super().__init__()
        self.size = size
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        ch = channel_dict(channel_multiplier, channel_div)
        self.global_dim = ch[4] * 2       # x_global, where dropout acts
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

    def noise_shapes(self, batch: int) -> list[tuple]:
        """Shapes of the noise maps, in the order the layers run: per
        encoder level the SMART at res and the down conv at res / 2, then
        the decoder's SMART at 4 and per level the up conv and the SMART."""
        enc = []
        for i in range(self.log_size, 2, -1):
            enc += [2 ** i, 2 ** (i - 1)]
        dec = [4] + [2 ** i for i in range(3, self.log_size + 1)
                     for _ in range(2)]
        return [(batch, r, r, 1) for r in enc + dec]

    def draw_dropout_mask(self, batch: int, generator: torch.Generator,
                          device=None) -> torch.Tensor:
        """A (B, global_dim) bool keep mask, keep probability 0.5."""
        u = torch.rand((batch, self.global_dim), generator=generator,
                       device=device)
        return u >= DROPOUT_RATE

    def encoder_forward(self, imgs, latent, noise, generator, dropout_mask):
        """`models/RestoreNet.py:915-942`. latent: flipped (B, n, 1024)."""
        b = imgs.shape[0]
        out = self.down_from_big(imgs)
        features = []
        for ii in range(0, len(self.encoder_convs), 2):
            out = self.encoder_convs[ii](out, latent[:, ii], noise=noise[ii],
                                         generator=generator)
            features.append(out)
            out = self.encoder_convs[ii + 1](out, latent[:, ii],
                                             noise=noise[ii + 1],
                                             generator=generator)
        out = self.final_layer(out)
        x_global = self.final_linear(out.reshape(b, -1))
        if dropout_mask is not None:
            x_global = torch.where(dropout_mask, x_global
                                   / (1.0 - DROPOUT_RATE),
                                   torch.zeros_like(x_global))
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
                generator: torch.Generator | None = None, noise=None,
                dropout_mask: torch.Tensor | None = None):
        """Restore `images` (B, size, size, 3) in [-1, 1].

        de_feats: decoder features (index 1.. used at 8..size); pre_styles:
        diffused W+ code (B, >= n_latent, 512); noise_styles: (S, B, 512) z,
        or with input_is_latent a (B, n_latent, 512) latent. noise: the
        maps of `noise_shapes`, or None to draw each from `generator` (the
        reference's randomize_noise). dropout_mask: the encoder head's keep
        mask in training, None in eval."""
        if input_is_latent:
            noise_latent = noise_styles
        else:
            noise_latent = self.map_styles(noise_styles, inject_index)
        n_enc = 2 * (self.log_size - 2)
        if noise is None:
            noise = [None] * (n_enc + len(self.convs) + 1)
        latent = torch.cat([pre_styles[:, : self.n_latent], noise_latent],
                           dim=-1)
        x_global, features = self.encoder_forward(
            images, torch.flip(latent, dims=(1,)), noise[:n_enc], generator,
            dropout_mask)
        noise = noise[n_enc:]

        def sty(i):
            return torch.cat([latent[:, i], x_global], dim=-1)

        out = self.conv1(features[0], sty(0), noise=noise[0],
                         generator=generator)
        skip = self.to_rgb1(out, sty(1))
        i = 1
        for k in range(0, len(self.convs), 2):
            fi = (i + 1) // 2
            out = self.convs[k](out, sty(i),
                                post_add=(features[fi], de_feats[fi]),
                                noise=noise[k + 1], generator=generator)
            out = self.convs[k + 1](out, sty(i + 1), noise=noise[k + 2],
                                    generator=generator)
            skip = self.to_rgbs[k // 2](out, sty(i + 2), skip)
            i += 2
        return skip


class Discriminator(nn.Module):
    """StyleGAN2 discriminator (`models/RestoreNet.py:1205-1265`), names as
    the flax tree: `stem`, `res.<i>` (flax `res_<i>`, i = log2 of the
    block's input resolution), `final_conv`, `final_linear0/1`."""

    def __init__(self, size: int = 512, channel_multiplier: int = 2,
                 channel_div: int = 1, stddev_group: int = 4,
                 stddev_feat: int = 1):
        super().__init__()
        ch = channel_dict(channel_multiplier, channel_div)
        self.log_size = int(math.log2(size))
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        self.stem = ConvLayer(3, ch[size], 1)
        self.res = nn.ModuleDict({
            str(i): ResBlock(ch[2 ** i], ch[2 ** (i - 1)])
            for i in range(self.log_size, 2, -1)})
        self.final_conv = ConvLayer(ch[4] + stddev_feat, ch[4], 3)
        self.final_linear0 = EqualLinear(ch[4] * 16, ch[4], activation=True)
        self.final_linear1 = EqualLinear(ch[4], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, size, size, 3) images -> (B, 1) logits."""
        out = self.stem(x)
        for i in range(self.log_size, 2, -1):
            out = self.res[str(i)](out)
        out = minibatch_stddev(out, self.stddev_group, self.stddev_feat)
        out = self.final_conv(out)
        out = self.final_linear0(out.reshape(out.shape[0], -1))
        return self.final_linear1(out)
