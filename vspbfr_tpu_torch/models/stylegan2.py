"""StyleGAN2 generator: the frozen FFHQ decoder of the pipeline.

Counterpart of `vspbfr_tpu/models/stylegan2.py`. Driven with W+ codes
(input_is_latent); `return_features` collects the per-resolution features
the RestoreNet skip fusion reads. Eager torch runs every layer it is asked
for, so a caller that needs only the features up to some resolution (and
no image) says so with `return_image=False, max_feature_res=...` and the
levels above are not computed.

Resolutions at or above `packed_min_res` (0: none) run in the
space-to-depth layout (`ops/packed.py`), with the same parameters; their
feature taps come back packed, (B, r/2, r/2, 4C), so RestoreNet must use
the same threshold. The JAX package's default is 512, the port's 0 (the
CLIs' `--packed_min_res` sets it).

`spatial` (a `parallel.spatial.Spatial`) decodes this rank's rows of the
H-sharded levels (`parallel/spatial.py`), in either layout: the codes are
this rank's batch rows; the image and the feature taps come back in their
resolutions' layouts (local rows from `MIN_ROWS` image rows a shard up,
whole below; a packed tap its packed rows, the top level's depth-to-space
and the packed RGB on this rank's rows). Each
layer runs in `Spatial.layer`'s context, and the layers on rows read the
codes through `Spatial.summed`, so a backward (stage 2's LPIPS and ID
terms into the codes) sums their row parts over the model axis once.
"""

from __future__ import annotations

import math
import torch
from torch import nn

from vspbfr_tpu_torch.models.layers import (
    StyledConv,
    StyleMLP,
    ToRGB,
    _normal,
    styled_runner,
)
from vspbfr_tpu_torch.ops.packed import depth_to_space


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
    """The synthesis network, and with `mapping=True` the z -> w mapping
    MLP (`style`, n_mlp equalized linears) that `map_latent` runs. The
    pipeline drives the frozen decoder with W+ codes only, and a JAX
    parameter tree initialised through `__call__` holds no mapping, so the
    default builds none (flax creates `style` only when `map_latent` is
    initialised)."""

    def __init__(self, size: int = 1024, style_dim: int = 512,
                 channel_multiplier: int = 2, channel_div: int = 1,
                 mapping: bool = False, n_mlp: int = 8,
                 packed_min_res: int = 0):
        super().__init__()
        self.style = StyleMLP(style_dim, n_mlp) if mapping else None
        self.size = size
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.packed_min_res = packed_min_res
        ch = channel_dict(channel_multiplier, channel_div)
        self.const_input = nn.Parameter(torch.empty(1, 4, 4, ch[4]))
        self.conv1 = StyledConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = ToRGB(ch[4], style_dim)
        convs, to_rgbs = [], []
        for i in range(3, self.log_size + 1):
            res = 2 ** i
            pk_in, pk_out = self.packed(res // 2), self.packed(res)
            convs.append(StyledConv(ch[res // 2], ch[res], style_dim,
                                    upsample=True, packed_in=pk_in,
                                    packed_out=pk_out))
            convs.append(StyledConv(ch[res], ch[res], style_dim,
                                    packed_in=pk_out, packed_out=pk_out))
            to_rgbs.append(ToRGB(ch[res], style_dim, packed=pk_out,
                                 skip_packed=pk_in))
        self.convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(to_rgbs)

    def init_from(self, gen):
        _normal(self.const_input, gen)

    def packed(self, res: int) -> bool:
        """Whether resolution res runs in the packed layout."""
        return bool(self.packed_min_res) and res >= self.packed_min_res

    def noise_shapes(self, batch: int) -> list[tuple]:
        """The per-layer noise maps' shapes as the layers draw them: (B, r,
        r, 1), or (B, r/2, r/2, 4) at a packed resolution."""
        res = [4] + [2 ** (i // 2 + 3) for i in range(self.num_layers - 1)]
        return [(batch, r // 2, r // 2, 4) if self.packed(r)
                else (batch, r, r, 1) for r in res]

    def map_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., style_dim) -> w through the mapping MLP (its bias +
        leaky ReLUs are K7 on the card)."""
        if self.style is None:
            raise ValueError("map_latent needs a Generator built with "
                             "mapping=True")
        return self.style(z)

    def forward(self, latent: torch.Tensor, noise=None,
                return_features: bool = False, return_image: bool = True,
                max_feature_res: int | None = None,
                generator: torch.Generator | None = None,
                return_packed_rgb: bool = False, spatial=None):
        """Decode a (B, n_latent, style_dim) W+ code.

        noise: optional list of num_layers (B, r, r, 1) maps (or, at a
        packed resolution, the packed draw of `noise_shapes`); otherwise
        each layer draws from `generator`. Returns (image (B, size, size,
        3) or None, features or None); features[0] is the 4x4 map after
        conv1, then one per up-conv at 8, 16, ..., packed at the packed
        resolutions. With return_image=False the decode stops after the
        up-conv at max_feature_res. return_packed_rgb: where the top
        resolution is packed, return the (B, size/2, size/2, 12) packed RGB
        (phase groups (gy, gx, rgb)) without the final depth-to-space."""
        b = latent.shape[0]
        if noise is None:
            noise = [None] * self.num_layers
        run = styled_runner(spatial, lambda i: latent[:, i], latent)
        out = self.const_input.expand(b, -1, -1, -1).contiguous()
        out = run(self.conv1, out, 0, noise=noise[0], generator=generator)
        skip = run(self.to_rgb1, out, 1) if return_image else None
        features = [out] if return_features else None
        i = 1
        for k in range(0, len(self.convs), 2):
            out = run(self.convs[k], out, i, noise=noise[k + 1],
                      generator=generator)
            if return_features:
                features.append(out)
            if (not return_image and max_feature_res is not None
                    and 2 ** (k // 2 + 3) >= max_feature_res):
                break
            out = run(self.convs[k + 1], out, i + 1, noise=noise[k + 2],
                      generator=generator)
            if return_image:
                skip = run(self.to_rgbs[k // 2], out, i + 2, skip)
            i += 2
        if skip is not None and self.packed(self.size) and not (
                return_packed_rgb):
            skip = depth_to_space(skip)
        return skip, features
