"""pSp facade: frozen style encoder + frozen StyleGAN2 decoder.

Counterpart of `vspbfr_tpu/models/psp.py`. Here the facade is an
`nn.Module` that owns the encoder, the decoder and `latent_avg`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vspbfr_tpu_torch.models.e4e import IR50_STAGES, Encoder4Editing
from vspbfr_tpu_torch.models.layers import styles_to_latent
from vspbfr_tpu_torch.models.stylegan2 import Generator


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """AdaptiveAvgPool2d for divisible sizes (1024 -> 512), NHWC."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh or w % ow:
        raise ValueError("adaptive pool needs divisible sizes")
    return x.reshape(b, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, align_corners=False, antialiased when shrinking:
    `jax.image.resize(..., "linear")` in the JAX package antialiases a
    downscale, so the port does too (`antialias=True`)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class PSPFacade(nn.Module):
    """out_size: pipeline resolution (512); size: decoder resolution (1024);
    mapping: give the decoder its z -> w MLP (`mean_latent`,
    `noise_mapping`); packed_min_res: the decoder's space-to-depth
    threshold (0: none)."""

    def __init__(self, out_size: int = 512, size: int = 1024,
                 input_channels: int = 3, encode_size: int = 256,
                 encoder_stages=None, channel_div: int = 1,
                 mapping: bool = False, packed_min_res: int = 0):
        super().__init__()
        self.out_size, self.size = out_size, size
        self.n_latent = 2 * int(math.log2(size)) - 2
        self.out_n_latent = 2 * int(math.log2(out_size)) - 2
        self.encoder = Encoder4Editing(
            stylegan_size=size, input_channels=input_channels,
            stages=encoder_stages or IR50_STAGES, encode_size=encode_size)
        self.decoder = Generator(size=size, channel_div=channel_div,
                                 mapping=mapping,
                                 packed_min_res=packed_min_res)
        self.latent_avg = nn.Parameter(torch.empty(self.n_latent, 512))

    def init_from(self, gen):
        self.latent_avg.zero_()

    @torch.no_grad()
    def get_w_plus(self, img: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, 3) in [-1, 1] -> (B, n_latent, 512) W+ code:
        resize to encode_size, encode, add latent_avg. A gradient boundary,
        as the JAX `stop_gradient` (psp.py:102): the result carries no
        graph, so no loss reaches the image or the encoder."""
        es = self.encoder.encode_size
        codes = self.encoder(resize_bilinear(img, (es, es)))
        return (codes + self.latent_avg[None])[:, : self.n_latent]

    def _pooled_from_packed(self) -> bool:
        """Whether the pooled image is the phase mean of the packed RGB:
        the top resolution packed and the pool exactly 2x2 (size to size /
        2), so no depth-to-space of the full image is needed
        (`_pooled_from_packed`, psp.py:105)."""
        return (self.decoder.packed(self.size)
                and 2 * self.out_size == self.size)

    def _pooled(self, decoder, codes, spatial=None, **kw):
        """(image pooled to out_size or None, features or None). With
        `spatial` the image's rows pool to the pooled image's rows (whole
        where out_size is not sharded): the packed RGB's packed rows are
        the pooled image's rows."""
        if kw.get("return_image", True) and self._pooled_from_packed():
            packed, feats = decoder(codes, return_packed_rgb=True,
                                    spatial=spatial, **kw)
            b, h, w, _ = packed.shape
            image = packed.reshape(b, h, w, 4, 3).mean(dim=3)
        else:
            image, feats = decoder(codes, spatial=spatial, **kw)
            if image is not None:
                rows = image.shape[1] * self.out_size // image.shape[2]
                image = adaptive_avg_pool(image, (rows, self.out_size))
        if (image is not None and spatial is not None
                and not spatial.sharded(self.out_size)):
            image = spatial.gather(image)
        return image, feats

    def decode_with_feats(self, codes: torch.Tensor,
                          generator: torch.Generator | None = None,
                          return_image: bool = True, noise=None,
                          decoder: nn.Module | None = None, spatial=None):
        """W+ code -> (image pooled to out_size or None,
        features[:out_n_latent]). Without the image the decode stops at
        out_size, the last feature RestoreNet reads. noise: optional list of
        the decoder's per-layer maps (else drawn from `generator`); decoder:
        a stand-in for the own one (a copy in another dtype); spatial: a
        `parallel.spatial.Spatial` (the codes this rank's batch rows; the
        image and the features in their resolutions' layouts)."""
        image, feats = self._pooled(
            decoder or self.decoder, codes, noise=noise,
            return_features=True, return_image=return_image,
            max_feature_res=None if return_image else self.out_size,
            generator=generator, spatial=spatial)
        return image, feats[: self.out_n_latent]

    def decode(self, codes: torch.Tensor,
               generator: torch.Generator | None = None,
               noise=None, decoder: nn.Module | None = None,
               spatial=None) -> torch.Tensor:
        """W+ code -> image pooled to out_size. noise: optional list of the
        decoder's per-layer noise maps (else drawn from `generator`);
        decoder: a stand-in for the own one; spatial: as
        `decode_with_feats` (the image in out_size's layout)."""
        return self._pooled(decoder or self.decoder, codes, noise=noise,
                            generator=generator, spatial=spatial)[0]

    def mean_latent(self, n_samples: int = 4096,
                    generator: torch.Generator | None = None,
                    z: torch.Tensor | None = None) -> torch.Tensor:
        """Average mapped w over random z, (1, 512)
        (`e4e/models/psp.py:186-196`). The (n_samples, 512) z are drawn
        from `generator` on the decoder's device, or handed in as `z`."""
        if z is None:
            if generator is None:
                raise ValueError("mean_latent needs z or a torch.Generator")
            z = torch.randn((n_samples, 512), generator=generator,
                            device=generator.device)
        return self.decoder.map_latent(z).mean(dim=0, keepdim=True)

    def noise_mapping(self, styles: torch.Tensor,
                      inject_index: int | None = None) -> torch.Tensor:
        """z styles (S, B, 512) -> the mixed (B, n_latent, 512) w latent
        through the decoder's mapping MLP (`e4e/models/psp.py:190-223`)."""
        mapped = torch.stack([self.decoder.map_latent(styles[s])
                              for s in range(styles.shape[0])])
        return styles_to_latent(mapped, self.n_latent, inject_index)
