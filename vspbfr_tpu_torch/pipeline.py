"""The restoration pipeline: encode -> 4-step DDPM -> decode -> RestoreNet.

Counterpart of `vspbfr_tpu/pipeline.py::RestorationPipeline` (the product
path of the reference `restoration_test.py`). The pipeline is an
`nn.Module` holding `psp` (encoder, decoder, latent_avg), `diffuser` and
`generator` (RestoreNet), named as the JAX parameter tree is.

Randomness comes from one explicit `torch.Generator` on the device, drawn
in this order: the DDPM initial noise (float32), the decoder's noise maps,
the mixing draws (z, a Bernoulli(mixing_prob) coin, an inject index in
[1, n_latent)), then RestoreNet's noise maps. `draws=` hands in the DDPM
noise and the mixing draws instead (tests give the JAX package's numbers
this way).

Dtype islands: encode and DDPM run in float32; the decoder and RestoreNet
run in `compute_dtype` with their parameters cast once (`prepare_params`);
the output returns in the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from vspbfr_tpu_torch.diffusion import DDPMSchedule, LatentDDPM
from vspbfr_tpu_torch.models.code_diffuser import CodeDiffuser
from vspbfr_tpu_torch.models.layers import init_module
from vspbfr_tpu_torch.models.psp import PSPFacade
from vspbfr_tpu_torch.models.restorenet import Discriminator, RestorationNet

STAGES = ("encode", "ddpm", "decode", "full")


class RestorationPipeline(nn.Module):
    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, decoder_size: int = 1024,
                 timesteps: int = 4, mixing_prob: float = 0.5,
                 compute_dtype: torch.dtype | None = None,
                 encode_size: int = 256, encoder_stages=None,
                 channel_div: int = 1):
        super().__init__()
        self.style_dim, self.mixing_prob = style_dim, mixing_prob
        self.size, self.channel_multiplier = size, channel_multiplier
        self.channel_div = channel_div
        self.compute_dtype = compute_dtype
        self.psp = PSPFacade(out_size=size, size=decoder_size,
                             encode_size=encode_size,
                             encoder_stages=encoder_stages,
                             channel_div=channel_div)
        self.diffuser = CodeDiffuser(timesteps=timesteps)
        self.generator = RestorationNet(
            size=size, style_dim=style_dim, n_mlp=n_mlp,
            channel_multiplier=channel_multiplier, channel_div=channel_div)
        self.schedule = DDPMSchedule.linear(timesteps=timesteps,
                                            linear_start=0.1, linear_end=0.99)

    def init_from_seed(self, seed: int) -> "RestorationPipeline":
        """Random weights with the JAX package's init distributions, drawn
        on the CPU from `seed` (move the module afterwards)."""
        return init_module(self, torch.Generator().manual_seed(seed))

    def prepare_params(self, gen: RestorationNet | None = None):
        """Cast the compute_dtype stages (decoder, RestoreNet and an
        optional override of it) in place, once; the f32 islands stay."""
        if self.compute_dtype is not None:
            for m in (self.psp.decoder, self.generator, gen):
                if m is not None:
                    m.to(self.compute_dtype)
        return self

    def diffuse_latent(self, low_latent: torch.Tensor,
                       init_noise: torch.Tensor) -> torch.Tensor:
        ddpm = LatentDDPM(self.diffuser, self.schedule)
        return ddpm.sample(low_latent, init_noise)

    def sample_mixing_latent(self, gen: RestorationNet, rng: torch.Generator,
                             batch: int, draws=None) -> torch.Tensor:
        """The (B, n_latent, 512) mixed noise-style latent."""
        device = gen.style.fc0.weight.device
        n_lat = gen.n_latent
        if draws is not None:
            z = torch.as_tensor(draws["z"], device=device)
            idx = int(draws["inject_index"])
        else:
            z = torch.randn((2, batch, self.style_dim), generator=rng,
                            device=device)
            mix = bool(torch.rand((), generator=rng, device=device)
                       < self.mixing_prob)
            pick = int(torch.randint(1, n_lat, (), generator=rng,
                                     device=device))
            idx = pick if mix else n_lat
        return gen.map_styles(z.to(self.compute_dtype or torch.float32), idx)

    @torch.no_grad()
    def restore(self, low_imgs: torch.Tensor, rng: torch.Generator | None,
                gen: RestorationNet | None = None,
                return_sample: bool = False, upto: str = "full", draws=None):
        """Full inference path; `gen` overrides RestoreNet (e.g. its EMA).

        upto cuts the path after "encode" | "ddpm" | "decode" (returning
        the latent, the clean latent, or the decoder features) or runs it
        "full". return_sample also returns the decoder's image of the
        clean latent (the reference's *_sample.png)."""
        if upto not in STAGES:
            raise ValueError(f"upto must be one of {STAGES}, got {upto!r}")
        gen = self.generator if gen is None else gen
        self.prepare_params(gen)
        dt = self.compute_dtype
        out_dtype = low_imgs.dtype
        low_latent = self.psp.get_w_plus(low_imgs)
        if upto == "encode":
            return low_latent
        if draws is not None:
            init_noise = torch.as_tensor(draws["init_noise"],
                                         device=low_latent.device)
        else:
            init_noise = torch.randn(low_latent.shape, generator=rng,
                                     device=low_latent.device)
        clean = self.diffuse_latent(low_latent,
                                    init_noise.to(low_latent.dtype))
        if upto == "ddpm":
            return clean
        clean_c = clean.to(dt) if dt is not None else clean
        sample, feats = self.psp.decode_with_feats(
            clean_c, generator=rng, return_image=return_sample)
        feats = feats[: gen.log_size - 1]
        if upto == "decode":
            return feats
        noise_latent = self.sample_mixing_latent(gen, rng,
                                                 low_imgs.shape[0], draws)
        low_c = low_imgs.to(dt) if dt is not None else low_imgs
        out = gen(low_c, feats, clean_c, noise_latent, input_is_latent=True,
                  generator=rng)
        if return_sample:
            return out.to(out_dtype), sample.to(out_dtype)
        return out.to(out_dtype)

    def make_discriminator(self) -> Discriminator:
        """The stage-3 discriminator at this pipeline's size and widths
        (not a submodule: the serving checkpoint does not hold it)."""
        return Discriminator(size=self.size,
                             channel_multiplier=self.channel_multiplier,
                             channel_div=self.channel_div)
