"""Latent DDPM sampler for the code diffuser (T=4, x0-parameterisation).

Counterpart of `vspbfr_tpu/diffusion/ddpm.py`: the eval sampler and the
stage-2 training chain. The "linear" schedule is linear in sqrt space,
computed in float64; each reverse step returns only the posterior mean, so
both chains are deterministic given their noise. Training noises the
condition to t = T-1 (`q_sample`) and unrolls the whole reverse loop with
gradients (`training_chain`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Precomputed diffusion constants (shape (T,) float32)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @staticmethod
    def linear(timesteps: int = 4, linear_start: float = 0.1,
               linear_end: float = 0.99) -> "DDPMSchedule":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                            dtype=np.float64) ** 2
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        f32 = lambda a: a.astype(np.float32)  # noqa: E731
        return DDPMSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas)
                                     / (1.0 - ac)),
        )


class LatentDDPM:
    """Sampler around a denoiser fn(x, cond, t) -> x0_hat."""

    def __init__(self, denoise_fn: Callable,
                 schedule: DDPMSchedule | None = None):
        self.denoise = denoise_fn
        self.sched = schedule or DDPMSchedule.linear()

    def q_sample(self, x_start: torch.Tensor, t: int,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward noising q(x_t | x_0) at a fixed timestep."""
        s = self.sched
        return (float(s.sqrt_alphas_cumprod[t]) * x_start
                + float(s.sqrt_one_minus_alphas_cumprod[t]) * noise)

    def p_sample_mean(self, x: torch.Tensor, cond: torch.Tensor,
                      t: int) -> torch.Tensor:
        """One reverse step: predict x0, return the posterior mean only."""
        s = self.sched
        tb = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        x0_hat = self.denoise(x, cond, tb)
        return (float(s.posterior_mean_coef1[t]) * x0_hat
                + float(s.posterior_mean_coef2[t]) * x)

    def sample(self, cond: torch.Tensor,
               init_noise: torch.Tensor) -> torch.Tensor:
        """Reverse chain from N(0, I) noise shaped like cond."""
        x = init_noise
        for t in reversed(range(self.sched.num_timesteps)):
            x = self.p_sample_mean(x, cond, t)
        return x

    def training_chain(self, x_start: torch.Tensor, cond: torch.Tensor,
                       noise: torch.Tensor):
        """Noise x_start to t = T-1, then run the full reverse loop with
        gradients. Returns (final, [x_noisy, each step's output])."""
        x = self.q_sample(x_start, self.sched.num_timesteps - 1, noise)
        chain = [x]
        for t in reversed(range(self.sched.num_timesteps)):
            x = self.p_sample_mean(x, cond, t)
            chain.append(x)
        return x, chain
