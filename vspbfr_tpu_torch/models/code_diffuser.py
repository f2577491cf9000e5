"""Code diffuser: the latent-DDPM denoiser over (B, 18, 512) W+ codes.

Counterpart of `vspbfr_tpu/models/code_diffuser.py`: four TACC blocks, each
with channel self-attention over the token axis, a spatial attention branch
over the feature axis (softmax over axis 1) and sigmoid/lrelu FiLM MLPs.
The timestep enters as one extra channel t/T. LayerNorms use flax's
eps 1e-6.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vspbfr_tpu_torch.models.layers import Dense, LayerNorm, pixel_norm
from vspbfr_tpu_torch.ops import scaled_leaky_relu


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax nn.LayerNorm(use_scale=False, use_bias=False)."""
    return nn.functional.layer_norm(x, (x.shape[-1],), eps=1e-6)


class SpatialAttention(nn.Module):
    """Cross-branch attention over the feature axis
    (`models/CodeDiffuser.py:15-47`)."""

    def __init__(self, latent_dim: int = 512):
        super().__init__()
        d = latent_dim
        self.d = d
        self.q = Dense(d, d, use_bias=False)
        self.k = Dense(d + 1, d, use_bias=False)
        self.v = Dense(d, d, use_bias=False)

    def forward(self, w, attribute):
        q, k, v = self.q(w), self.k(attribute), self.v(w)
        score = torch.einsum("bli,blj->bij", k, q) / math.sqrt(self.d)
        attn = torch.softmax(score, dim=1)
        return _layer_norm(torch.einsum("bld,bdj->blj", v, attn))


class TACCBlock(nn.Module):
    """Timestep-Aware Cross-attention Conditioning block
    (`models/CodeDiffuser.py:63-116`)."""

    def __init__(self, latent_dim: int = 512, n_tokens: int = 18):
        super().__init__()
        d = latent_dim
        self.n_tokens = n_tokens
        self.k = Dense(d, d, use_bias=False)
        self.v = Dense(d, d, use_bias=False)
        self.q = Dense(d + 1, d, use_bias=False)
        self.attention_layer = SpatialAttention(d)
        for name in ("gamma", "beta"):
            self.add_module(f"{name}_fc0", Dense(d + 1, d))
            self.add_module(f"{name}_ln", LayerNorm(d))
            self.add_module(f"{name}_fc1", Dense(d, d))

    def _film(self, name, c, final_act):
        y = getattr(self, f"{name}_fc0")(c)
        y = scaled_leaky_relu(getattr(self, f"{name}_ln")(y))
        return final_act(getattr(self, f"{name}_fc1")(y))

    def forward(self, x, embd, step):
        x = pixel_norm(x, dim=1)  # over the token axis
        k, v = self.k(x), self.v(x)
        c_embd = torch.cat([embd, step], dim=-1)
        q = self.q(c_embd)
        score = torch.einsum("bld,bmd->blm", k, q) / math.sqrt(self.n_tokens)
        h = torch.einsum("blm,bmd->bld", torch.softmax(score, dim=-1), v)
        h = _layer_norm(h + self.attention_layer(x, c_embd))
        gamma = self._film("gamma", c_embd, torch.sigmoid)
        beta = self._film("beta", c_embd, scaled_leaky_relu)
        return h * (1.0 + gamma) + beta


class CodeDiffuser(nn.Module):
    """Denoiser of n_blocks TACC blocks (`models/CodeDiffuser.py:121-140`)."""

    def __init__(self, timesteps: int = 4, latent_dim: int = 512,
                 n_blocks: int = 4, n_tokens: int = 18):
        super().__init__()
        self.timesteps = timesteps
        self.block = nn.ModuleList(TACCBlock(latent_dim, n_tokens)
                                   for _ in range(n_blocks))

    def forward(self, x, embd, t):
        """x, embd (B, L, D); t (B,) integer timesteps."""
        tt = (t.float() / self.timesteps)[:, None, None]
        tt = tt.expand(-1, embd.shape[1], 1).to(embd.dtype)
        for blk in self.block:
            x = blk(x, embd, tt)
        return x
