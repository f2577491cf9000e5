"""Bias + leaky-ReLU * sqrt(2).

Counterpart of `vspbfr_tpu/ops/fused_act.py`. Plain torch: the JAX path
runs this in XLA (its Pallas `_flr_kernel` is not wired in).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """leaky_relu(x + bias) * scale, bias over the trailing (channel) axis."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.ndim - 1) + (-1,))
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x: torch.Tensor,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """leaky_relu(x) * sqrt(2) without bias."""
    return F.leaky_relu(x, negative_slope) * SQRT2
