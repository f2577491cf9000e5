"""PSNR and SSIM on NHWC batches.

Counterpart of `psnr` and `ssim` in `vspbfr_tpu/evaluation.py` (LPIPS and
FID wait for the loss networks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR; inputs (B, H, W, C) in [-1, 1] by default."""
    mse = ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def ssim(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Per-sample SSIM (gaussian 11x11, sigma 1.5, valid window,
    channel-averaged)."""
    size, sigma = 11, 1.5
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g = (g / g.sum()).astype(np.float32)
    c = a.shape[-1]
    win = torch.as_tensor(np.outer(g, g), device=a.device)
    win = win[None, None].expand(c, 1, size, size)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win, groups=c)

    a, b = a.float(), b.float()
    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_a = filt(a * a) - mu_a2
    s_b = filt(b * b) - mu_b2
    s_ab = filt(a * b) - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    m = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / (
        (mu_a2 + mu_b2 + c1) * (s_a + s_b + c2))
    return m.mean(dim=(1, 2, 3))
