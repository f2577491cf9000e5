"""GAN losses: softplus D, non-saturating G, R1 gradient penalty.

Counterpart of `vspbfr_tpu/losses/gan.py` (`restoration_train.py:54-79`
upstream). R1 differentiates D's summed logits with respect to the images
with `create_graph=True`, so the penalty stays differentiable in D's
parameters: its gradient is a double backward through D (on the card
through K1's and K1e's differentiable backwards).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred: torch.Tensor,
                    fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-D(real)) + softplus(D(fake)), each a mean."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """softplus(-D(fake)), a mean."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
               real: torch.Tensor) -> torch.Tensor:
    """E[ ||dD(x)/dx||^2 ] over the batch, differentiable in whatever
    d_apply's parameters are. `real` is not modified: the penalty takes
    its gradient at a detached copy."""
    x = real.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return grad.square().sum(dim=tuple(range(1, real.ndim))).mean()
