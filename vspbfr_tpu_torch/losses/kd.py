"""KD loss of diffuser training.

Counterpart of `vspbfr_tpu/losses/kd.py` (`code_diffuser_train.py:64-91`
upstream). Returns (kl_term, l1_term). Quirk Q3 of the reference is kept:
the KL term is computed and logged but NOT added to the optimised loss;
only the L1 term trains the diffuser.
"""

from __future__ import annotations

import torch


def kd_loss(pred: torch.Tensor, target: torch.Tensor,
            temperature: float = 0.15) -> tuple[torch.Tensor, torch.Tensor]:
    """KL(softmax(target/T) || softmax(pred/T)) summed over the last axis
    and every element, divided by the batch (`F.kl_div` batchmean), and
    the mean |pred - target|."""
    logp = torch.log_softmax(pred / temperature, dim=-1)
    logq = torch.log_softmax(target / temperature, dim=-1)
    kl = torch.sum(logq.exp() * (logq - logp)) / pred.shape[0]
    l1 = torch.mean(torch.abs(pred - target))
    return kl, l1
