"""Train state, the optimiser and EMA.

Counterpart of `vspbfr_tpu/train/state.py`. The reference's conventions:

- lazy-regularisation-scaled Adam (`restoration_train.py:397-409`
  upstream): lr * r/(r+1), betas (0, 0.99^(r/(r+1))) for regularisation
  period r (the diffuser uses r = 4, so lr * 0.8 and beta2 0.99^0.8).
  `torch.optim.Adam` with eps 1e-8 computes optax.adam's update:
  m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps);
- EMA of parameters with decay 0.5^(32/10000) ~= 0.99779.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

EMA_DECAY_DEFAULT = 0.5 ** (32.0 / 10_000.0)


def make_adam(params: Iterable[torch.Tensor], lr: float,
              reg_every: int | None = None) -> torch.optim.Adam:
    """Adam with the lazy-regularisation ratio folded into lr and beta2."""
    ratio = reg_every / (reg_every + 1.0) if reg_every else 1.0
    return torch.optim.Adam(params, lr=lr * ratio, betas=(0.0, 0.99 ** ratio),
                            eps=1e-8)


class TrainState:
    """A trained module, its Adam and the count of updates applied; with a
    `DataParallel`, the gradients are averaged over its ranks before each
    update."""

    def __init__(self, module: nn.Module, lr: float,
                 reg_every: int | None = None, dp=None):
        self.module = module
        self.opt = make_adam(module.parameters(), lr, reg_every)
        self.step = 0
        self.dp = dp

    def apply_gradients(self) -> None:
        """One Adam update from the gradients in `.grad`, which it clears.
        A parameter the loss did not reach takes a zero gradient, as every
        leaf does in optax (its second moment decays), so every rank
        reduces the same set; then the all-reduce (where XLA puts it in
        the JAX package's sharded step)."""
        params = list(self.module.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.dp is not None:
            self.dp.all_reduce_grads(params)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.module.load_state_dict(sd["params"])
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])


@torch.no_grad()
def ema_update(ema: nn.Module, module: nn.Module,
               decay: float = EMA_DECAY_DEFAULT) -> None:
    """ema <- decay * ema + (1 - decay) * module, parameter by parameter,
    in place."""
    for e, p in zip(ema.parameters(), module.parameters()):
        e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)
