"""Train state, the optimiser and EMA.

Counterpart of `vspbfr_tpu/train/state.py`. The reference's conventions:

- lazy-regularisation-scaled Adam (`restoration_train.py:397-409`
  upstream): lr * r/(r+1), betas (0, 0.99^(r/(r+1))) for regularisation
  period r (the diffuser uses r = 4, so lr * 0.8 and beta2 0.99^0.8).
  `torch.optim.Adam` with eps 1e-8 computes optax.adam's update:
  m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps);
- EMA of parameters with decay 0.5^(32/10000) ~= 0.99779.

On a 2-D mesh the module may be model-sharded (`parallel.model_axis`):
Adam then runs over the stored slices, so its moments are 1/n_model of a
sharded parameter's size, and `state_dict` gathers them (and the
parameters) to the full tensors of the unsharded state, in its order;
`load_state_dict` takes that state and keeps each rank's slice.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from vspbfr_tpu_torch.parallel.model_axis import (
    model_axis,
    parameters_in_order,
    sharded_names,
)

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
    update; with a `parallel.spatial.Spatial` (a module that runs layers
    on H-sharded rows), the row parts of those layers' replicated
    parameters' gradients are summed over the model axis first."""

    def __init__(self, module: nn.Module, lr: float,
                 reg_every: int | None = None, dp=None, spatial=None):
        self.module = module
        self.opt = make_adam(parameters_in_order(module), lr, reg_every)
        self.step = 0
        self.dp = dp
        self.spatial = spatial

    def apply_gradients(self) -> None:
        """One Adam update from the gradients in `.grad`, which it clears.
        A parameter the loss did not reach takes a zero gradient, as every
        leaf does in optax (its second moment decays), so every rank
        reduces the same set; then the model axis' sum of the row parts
        and the data axis' all-reduce (where XLA puts them in the JAX
        package's sharded step)."""
        params = list(self.module.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.spatial is not None:
            self.spatial.sum_partial_grads(self.module)
        if self.dp is not None:
            self.dp.all_reduce_grads(params)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.step += 1

    def _moments(self, opt_sd: dict, fn) -> dict:
        """opt_sd with fn applied to the moments of each model-sharded
        parameter (gather or slice); unchanged without a model axis."""
        axis = model_axis(self.module)
        if axis is None:
            return opt_sd
        names = self.module._model_axis["names"]
        sharded = set(sharded_names(self.module))
        state = {}
        for i, st in opt_sd["state"].items():
            if names[i] in sharded:
                st = {k: fn(axis, v) if torch.is_tensor(v) and v.dim() else v
                      for k, v in st.items()}
            state[i] = st
        return {**opt_sd, "state": state}

    def state_dict(self) -> dict:
        """The module's state_dict, Adam's and the step: the full tensors
        also when the module is model-sharded (collective over the model
        group then)."""
        return {"params": self.module.state_dict(),
                "opt": self._moments(self.opt.state_dict(),
                                     lambda ax, v: ax.gather(v)),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.module.load_state_dict(sd["params"])
        self.opt.load_state_dict(self._moments(
            sd["opt"], lambda ax, v: ax.local(v).contiguous()))
        self.step = int(sd["step"])


@torch.no_grad()
def ema_update(ema: nn.Module, module: nn.Module,
               decay: float = EMA_DECAY_DEFAULT) -> None:
    """ema <- decay * ema + (1 - decay) * module, parameter by parameter,
    in place."""
    for e, p in zip(ema.parameters(), module.parameters()):
        e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)
