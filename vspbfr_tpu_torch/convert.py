"""Flax parameter tree -> port `state_dict`.

The port's parameter names mirror the flax tree and its layouts already
match (linears (in, out), convs HWIO), so conversion only renames keys and
casts: a path component `name_<i>` (flax's name for the i-th entry of a
list of submodules) becomes `name.<i>` (an `nn.ModuleList` entry), and `/`
becomes `.`. So flax `convs_3/conv/weight` is port `convs.3.conv.weight`.

The same rule carries the stage-2 loss nets, whose port modules are named
for it: LPIPS's `vgg/conv1_2/kernel` is `vgg.conv1.2.kernel` (a ModuleList
per VGG block) and `lin3` stays `lin3`; the ResNet-101 embedder's
`layer3_5/bn2/var` is `layer3.5.bn2.var` (flax `nn.Conv` leaves are
`kernel`/`bias`, `FrozenBatchNorm` leaves `scale`/`bias`/`mean`/`var`, in
both packages).

This module does not import JAX: it takes the tree as nested dicts of
numpy arrays (`jax.tree.map(np.asarray, params)`). Reading the reference's
released `.pt` files later composes `vspbfr_tpu/convert/torch_import.py`'s
key maps with this one.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LIST_ENTRY = re.compile(r"^(.+)_(\d+)$")


def port_key(path: tuple[str, ...]) -> str:
    """Flax path -> port state_dict key."""
    parts = []
    for p in path:
        m = _LIST_ENTRY.match(p)
        parts += [m.group(1), m.group(2)] if m else [p]
    return ".".join(parts)


def _flatten(tree: Mapping[str, Any], prefix=()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def state_dict_from_jax(flax_params: Mapping[str, Any],
                        module: torch.nn.Module | None = None
                        ) -> dict[str, torch.Tensor]:
    """Rename and cast a flax parameter tree into a port state_dict.

    With `module`, the result is checked against it: every flax leaf must
    name a port parameter of the same shape, and every port parameter must
    be filled; any mismatch raises. Tensors are cast to the module's
    parameter dtypes (float32 without a module)."""
    sd = {port_key(path): torch.as_tensor(np.array(v, dtype=np.float32))
          for path, v in _flatten(flax_params).items()}
    if module is None:
        return sd
    want = module.state_dict()
    unused = sorted(set(sd) - set(want))
    unfilled = sorted(set(want) - set(sd))
    if unused or unfilled:
        raise KeyError(f"flax leaves with no port parameter: {unused}; "
                       f"port parameters with no flax leaf: {unfilled}")
    for k, t in want.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: flax shape {tuple(sd[k].shape)}, port "
                             f"shape {tuple(t.shape)}")
        sd[k] = sd[k].to(t.dtype)
    return sd
