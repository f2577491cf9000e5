"""Model-axis weight sharding: parameters sharded at rest on their last
axis, gathered at use.

The JAX package places a parameter tree with `model_param_specs` and lets
GSPMD insert the all-gathers ("weights stay sharded at rest, GSPMD inserts
the gathers", `vspbfr_tpu/parallel/mesh.py:118`). Here `shard_module`
applies the same rule (`parallel.mesh.model_param_specs`) to a module:
each parameter it shards keeps only its 1/n_model slice of the last axis
(the slice of model rank r is columns [r k, (r + 1) k)), and a
`torch.nn.utils.parametrize` parametrization gathers the full tensor
within the model group wherever the module reads it. The gather is a
`torch.autograd.Function` whose backward returns the local slice of the
full gradient. Where the module runs on whole maps every rank of a model
group computes the same full gradient, so the slice is all it needs, and
the data axis reduces it as any other (`DataParallel`); that backward is a
`narrow`, so a double backward (R1 through D) runs through it. Where a
layer runs on this rank's rows of H-sharded maps (`parallel/spatial.py`,
`Spatial.layer`, inside `partial_gradients`) each rank's gradient is only
its rows' part: the gather's backward then reduce-scatters the parts, so
each rank gets its slice of their sum (once differentiable: no double
backward crosses a sharded map).

So an optimizer over the module's parameters (`train.state.TrainState`)
keeps Adam's moments at the slice's size: the memory `model_param_specs`
is for. A checkpoint is the same file sharded or not: `state_dict()` of a
sharded module gathers each sharded tensor under its own name, in the
unsharded order, and `load_state_dict` takes full tensors and keeps each
rank's slice. Both are collective over the model group: every rank of
the group calls them together.

The gathers go through `parallel.mesh.AxisGroup.all_gather` (a host
copy under gloo; a failed gather raises within the group's timeout).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn.utils import parametrize

from vspbfr_tpu_torch.parallel.mesh import AxisGroup, model_param_specs


class ModelAxis(AxisGroup):
    """The model axis of a mesh: its slice of a last axis and the gather
    of the slices."""

    def __init__(self, group, rank: int, size: int):
        super().__init__(group, rank, size)
        self.reduce_scatters = 0    # row parts of a gradient summed

    def __deepcopy__(self, memo):
        return self     # a copy of a sharded module gathers on the same axis

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last axis."""
        k = full.shape[-1] // self.size
        return full.narrow(-1, self.rank * k, k)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's slice, concatenated on the
        last axis (not differentiable: `GatheredAtUse`'s gather is)."""
        return torch.cat(self.all_gather(local), dim=-1)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axis):
        ctx.axis = axis
        return axis.gather(local)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.local(g), None


class _GatherLastPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axis):
        ctx.axis = axis
        return axis.gather(local)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ctx.axis.reduce_scatters += 1
        return ctx.axis.reduce_scatter_last(g), None


class GatheredAtUse(nn.Module):
    """The parametrization of a model-sharded parameter: the stored tensor
    is the rank's slice (`right_inverse` slices a full tensor assigned to
    it), what the module reads is the gathered full tensor. Its gradient
    is the slice of the full tensor's gradient; while `partial` (set by
    `partial_gradients`), of the sum of the ranks' parts."""

    def __init__(self, axis: ModelAxis):
        super().__init__()
        self.axis = axis
        self.partial = False

    def forward(self, local):
        gather = _GatherLastPartial if self.partial else _GatherLast
        return gather.apply(local, self.axis)

    def right_inverse(self, full):
        return self.axis.local(full).contiguous()


@contextlib.contextmanager
def partial_gradients(layer: nn.Module):
    """Within the block, each model-sharded parameter that `layer` reads
    gets only this rank's part of its gradient (a layer on H-sharded rows,
    `Spatial.layer`): its gather's backward reduce-scatters the parts over
    the model axis. The gathers made in the block keep that backward, and
    a checkpoint's recompute runs the block again."""
    gathers = [m for m in layer.modules() if isinstance(m, GatheredAtUse)]
    before = [g.partial for g in gathers]
    for g in gathers:
        g.partial = True
    try:
        yield
    finally:
        for g, b in zip(gathers, before):
            g.partial = b


def _owner(root: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (root.get_submodule(path) if path else root), leaf


def _original(owner: nn.Module, leaf: str) -> str:
    return f"parametrizations.{leaf}.original"


def _state_dict_post_hook(axis, order, sharded):
    """Put the owner's sharded tensors back under their own names, full,
    and its keys in the unsharded order. When the owner's hook runs its
    keys are the last block of the dict, so re-inserting them keeps the
    whole dict's order."""
    def hook(module, state_dict, prefix, local_metadata):
        block = {}
        for k in [k for k in state_dict if k.startswith(prefix)]:
            block[k[len(prefix):]] = state_dict.pop(k)
        for leaf in sharded:
            block[leaf] = axis.gather(block.pop(_original(module, leaf)))
        for k in order:
            state_dict[prefix + k] = block.pop(k)
        for k, v in block.items():
            state_dict[prefix + k] = v
        meta = getattr(state_dict, "_metadata", None)
        if meta is not None:     # the parametrization modules' versions
            for k in [k for k in meta
                      if k.startswith(prefix + "parametrizations")]:
                del meta[k]
    return hook


def _load_pre_hook(axis, sharded):
    """A full tensor under its own name -> this rank's slice under the
    parametrization's key."""
    def hook(module, state_dict, prefix, *args):
        for leaf in sharded:
            full = state_dict.pop(prefix + leaf, None)
            if full is not None:
                state_dict[prefix + _original(module, leaf)] = (
                    axis.local(full).contiguous())
    return hook


def shard_module(module: nn.Module, mesh) -> nn.Module:
    """Shard `module`'s parameters in place over the mesh's "model" axis
    by `model_param_specs(module, mesh)`: each sharded one keeps its
    rank's slice and is gathered at use. Call it after the weights are set
    (an init that writes into a parameter would write into a gathered
    copy). Returns the module; `sharded_names(module)` lists what was
    sharded."""
    if getattr(module, "_model_axis", None) is not None:
        raise ValueError("module is already model-sharded")
    specs = model_param_specs(module, mesh)
    names = [n for n, _ in module.named_parameters()]
    sharded = [n for n in names if any(p.is_shard() for p in specs[n])]
    ax = ModelAxis.of(mesh, "model")
    owners: dict = {}
    for name in sharded:
        owner, leaf = _owner(module, name)
        owners.setdefault(id(owner), (owner, []))[1].append(leaf)
    for owner, leaves in owners.values():
        # the owner's own keys (not its children's) in the unsharded order
        order = [k for k in owner.state_dict() if "." not in k]
        for leaf in leaves:
            parametrize.register_parametrization(owner, leaf,
                                                 GatheredAtUse(ax),
                                                 unsafe=True)
        owner.register_state_dict_post_hook(
            _state_dict_post_hook(ax, order, tuple(leaves)))
        owner.register_load_state_dict_pre_hook(
            _load_pre_hook(ax, tuple(leaves)))
    module._model_axis = dict(axis=ax, names=names, sharded=sharded)
    return module


def sharded_names(module: nn.Module) -> list[str]:
    """The parameter names `shard_module` sharded (empty if none)."""
    info = getattr(module, "_model_axis", None)
    return list(info["sharded"]) if info else []


def model_axis(module: nn.Module) -> ModelAxis | None:
    info = getattr(module, "_model_axis", None)
    return info["axis"] if info else None


def parameters_in_order(module: nn.Module) -> list[nn.Parameter]:
    """The stored parameters (a sharded one's slice) in the order of the
    unsharded module's `parameters()`, so an optimizer's state indexes
    them as it would unsharded."""
    info = getattr(module, "_model_axis", None)
    if info is None:
        return list(module.parameters())
    out = []
    for name in info["names"]:
        if name in info["sharded"]:
            owner, leaf = _owner(module, name)
            out.append(getattr(owner.parametrizations, leaf).original)
        else:
            out.append(module.get_parameter(name))
    return out
