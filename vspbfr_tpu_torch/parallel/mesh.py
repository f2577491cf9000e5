"""Data parallelism over `torch.distributed`: the port's counterpart of the
data-parallel part of `vspbfr_tpu/parallel/mesh.py` (the reference's DDP /
NCCL runtime, `restoration_train.py:344-373,430-445` upstream).

The JAX package replicates the parameters over a "data" mesh axis, shards
the batch over it and lets XLA insert the gradient all-reduce into the one
whole-graph gradient of the step. Here each rank is one process holding
one replica; `DataParallel` broadcasts rank 0's weights at the start and
all-reduces the gradients inside `TrainState.apply_gradients`, where XLA
puts it. `torch.nn.parallel.DistributedDataParallel` is not used: stage
3's R1 is a double backward and its forwards are rematerialised through
the non-reentrant `checkpoint`, which DDP's reducer hooks do not support
well, and the JAX package has no `find_unused_parameters` either.

The reference's `distributed.py` surface maps to:

  get_rank / get_world_size  -> DataParallel.rank / .world_size
  synchronize                -> process_barrier
  reduce_sum                 -> DataParallel.sum_ (ADA's statistics)
  reduce_loss_dict           -> DataParallel.mean_metrics
  DistributedSampler         -> local_batch_slice, the loaders' shard_index

The 2-D part of the JAX module (`create_mesh_2d`, `replicated`,
`batch_sharded`, `spatial_sharded`, `model_param_specs`) is here too, over
`torch.distributed.device_mesh`: the mesh's sub-groups are the "data" and
"model" process groups, and the placements are `torch.distributed.tensor`'s
`Replicate()` / `Shard(dim)`, one per mesh axis, as `PartitionSpec`s are.
XLA inserts the collectives those annotations imply; here two modules run
them by hand: `parallel/spatial.py` (H-sharded activations with halo
exchanges, what GSPMD lowers `spatial_sharded` convs to) and
`parallel/model_axis.py` (weights sharded at rest on their last axis and
gathered at use, `model_param_specs`). On a 2-D mesh `DataParallel` reduces
over the data axis only: the ranks of one model group take the same batch
rows, and their gradients are whole and equal before it runs. Where the
model axis also shards the maps' rows (`spatial.py`) a rank's gradient of
a replicated tensor is only its rows' part; the model axis sums those
parts first (`Spatial.summed`, `Spatial.sum_partial_grads`, the
reduce-scatter of `model_axis.partial_gradients`), as GSPMD does.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterable, Mapping

import torch
import torch.distributed as dist

# torchrun's rendezvous variables; all or none must be set
ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def maybe_initialize_distributed(device="cuda") -> torch.device:
    """Join the process group torchrun describes in the environment and
    return this rank's device; without that environment, return `device`.

    The group is made at world size 1 too, so one card runs NCCL's path.
    Backend: NCCL when `device` is CUDA and every local rank has a card of
    its own (the rank then takes cuda:LOCAL_RANK); gloo on the CPU, and
    when ranks share a card, which NCCL refuses. A failed rendezvous
    raises after `DEFAULT_TIMEOUT`, which also bounds every collective;
    nothing carries on alone."""
    device = torch.device(device)
    present = [k for k in ENV_KEYS if k in os.environ]
    if not present:
        return device
    if len(present) < len(ENV_KEYS):
        raise RuntimeError(f"incomplete rendezvous environment: {present} "
                           f"set, {sorted(set(ENV_KEYS) - set(present))} "
                           "missing")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo"
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        backend = "nccl"
        device = torch.device("cuda", local_rank)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank,
                                timeout=DEFAULT_TIMEOUT)
    print(f"[dist] rank {rank} of {world}: backend {_backend()}, device "
          f"{device}", flush=True)
    return device


@contextlib.contextmanager
def distributed(device="cuda"):
    """`maybe_initialize_distributed` for the length of a block: yields
    the rank's device, and leaves at the end the group it joined."""
    made = not dist.is_initialized()
    rank_device = maybe_initialize_distributed(device)
    try:
        yield rank_device
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def process_barrier(name: str = "barrier",
                    timeout: datetime.timedelta | None = None) -> None:
    """Wait for every rank (the reference's `distributed.synchronize()`);
    gloo's monitored barrier names the rank that does not arrive. A no-op
    without a group."""
    backend = _backend()
    if backend is None:
        return
    try:
        if backend == "gloo":
            dist.monitored_barrier(timeout=timeout or DEFAULT_TIMEOUT)
        else:
            dist.barrier(device_ids=[torch.cuda.current_device()])
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


def local_batch_slice(global_batch: int, index: int | None = None,
                      count: int | None = None) -> slice:
    """This rank's rows of a global batch (DistributedSampler's share)."""
    if index is None:
        index = dist.get_rank() if dist.is_initialized() else 0
    if count is None:
        count = dist.get_world_size() if dist.is_initialized() else 1
    per = global_batch // count
    return slice(index * per, (index + 1) * per)


def create_mesh_2d(n_data: int, n_model: int,
                   axes: tuple[str, str] = ("data", "model")):
    """The 2-D (data x model) `DeviceMesh` over the process group that
    `maybe_initialize_distributed` joined (`create_mesh_2d`, mesh.py:85):
    rank = data index * n_model + model index, so a model group is
    n_model consecutive ranks (the JAX mesh's row-major reshape). Its
    sub-groups take the group's backend (gloo when ranks share a card);
    a rendezvous that fails raises within `DEFAULT_TIMEOUT`."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh_2d needs the process group "
                           "(maybe_initialize_distributed)")
    if n_data * n_model != dist.get_world_size():
        raise ValueError(f"mesh {n_data} x {n_model} for "
                         f"{dist.get_world_size()} ranks")
    device_type = "cuda" if _backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along a named mesh axis (1 if the mesh has no
    such axis)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def _placements(mesh, dims: dict) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[n]) if n in dims else Replicate()
                 for n in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    """`Replicate()` on every mesh axis (`P()`)."""
    return _placements(mesh, {})


def batch_sharded(mesh, axis: str = "data") -> tuple:
    """The leading (batch) dim sharded over `axis` (`P(axis)`)."""
    return _placements(mesh, {axis: 0})


def spatial_sharded(mesh, axis: str = "model",
                    batch_axis: str | None = "data") -> tuple:
    """NHWC activations sharded over H along `axis` and, where the mesh has
    it, over the batch along `batch_axis` (`P(batch_axis, axis)`). The
    per-shard convs and their halo exchanges are `parallel/spatial.py`."""
    dims = {axis: 1}
    if batch_axis is not None and batch_axis in mesh.mesh_dim_names:
        dims[batch_axis] = 0
    return _placements(mesh, dims)


def model_param_specs(module_or_state_dict, mesh, axis: str = "model",
                      min_size: int = 256) -> dict:
    """Megatron-style weight sharding (`model_param_specs`, mesh.py:118):
    name -> placements. A tensor of at least 2 dims whose last axis is at
    least `min_size` and divides over `axis` is sharded on that last axis
    (conv Co, linear out-features: the port's layouts are flax's, HWIO and
    (in, out), so it is the same axis of the same parameters); everything
    else (biases, styles, small heads) is replicated. A module's
    parameters, or every entry of a state_dict (optimizer moments mirror
    their parameters' shapes)."""
    n = axis_size(mesh, axis)
    items = (module_or_state_dict.named_parameters()
             if isinstance(module_or_state_dict, torch.nn.Module)
             else module_or_state_dict.items())
    out = {}
    for name, t in items:
        shape = tuple(t.shape)
        if len(shape) >= 2 and shape[-1] >= min_size and shape[-1] % n == 0:
            out[name] = _placements(mesh, {axis: len(shape) - 1})
        else:
            out[name] = replicated(mesh)
    return out


def _staged(t: torch.Tensor, group=None) -> torch.Tensor:
    """t where `group`'s collectives take it: under gloo a CUDA tensor goes
    through a host copy (which the caller copies back where the collective
    works in place), otherwise t itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


class AxisGroup:
    """One rank's place on a mesh axis: the axis' process group, the
    rank's index on it and the axis' size, and the collectives that
    `parallel/spatial.py` and `parallel/model_axis.py` exchange through:
    the all-gather of activations and weights, and the gradients' sum
    and reduce-scatter (under gloo a CUDA tensor goes through a host copy,
    as `DataParallel` reduces; a collective that fails raises within the
    group's timeout)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def of(cls, mesh, axis: str):
        return cls(mesh.get_group(axis), mesh.get_local_rank(axis),
                   axis_size(mesh, axis))

    def _wire(self, t: torch.Tensor, sums: bool = False) -> torch.Tensor:
        """t as it goes over the group (`_staged`); summed tensors in f32
        (a bf16 gradient's parts add without rounding)."""
        src = t.detach()
        if sums and src.dtype in (torch.bfloat16, torch.float16):
            src = src.float()
        return _staged(src, self.group).contiguous()

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's t (equal shapes), in rank order, on t's device."""
        src = self._wire(t)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(t.device) for p in parts]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's t, a new tensor like t."""
        src = self._wire(t, sums=True)
        if src.data_ptr() == t.data_ptr():
            src = src.clone()       # t's own storage stays untouched
        dist.all_reduce(src, group=self.group)
        return src.to(t.device, t.dtype)

    def reduce_scatter_last(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last axis (columns [r k, (r + 1) k)) of
        the sum of every rank's t."""
        src = self._wire(t, sums=True)
        k = src.shape[-1] // self.size
        parts = [src.narrow(-1, r * k, k).contiguous()
                 for r in range(self.size)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self.group)
        return out.to(t.device, t.dtype)


def _buckets(tensors: Iterable[torch.Tensor]) -> dict:
    """The tensors grouped by dtype, in order."""
    out: dict = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


@torch.no_grad()
def flat_collective(tensors: Iterable[torch.Tensor], fn) -> None:
    """One collective a dtype over many tensors: each dtype's tensors
    flattened into one (`_buckets`), `fn(flat)` (the collective: it
    returns the result, or flat changed in place), and each tensor set to
    its part of the result."""
    for group in _buckets(tensors).values():
        flat = fn(torch.cat([t.reshape(-1) for t in group]))
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


class DataParallel:
    """One replica per rank of the default process group, or with a 2-D
    `mesh` per rank of its data axis: rank and world size along that axis,
    the lead rank (global rank 0 writes logs, samples and checkpoints) and
    the collectives of a data-parallel step, over the data sub-group only:
    the ranks of one model group take the same batch rows, and by the time
    `all_reduce_grads` runs their gradients are whole and equal (a step
    that H-shards the maps sums each replicated tensor's row parts over
    the model axis first, `parallel/spatial.py`). Without a group every
    method is the identity and the world size is 1."""

    def __init__(self, mesh=None):
        self.backend = _backend()
        self.group = None
        self.rank = dist.get_rank() if self.backend else 0
        self.world_size = dist.get_world_size() if self.backend else 1
        self.is_lead = self.rank == 0
        if mesh is not None and self.backend:
            data = AxisGroup.of(mesh, "data")
            self.group, self.rank, self.world_size = (data.group, data.rank,
                                                      data.size)

    def local_rows(self, global_batch: int) -> slice:
        return local_batch_slice(global_batch, self.rank, self.world_size)

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                    group=None) -> None:
        """In place, over the data group (or `group`); gloo reduces CUDA
        tensors through a host copy."""
        group = group or self.group
        wire = _staged(t, group)
        dist.all_reduce(wire, op, group=group)
        if wire is not t:
            t.copy_(wire)

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """t <- the data group's first rank's t, in place; returns t."""
        src = 0 if self.group is None else dist.get_global_rank(self.group,
                                                                0)
        wire = _staged(t, self.group)
        dist.broadcast(wire, src, group=self.group)
        if wire is not t:
            t.copy_(wire)
        return t

    @torch.no_grad()
    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Give every rank its data group's first rank's parameters and
        buffers (DDP's start; the JAX package requires equal values on
        every process). The tensors themselves, so a model-sharded
        parameter's slice is what goes (its data group holds the same
        slice)."""
        if self.backend:
            flat_collective(list(module.parameters())
                            + list(module.buffers()), self._broadcast)
        return module

    @torch.no_grad()
    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """`.grad` <- its mean over the ranks: one flattened all-reduce per
        dtype. Every parameter must have a gradient."""
        if not self.backend:
            return

        def mean(flat):
            self._all_reduce(flat)
            return flat.div_(self.world_size)

        flat_collective([p.grad for p in params], mean)

    def mean_metrics(self, metrics: Mapping[str, torch.Tensor]) -> dict:
        """The 0-d metrics averaged over the ranks in one all-reduce (the
        JAX step's metrics are global means)."""
        if not self.backend:
            return dict(metrics)
        keys = list(metrics)
        flat = torch.stack([torch.as_tensor(metrics[k]).float()
                            for k in keys])
        self._all_reduce(flat)
        flat /= self.world_size
        return dict(zip(keys, flat.unbind()))

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks (a new tensor)."""
        t = t.clone()
        if self.backend:
            self._all_reduce(t)
        return t

    def any_(self, flag: bool, device) -> bool:
        """True if any rank of the world passed True (a stop request: every
        rank stops at the same iteration, none waits in a collective
        alone)."""
        if not self.backend:
            return bool(flag)
        t = torch.tensor([int(flag)], device=device)
        self._all_reduce(t, dist.ReduceOp.MAX, group=dist.group.WORLD)
        return bool(t.item())
