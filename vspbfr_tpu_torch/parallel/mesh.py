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

The 2-D, spatial and model sharding of the JAX module are not carried over.
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


def _buckets(tensors: Iterable[torch.Tensor]) -> dict:
    """The tensors grouped by dtype, in order."""
    out: dict = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


class DataParallel:
    """One replica per rank of the default process group: rank, world
    size, the lead rank (rank 0 writes logs, samples and checkpoints) and
    the collectives of a data-parallel step. Without a group every method
    is the identity and the world size is 1."""

    def __init__(self):
        self.backend = _backend()
        self.rank = dist.get_rank() if self.backend else 0
        self.world_size = dist.get_world_size() if self.backend else 1
        self.is_lead = self.rank == 0

    def local_rows(self, global_batch: int) -> slice:
        return local_batch_slice(global_batch, self.rank, self.world_size)

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        """In place; gloo reduces CUDA tensors through a host copy."""
        if self.backend == "gloo" and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, op)
            t.copy_(host)
        else:
            dist.all_reduce(t, op)

    def _broadcast(self, t: torch.Tensor) -> None:
        if self.backend == "gloo" and t.is_cuda:
            host = t.cpu()
            dist.broadcast(host, 0)
            t.copy_(host)
        else:
            dist.broadcast(t, 0)

    @torch.no_grad()
    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Give every rank rank 0's parameters and buffers (DDP's start;
        the JAX package requires equal values on every process)."""
        if self.backend:
            for group in _buckets(module.state_dict().values()).values():
                flat = torch.cat([t.reshape(-1) for t in group])
                self._broadcast(flat)
                for t, v in zip(group, flat.split([t.numel()
                                                   for t in group])):
                    t.copy_(v.view_as(t))
        return module

    @torch.no_grad()
    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """`.grad` <- its mean over the ranks: one flattened all-reduce per
        dtype. Every parameter must have a gradient."""
        if not self.backend:
            return
        grads = [p.grad for p in params]
        for group in _buckets(grads).values():
            flat = torch.cat([g.reshape(-1) for g in group])
            self._all_reduce(flat)
            flat /= self.world_size
            for g, v in zip(group, flat.split([g.numel() for g in group])):
                g.copy_(v.view_as(g))

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
        """True if any rank passed True (a stop request: every rank stops
        at the same iteration, none waits in a collective alone)."""
        if not self.backend:
            return bool(flag)
        t = torch.tensor([int(flag)], device=device)
        self._all_reduce(t, dist.ReduceOp.MAX)
        return bool(t.item())
