"""Data-parallel training over `torch.distributed` (counterpart of the
data-parallel part of `vspbfr_tpu/parallel`)."""

from vspbfr_tpu_torch.parallel.mesh import (
    DataParallel,
    distributed,
    local_batch_slice,
    maybe_initialize_distributed,
    process_barrier,
)

__all__ = [
    "DataParallel",
    "distributed",
    "local_batch_slice",
    "maybe_initialize_distributed",
    "process_barrier",
]
