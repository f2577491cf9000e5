"""Parallelism over `torch.distributed` (counterpart of
`vspbfr_tpu/parallel`): data parallelism, the 2-D data x model mesh and its
placements (`mesh.py`), H-sharded conv stages with halo exchanges
(`spatial.py`) and model-axis weight sharding (`model_axis.py`)."""

from vspbfr_tpu_torch.parallel.mesh import (
    DataParallel,
    batch_sharded,
    create_mesh_2d,
    distributed,
    local_batch_slice,
    maybe_initialize_distributed,
    model_param_specs,
    process_barrier,
    replicated,
    spatial_sharded,
)
from vspbfr_tpu_torch.parallel.model_axis import shard_module
from vspbfr_tpu_torch.parallel.spatial import MIN_ROWS, Spatial

__all__ = [
    "DataParallel",
    "MIN_ROWS",
    "Spatial",
    "batch_sharded",
    "create_mesh_2d",
    "distributed",
    "local_batch_slice",
    "maybe_initialize_distributed",
    "model_param_specs",
    "process_barrier",
    "replicated",
    "shard_module",
    "spatial_sharded",
]
