"""Checkpoint save and load with `torch.save`.

Counterpart of `vspbfr_tpu/utils/checkpoint.py` (orbax there). A
checkpoint is one file holding a nested dict of tensors and plain Python
values (state_dicts, optimizer state, counters, RNG state). A save writes
a temporary file beside the target and renames it over the target, so a
reader never sees half a checkpoint; like the reference, a fixed name is
overwritten. A model-sharded module's `state_dict()` (`parallel/
model_axis.py`) and `TrainState.state_dict()` already hold the full
tensors, so a checkpoint is the same file sharded or not.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` to the file `path`, atomically. A write that fails (a
    full disk) leaves neither a partial file nor its temporary behind."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    try:
        torch.save(tree, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path: str, map_location="cpu") -> Any:
    """Read a checkpoint written by `save_checkpoint` (tensors and plain
    values only: weights_only)."""
    return torch.load(path, map_location=map_location, weights_only=True)
