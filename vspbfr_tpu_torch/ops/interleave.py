"""Two more forms of the phase interleave (kernel K8), beside their plain
version.

Counterpart of `scripts/exp_interleave.py` (the Pallas `_pallas_call` with
its bodies `pallas_stack` and `pallas_repeat`), the TPU experiment that
compared forms of K3's permutation

    y[b, 2i+gy, 2j+gx, c] = x[b, i, j, (2*gy+gx)*inner + c].

Both forms compute exactly what `ops.d2s` (K3) computes, so their plain
version is `d2s_plain`. The CUDA source is `csrc/interleave.cu`:

- `interleave_stack` stages 4 input rows (the script's h_t) at a time, a
  chunk of columns per block, in shared memory and writes each input
  row's two output rows as contiguous streams;
- `interleave_repeat` gives each output unit one thread, which picks its
  source phase by the output column's parity.

Neither calls K3's kernel. The scripts' kernel has no gradient, and neither
has these. No product path calls them: `python -m
vspbfr_tpu_torch.cli.profile --interleave` measures them against K3.
"""

from __future__ import annotations

import torch

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.d2s import d2s_plain, unit_bytes

MAX_INNER_BYTES = 48 * 1024   # one staged column of 4 phases fits the SM


def _check(name: str, x: torch.Tensor, inner: int) -> None:
    if x.dim() != 4 or x.shape[3] != 4 * inner or inner < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, inner {inner}")
    if inner * x.element_size() > MAX_INNER_BYTES:
        raise ValueError(f"{name}: inner of {inner * x.element_size()} bytes "
                         f"exceeds {MAX_INNER_BYTES}")


def _launch(name: str, x: torch.Tensor, inner: int) -> torch.Tensor:
    _build.check_cuda_inputs(name, x)
    b, h, w, _ = x.shape
    y = torch.empty((b, 2 * h, 2 * w, inner), dtype=x.dtype, device=x.device)
    inner_bytes = inner * x.element_size()
    unit = unit_bytes(name, x, y, inner_bytes)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call(f"vspbfr_{name}", x.data_ptr(), y.data_ptr(), b, h, w,
                 inner_bytes, unit, _build.stream_of(x))
    return y


def interleave_stack(x: torch.Tensor, inner: int) -> torch.Tensor:
    """(B, h, w, 4*inner) phase groups (gy, gx, inner) -> (B, 2h, 2w, inner),
    a few input rows per block (`pallas_stack`'s grid step)."""
    name = "interleave_stack"
    inner = int(inner)
    _check(name, x, inner)
    if x.device.type == "cpu":
        return d2s_plain(x, inner)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    y = _launch(name, x, inner)
    interleave_stack.launches += 1
    return y


def interleave_repeat(x: torch.Tensor, inner: int) -> torch.Tensor:
    """The same permutation, one thread per output unit choosing its phase
    by column parity (`pallas_repeat`)."""
    name = "interleave_repeat"
    inner = int(inner)
    _check(name, x, inner)
    if x.device.type == "cpu":
        return d2s_plain(x, inner)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    y = _launch(name, x, inner)
    interleave_repeat.launches += 1
    return y


interleave_stack.launches = 0
interleave_repeat.launches = 0
