"""Phase interleave (grouped depth-to-space): kernel K3 and its plain
version.

Counterpart of `vspbfr_tpu/ops/pallas_d2s.py` (`interleave_d2s`, the
Pallas `_d2s_pallas`):

    y[b, 2i+gy, 2j+gx, c] = x[b, i, j, (2*gy+gx)*inner + c]

The CUDA source is `csrc/d2s.cu`. The inverse (`gather_s2d`, its VJP) waits
for the training path.
"""

from __future__ import annotations

import torch

from vspbfr_tpu_torch.ops import _build


def d2s_plain(x: torch.Tensor, inner: int) -> torch.Tensor:
    """What K3 computes, in plain torch (`_d2s_xla`, pallas_d2s.py:60)."""
    b, h, w, _ = x.shape
    o = x.reshape(b, h, w, 2, 2, inner).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, 2 * h, 2 * w, inner)


def d2s(x: torch.Tensor, inner: int) -> torch.Tensor:
    """(B, h, w, 4*inner) phase groups (gy, gx, inner) -> (B, 2h, 2w, inner)."""
    b, h, w, c4 = x.shape
    if c4 != 4 * inner:
        raise ValueError(f"d2s: {c4} channels, inner {inner}")
    if x.device.type == "cpu":
        return d2s_plain(x, inner)
    if x.device.type != "cuda":
        raise ValueError(f"d2s: no kernel for device {x.device}")
    _build.check_cuda_inputs("d2s", x)
    y = torch.empty((b, 2 * h, 2 * w, inner), dtype=x.dtype, device=x.device)
    inner_bytes = inner * x.element_size()
    unit = next(u for u in (16, 8, 4, 2, 1)
                if inner_bytes % u == 0 and x.data_ptr() % u == 0
                and y.data_ptr() % u == 0)
    if unit < 2:
        raise ValueError(f"d2s: inner of {inner_bytes} bytes is not a "
                         "multiple of 2")
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_d2s", x.data_ptr(), y.data_ptr(), b, h, w,
                 inner_bytes, unit, _build.stream_of(x))
    d2s.launches += 1
    return y


d2s.launches = 0
