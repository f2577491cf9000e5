"""Phase interleave (grouped depth-to-space, kernel K3) and its inverse, the
phase gather (grouped space-to-depth, kernel K4), each beside its plain
version.

Counterpart of `vspbfr_tpu/ops/pallas_d2s.py` (`interleave_d2s` with the
Pallas `_d2s_pallas`; `gather_s2d` with `_s2d_pallas`):

    y[b, 2i+gy, 2j+gx, c] = x[b, i, j, (2*gy+gx)*inner + c]     (d2s)

and s2d its inverse. The CUDA sources are `csrc/d2s.cu` and `csrc/s2d.cu`.
As in the JAX package (`pallas_d2s.py:153-182`) each is the other's
gradient: `d2s` and `s2d` are `torch.autograd.Function`s whose backward
calls the other, so a permutation's gradient (and its gradient's gradient)
runs on the card's kernels too.
"""

from __future__ import annotations

import torch

from vspbfr_tpu_torch.ops import _build


def d2s_plain(x: torch.Tensor, inner: int) -> torch.Tensor:
    """What K3 computes, in plain torch (`_d2s_xla`, pallas_d2s.py:60)."""
    b, h, w, _ = x.shape
    o = x.reshape(b, h, w, 2, 2, inner).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, 2 * h, 2 * w, inner)


def s2d_plain(y: torch.Tensor, inner: int) -> torch.Tensor:
    """What K4 computes, in plain torch (`_s2d_xla`, pallas_d2s.py:67)."""
    b, h2, w2, _ = y.shape
    o = y.reshape(b, h2 // 2, 2, w2 // 2, 2, inner).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, h2 // 2, w2 // 2, 4 * inner)


def unit_bytes(name: str, x: torch.Tensor, y: torch.Tensor,
               inner_bytes: int) -> int:
    """The widest unit (16, 8, 4 or 2 bytes) that inner's bytes and both
    pointers allow; a permutation kernel moves opaque units of it."""
    unit = next(u for u in (16, 8, 4, 2, 1)
                if inner_bytes % u == 0 and x.data_ptr() % u == 0
                and y.data_ptr() % u == 0)
    if unit < 2:
        raise ValueError(f"{name}: inner of {inner_bytes} bytes is not a "
                         "multiple of 2")
    return unit


def _launch(name: str, x: torch.Tensor, out_shape, h: int, w: int,
            inner: int) -> torch.Tensor:
    """Launch vspbfr_<name> on the grid (h, w) of 2x2 phase groups, moving
    the widest unit that inner's bytes and both pointers allow."""
    _build.check_cuda_inputs(name, x)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    inner_bytes = inner * x.element_size()
    unit = unit_bytes(name, x, y, inner_bytes)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call(f"vspbfr_{name}", x.data_ptr(), y.data_ptr(), x.shape[0], h,
                 w, inner_bytes, unit, _build.stream_of(x))
    return y


def _d2s_forward(x: torch.Tensor, inner: int) -> torch.Tensor:
    b, h, w, c4 = x.shape
    if c4 != 4 * inner:
        raise ValueError(f"d2s: {c4} channels, inner {inner}")
    if x.device.type == "cpu":
        return d2s_plain(x, inner)
    if x.device.type != "cuda":
        raise ValueError(f"d2s: no kernel for device {x.device}")
    y = _launch("d2s", x, (b, 2 * h, 2 * w, inner), h, w, inner)
    d2s.launches += 1
    return y


def _s2d_forward(y: torch.Tensor, inner: int) -> torch.Tensor:
    b, h2, w2, c = y.shape
    if c != inner or h2 % 2 or w2 % 2:
        raise ValueError(f"s2d: shape {tuple(y.shape)}, inner {inner}")
    if y.device.type == "cpu":
        return s2d_plain(y, inner)
    if y.device.type != "cuda":
        raise ValueError(f"s2d: no kernel for device {y.device}")
    x = _launch("s2d", y, (b, h2 // 2, w2 // 2, 4 * inner), h2 // 2, w2 // 2,
                inner)
    s2d.launches += 1
    return x


class _D2S(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inner):
        ctx.inner = inner
        return _d2s_forward(x, inner)

    @staticmethod
    def backward(ctx, g):
        return s2d(g.contiguous(), ctx.inner), None


class _S2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, inner):
        ctx.inner = inner
        return _s2d_forward(y, inner)

    @staticmethod
    def backward(ctx, g):
        return d2s(g.contiguous(), ctx.inner), None


def d2s(x: torch.Tensor, inner: int) -> torch.Tensor:
    """(B, h, w, 4*inner) phase groups (gy, gx, inner) -> (B, 2h, 2w, inner).
    Its gradient is `s2d`."""
    return _D2S.apply(x, int(inner))


def s2d(y: torch.Tensor, inner: int) -> torch.Tensor:
    """Inverse of `d2s`: (B, 2h, 2w, inner) -> (B, h, w, 4*inner). Its
    gradient is `d2s`."""
    return _S2D.apply(y, int(inner))


d2s.launches = 0
s2d.launches = 0
