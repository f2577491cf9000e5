"""upfirdn2d: upsample -> FIR filter -> downsample -> crop, NHWC.

Counterpart of `vspbfr_tpu/ops/upfirdn2d.py`. The JAX package runs these
in XLA (no Pallas), so the port runs them as plain torch: zero-insertion,
`F.pad` (negative pads crop) and a depthwise `F.conv2d` with the flipped
kernel, computed in float32 and cast back, as the JAX functions do.
Semantics follow the reference `upfirdn2d_native`, including its trailing
(up - 1) zeros.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_resample_kernel(k) -> torch.Tensor:
    """Normalized 2D FIR kernel from 1D taps (outer product) or a 2D kernel."""
    k = torch.as_tensor(np.asarray(k, np.float32))
    if k.ndim == 1:
        k = torch.outer(k, k)
    return k / k.sum()


def _normalize_pad(pad) -> tuple[int, int, int, int]:
    """(pad_x0, pad_x1, pad_y0, pad_y1) from a 2- or 4-tuple."""
    pad = tuple(int(p) for p in pad)
    if len(pad) == 2:
        return pad[0], pad[1], pad[0], pad[1]
    if len(pad) == 4:
        return pad
    raise ValueError(f"pad must have 2 or 4 elements, got {pad}")


def _upfirdn_nchw(x: torch.Tensor, kernel: torch.Tensor, up: tuple, down: tuple,
                  pads: tuple) -> torch.Tensor:
    """One upfirdn pass on an f32 NCHW tensor with a (kh, kw) kernel."""
    b, c, h, w = x.shape
    uy, ux = up
    if uy > 1 or ux > 1:
        z = x.new_zeros((b, c, h * uy, w * ux))
        z[:, :, ::uy, ::ux] = x
        x = z
    x = F.pad(x, pads)
    k = torch.flip(kernel, (0, 1)).to(x)
    k = k[None, None].expand(c, 1, *k.shape)
    out = F.conv2d(x, k, groups=c)
    return out[:, :, ::down[0], ::down[1]]


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """upfirdn on (B, H, W, C) with a (kh, kw) kernel applied as true
    convolution; pad (p0, p1) or (x0, x1, y0, y1), negative values crop."""
    px0, px1, py0, py1 = _normalize_pad(pad)
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    xn = x.permute(0, 3, 1, 2).float()
    out = _upfirdn_nchw(xn, kernel, (up, up), (down, down),
                        (px0, px1, py0, py1))
    return out.permute(0, 2, 3, 1).to(x.dtype)


def upfirdn2d_separable(x: torch.Tensor, taps, up: int = 1, down: int = 1,
                        pad=(0, 0), gain: float = 1.0) -> torch.Tensor:
    """upfirdn with the separable kernel outer(taps, taps) / sum(taps)^2 *
    gain, as two 1D passes (rows, then columns)."""
    taps = [float(t) for t in taps]
    s = sum(taps)
    t1 = torch.tensor([t / s * gain ** 0.5 for t in taps], dtype=torch.float32)
    px0, px1, py0, py1 = _normalize_pad(pad)
    xn = x.permute(0, 3, 1, 2).float()
    out = _upfirdn_nchw(xn, t1[:, None], (up, 1), (down, 1), (0, 0, py0, py1))
    out = _upfirdn_nchw(out, t1[None, :], (1, up), (1, down), (px0, px1, 0, 0))
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _is_static_taps(kernel) -> bool:
    return isinstance(kernel, (tuple, list)) or (
        isinstance(kernel, np.ndarray) and kernel.ndim == 1)


def upsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """factor-x upsample with FIR smoothing (`models/RestoreNet.py:43-60`)."""
    k = len(kernel) if _is_static_taps(kernel) else kernel.shape[0]
    p = k - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2)
    if _is_static_taps(kernel):
        return upfirdn2d_separable(x, kernel, up=factor, pad=pad,
                                   gain=float(factor ** 2))
    return upfirdn2d(x, kernel * factor ** 2, up=factor, pad=pad)


def downsample2d(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """FIR anti-aliased downsample (`models/RestoreNet.py:63-81`)."""
    k = len(kernel) if _is_static_taps(kernel) else kernel.shape[0]
    p = k - factor
    pad = ((p + 1) // 2, p // 2)
    if _is_static_taps(kernel):
        return upfirdn2d_separable(x, kernel, down=factor, pad=pad)
    return upfirdn2d(x, kernel, down=factor, pad=pad)


def blur(x: torch.Tensor, kernel, pad: tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """Plain FIR blur with explicit pad (`models/RestoreNet.py:84-101`)."""
    if _is_static_taps(kernel):
        return upfirdn2d_separable(x, kernel, pad=pad,
                                   gain=float(upsample_factor ** 2))
    if upsample_factor > 1:
        kernel = kernel * upsample_factor ** 2
    return upfirdn2d(x, kernel, pad=pad)
