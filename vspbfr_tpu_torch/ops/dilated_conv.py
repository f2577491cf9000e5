"""Multi-dilation 3x3 convolution: kernel K2 and its plain version.

Counterpart of `vspbfr_tpu/ops/pallas_dilated.py` (`dilated_multi_conv`,
the Pallas `_multi_pallas`): N same-input 3x3 "same" dilated convs, outputs
concatenated on channels, with an optional (B, Ci) input scale and a
(B, sum Co) output scale. The CUDA source is `csrc/dilated_conv.cu`.

Only `groups=1` (the unpacked layout) is ported; the grouped form served
the space-to-depth layout, which the port does not carry. K2's backward
(`pallas_dilated.py:274-305`) is not ported yet (stage 3 runs it): on the
card the wrapper raises when a gradient would have to pass through it,
rather than return a result with no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc

MAX_BRANCHES = 8


def dilated_multi_conv_plain(x: torch.Tensor, ws, dils,
                             in_scale: torch.Tensor | None = None,
                             out_scale: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """What K2 computes, in plain torch (`_multi_ref`, pallas_dilated.py:253,
    groups=1)."""
    xs = x if in_scale is None else x * in_scale[:, None, None, :]
    out = torch.cat([conv_nhwc(xs, w, 1, ((d, d), (d, d)), dilation=d)
                     for w, d in zip(ws, dils)], dim=-1)
    if out_scale is not None:
        out = out * out_scale[:, None, None, :].to(out.dtype)
    return out.contiguous()


def dilated_multi_conv(x: torch.Tensor, ws, dils, groups: int = 1,
                       in_scale: torch.Tensor | None = None,
                       out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """concat_i(conv(x * in_scale, ws[i], dilation=dils[i], 'same'))
    * out_scale. x (B, H, W, Ci); ws[i] (3, 3, Ci, Co_i) in x's dtype."""
    if groups != 1:
        raise NotImplementedError(
            "dilated_multi_conv: groups > 1 served the packed layout, which "
            "is not ported")
    ws, dils = tuple(ws), tuple(int(d) for d in dils)
    if x.device.type == "cpu":
        return dilated_multi_conv_plain(x, ws, dils, in_scale, out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"dilated_multi_conv: no kernel for device {x.device}")
    name = "dilated_multi_conv"
    b, h, wd, ci = x.shape
    cos = [w.shape[3] for w in ws]
    if not 1 <= len(ws) <= MAX_BRANCHES or len(dils) != len(ws):
        raise ValueError(f"{name}: {len(ws)} weights, {len(dils)} dilations")
    if any(tuple(w.shape[:3]) != (3, 3, ci) for w in ws) or min(dils) < 1:
        raise ValueError(f"{name}: weights {[tuple(w.shape) for w in ws]}, "
                         f"dilations {dils}, Ci {ci}")
    if in_scale is not None and tuple(in_scale.shape) != (b, ci):
        raise ValueError(f"{name}: in_scale {tuple(in_scale.shape)}")
    if out_scale is not None and tuple(out_scale.shape) != (b, sum(cos)):
        raise ValueError(f"{name}: out_scale {tuple(out_scale.shape)}")
    _build.check_cuda_inputs(name, x, *ws, in_scale, out_scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, *ws, in_scale, out_scale)):
        raise RuntimeError(f"{name}: K2 has no backward yet; run it under "
                           "torch.no_grad()")
    w_all = torch.cat(ws, dim=3).contiguous()   # (3, 3, Ci, sum Co) HWIO
    y = torch.empty((b, h, wd, sum(cos)), dtype=x.dtype, device=x.device)
    c_dils = (ctypes.c_int * len(dils))(*dils)
    c_cos = (ctypes.c_int * len(cos))(*cos)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_dilated_multi_conv", x.data_ptr(), w_all.data_ptr(),
                 _build.ptr(in_scale), _build.ptr(out_scale), y.data_ptr(),
                 _build.dtype_code(x), b, h, wd, ci, len(ws), c_dils, c_cos,
                 _build.stream_of(x))
    dilated_multi_conv.launches += 1
    return y


dilated_multi_conv.launches = 0
