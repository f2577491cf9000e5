"""Multi-dilation 3x3 convolution: kernel K2 and its plain version.

Counterpart of `vspbfr_tpu/ops/pallas_dilated.py` (`dilated_multi_conv`,
the Pallas `_multi_pallas`): N same-input 3x3 "same" dilated convs, outputs
concatenated on channels, with an optional (B, Ci) input scale and a
(B, sum Co) output scale. The CUDA source is `csrc/dilated_conv.cu`; it
reads each branch's weights where they lie (one pointer a branch), so the
forward copies no weights.

Only `groups=1` (the unpacked layout) is ported; the grouped form served
the space-to-depth layout, which the port does not carry.

`dilated_multi_conv` is a `torch.autograd.Function` following the JAX
custom VJP (`_multi_fwd` / `_multi_bwd`, pallas_dilated.py:280-302): its
forward is K2 on the card and the plain version on the CPU. The JAX
backward is XLA's VJP of the plain composition `_multi_ref`, so here the
backward is the same gradient written out in differentiable torch calls
(cuDNN on the card; a double backward runs through it). With zs the
unscaled concatenated output and g_z = g * out_scale:

- d_out_scale = sum over (h, w) of g * zs, reduced in at least f32. zs is
  not recomputed: it is y / out_scale, from the saved output y (the port
  folds the demod into K2's store, as the JAX kernel does; out_scale is a
  demod coefficient, rsqrt(...) > 0);
- per branch i: dw_i by `torch.nn.grad.conv2d_weight` of (x * in_scale,
  g_z_i) at dilation d_i, and the input gradient as the dilated conv of
  g_z_i with the flipped, in/out-swapped kernel (pads d_i); dxs sums them;
- dx = dxs * in_scale, d_in_scale = sum over (h, w) of dxs * x.
"""

from __future__ import annotations

import ctypes

import torch

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc
from vspbfr_tpu_torch.ops.fused_act import sum_f32

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


def _check(x, ws, dils, in_scale, out_scale) -> list[int]:
    """The wrapper's argument checks; returns the branch widths."""
    name = "dilated_multi_conv"
    b, _, _, ci = x.shape
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
    return cos


def _multi_forward(x, ws, dils, in_scale, out_scale) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K2 for
    CUDA tensors."""
    if x.device.type == "cpu":
        return dilated_multi_conv_plain(x, ws, dils, in_scale, out_scale)
    name = "dilated_multi_conv"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    cos = _check(x, ws, dils, in_scale, out_scale)
    _build.check_cuda_inputs(name, x, *ws, in_scale, out_scale)
    b, h, wd, ci = x.shape
    y = torch.empty((b, h, wd, sum(cos)), dtype=x.dtype, device=x.device)
    # the kernel reads each branch's weights in place, one pointer a branch
    c_ws = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    c_dils = (ctypes.c_int * len(dils))(*dils)
    c_cos = (ctypes.c_int * len(cos))(*cos)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_dilated_multi_conv", x.data_ptr(), c_ws, _build.ptr(in_scale),
                 _build.ptr(out_scale), y.data_ptr(), _build.dtype_code(x),
                 b, h, wd, ci, len(ws), c_dils, c_cos, _build.stream_of(x))
    dilated_multi_conv.launches += 1
    return y


class _DilatedMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dils, x, in_scale, out_scale, *ws):
        y = _multi_forward(x, ws, dils, in_scale, out_scale)
        ctx.save_for_backward(x, in_scale, out_scale, y, *ws)
        ctx.dils = dils
        return y

    @staticmethod
    def backward(ctx, g):
        x, in_scale, out_scale, y, *ws = ctx.saved_tensors
        need = ctx.needs_input_grad
        dosc = None
        if out_scale is not None:
            osc = out_scale[:, None, None, :].to(g.dtype)
            if need[3]:
                dosc = sum_f32(g * (y / osc), (1, 2), out_scale.dtype)
            g = g * osc
        xs = x if in_scale is None else x * in_scale[:, None, None, :]
        dxs, dws, c0 = None, [], 0
        for i, (w, d) in enumerate(zip(ws, ctx.dils)):
            co = w.shape[3]
            gi = g[..., c0:c0 + co]
            c0 += co
            if need[1] or need[2]:
                wt = w.flip((0, 1)).transpose(2, 3).to(g.dtype)
                dxi = conv_nhwc(gi, wt, 1, ((d, d), (d, d)), dilation=d)
                dxs = dxi if dxs is None else dxs + dxi
            dws.append(torch.nn.grad.conv2d_weight(
                xs.permute(0, 3, 1, 2), (co, w.shape[2], 3, 3),
                gi.permute(0, 3, 1, 2), padding=d, dilation=d
            ).permute(2, 3, 1, 0).to(w.dtype) if need[4 + i] else None)
        dx = dis = None
        if need[1]:
            dx = dxs if in_scale is None else dxs * in_scale[:, None, None, :]
        if need[2]:
            dis = sum_f32(dxs * x, (1, 2), in_scale.dtype)
        return (None, dx, dis, dosc, *dws)


def dilated_multi_conv(x: torch.Tensor, ws, dils, groups: int = 1,
                       in_scale: torch.Tensor | None = None,
                       out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """concat_i(conv(x * in_scale, ws[i], dilation=dils[i], 'same'))
    * out_scale. x (B, H, W, Ci); ws[i] (3, 3, Ci, Co_i) in x's dtype.
    Differentiable in x, every ws[i], in_scale and out_scale."""
    if groups != 1:
        raise NotImplementedError(
            "dilated_multi_conv: groups > 1 served the packed layout, which "
            "is not ported")
    ws, dils = tuple(ws), tuple(int(d) for d in dils)
    _check(x, ws, dils, in_scale, out_scale)
    return _DilatedMulti.apply(dils, x, in_scale, out_scale, *ws)


dilated_multi_conv.launches = 0
