"""Dense stride-1 convolution: kernel K1 and its plain version.

Counterpart of `vspbfr_tpu/ops/pallas_conv.py` (`conv2d_dense`, the Pallas
`_conv_pallas`). NHWC x HWIO -> NHWC with explicit pads
((py0, py1), (px0, px1)) and an optional per-(batch, in-channel) input
scale, accumulated in f32. The CUDA source is `csrc/dense_conv.cu`.

The wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. Every shape goes to the kernel on the
card: the TPU's gate (128-lane channels, >= 32768 pixels) is not carried
over. The fused epilogue variant (`conv2d_dense_epilogue`) is not ported.

`dense_conv` is a `torch.autograd.Function` following the JAX custom VJP
(`_conv_fwd` / `_conv_bwd`, pallas_conv.py:338-360). The same Function
serves both devices, so the CPU tests exercise its backward math:

- dxs = dense_conv(g, flip(w).transpose(in, out), full-correlation pads),
  a K1 launch on the card; dx = dxs * in_scale;
- d_in_scale = sum over (h, w) of dxs * x, reduced in at least f32;
- dw by `torch.nn.grad.conv2d_weight` (cuDNN on the card), as the JAX
  package leaves it to XLA; computed only when asked for.

The backward is built from differentiable calls (dense_conv again, torch
ops), so a double backward (stage 3's R1) runs through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.ops import _build


def _norm_pads(pads) -> tuple[int, int, int, int]:
    (py0, py1), (px0, px1) = pads
    return int(py0), int(py1), int(px0), int(px1)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pads=((0, 0), (0, 0)), dilation: int = 1,
              groups: int = 1) -> torch.Tensor:
    """`F.conv2d` on NHWC x HWIO through channels-last NCHW views (no copy
    for symmetric pads; asymmetric pads go through `F.pad`)."""
    py0, py1, px0, px1 = _norm_pads(pads)
    xn = x.permute(0, 3, 1, 2)
    if py0 != py1 or px0 != px1:
        xn = F.pad(xn, (px0, px1, py0, py1))
        padding = 0
    else:
        padding = (py0, px0)
    out = F.conv2d(xn, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                   padding=padding, dilation=dilation, groups=groups)
    return out.permute(0, 2, 3, 1)


def dense_conv_plain(x: torch.Tensor, w: torch.Tensor, pads,
                     in_scale: torch.Tensor | None = None) -> torch.Tensor:
    """What K1 computes, in plain torch (`_scaled_ref`, pallas_conv.py:328)."""
    xs = x if in_scale is None else x * in_scale[:, None, None, :]
    return conv_nhwc(xs, w, 1, pads).contiguous()


def _dense_conv_forward(x: torch.Tensor, w: torch.Tensor, pads,
                        in_scale: torch.Tensor | None) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K1 for
    CUDA tensors."""
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, pads, in_scale)
    if x.device.type != "cuda":
        raise ValueError(f"dense_conv: no kernel for device {x.device}")
    name = "dense_conv"
    _build.check_cuda_inputs(name, x, w, in_scale)
    b, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    py0, py1, px0, px1 = _norm_pads(pads)
    oh, ow = h + py0 + py1 - kh + 1, wd + px0 + px1 - kw + 1
    if wci != ci or min(py0, py1, px0, px1) < 0 or oh < 1 or ow < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"pads {pads}")
    if in_scale is not None and tuple(in_scale.shape) != (b, ci):
        raise ValueError(f"{name}: in_scale {tuple(in_scale.shape)}")
    y = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_dense_conv", x.data_ptr(), w.data_ptr(),
                 _build.ptr(in_scale), y.data_ptr(), _build.dtype_code(x),
                 b, h, wd, ci, co, kh, kw, py0, px0, oh, ow,
                 _build.stream_of(x))
    dense_conv.launches += 1
    return y


def _weight_grad(x, in_scale, g, w_shape, pads) -> torch.Tensor:
    """dL/dw of the scaled conv (XLA's VJP in the JAX package,
    pallas_conv.py:358), as cuDNN's differentiable weight gradient."""
    py0, py1, px0, px1 = pads
    xs = x if in_scale is None else x * in_scale[:, None, None, :]
    xn = F.pad(xs.permute(0, 3, 1, 2), (px0, px1, py0, py1))
    kh, kw, ci, co = w_shape
    dw = torch.nn.grad.conv2d_weight(xn, (co, ci, kh, kw),
                                     g.permute(0, 3, 1, 2))
    return dw.permute(2, 3, 1, 0)


class _DenseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, in_scale, pads):
        ctx.save_for_backward(x, w, in_scale)
        ctx.pads = pads
        return _dense_conv_forward(x, w, pads, in_scale)

    @staticmethod
    def backward(ctx, g):
        x, w, in_scale = ctx.saved_tensors
        py0, py1, px0, px1 = _norm_pads(ctx.pads)
        kh, kw = w.shape[0], w.shape[1]
        bpads = ((kh - 1 - py0, kh - 1 - py1), (kw - 1 - px0, kw - 1 - px1))
        if min(min(p) for p in bpads) < 0:
            raise ValueError(f"dense_conv backward: pads {ctx.pads} exceed "
                             f"the {kh}x{kw} kernel's reach; the gradient "
                             "would need negative pads")
        g = g.contiguous()
        dx = dw = dis = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            wt = w.flip((0, 1)).transpose(2, 3).contiguous()
            dxs = dense_conv(g, wt, bpads)
            if ctx.needs_input_grad[0]:
                dx = dxs if in_scale is None else (
                    dxs * in_scale[:, None, None, :])
            if ctx.needs_input_grad[2]:
                acc = torch.promote_types(dxs.dtype, torch.float32)
                dis = (dxs.to(acc) * x.to(acc)).sum(dim=(1, 2)).to(
                    in_scale.dtype)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, in_scale, g, tuple(w.shape),
                              (py0, py1, px0, px1))
        return dx, dw, dis, None


def dense_conv(x: torch.Tensor, w: torch.Tensor, pads,
               in_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 dense conv. x (B, H, W, Ci), w (KH, KW, Ci, Co) in x's dtype,
    in_scale (B, Ci) or None; pads ((py0, py1), (px0, px1)), each >= 0.
    Differentiable in x, w and in_scale."""
    py0, py1, px0, px1 = _norm_pads(pads)
    return _DenseConv.apply(x, w, in_scale, ((py0, py1), (px0, px1)))


dense_conv.launches = 0
