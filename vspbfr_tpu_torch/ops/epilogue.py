"""The styled-conv epilogue as its own pass: kernel K6 and its plain
version.

Counterpart of `vspbfr_tpu/ops/pallas_epilogue.py`: `epilogue_plain` is
its `epilogue_ref`, `conv_epilogue` is K6, the Pallas `_pallas` (`_kernel`)
behind its `conv_epilogue`. The CUDA source is `csrc/epilogue.cu`.

    y = lrelu(out_scale[b, c] * x + noise + bias[c]) * sqrt2

x (B, H, W, C); out_scale (B, C), noise (B, H, W, 1) already scaled by its
gain, bias (C,): each optional; act turns the activation on. The packed
nc = 4 noise of the space-to-depth layout is not ported (it raises), as in
K1e.

`conv_epilogue` is a `torch.autograd.Function`. Its forward is the plain
version for tensors on the CPU and K6 for CUDA tensors (a CUDA tensor
launches or raises). Its backward follows `_fused_bwd`
(pallas_epilogue.py:153-171, the VJP of `epilogue_ref`) in differentiable
torch ops, so a double backward (stage 3's R1 through D's strided
`ConvLayer`s) runs through it. With du = g times the activation's slope:

- the slope is read from the sign of the saved output y: lrelu * sqrt2
  keeps the sign of its input and nothing is added after it within one
  K6 stage, so the sign is exact in bf16 too;
- dx = du * out_scale; d_out_scale = sum over (h, w) of du * x;
  d_noise = du summed over channels; d_bias = du summed over (b, h, w);
  the reductions in at least f32.

The two-stage chain of the JAX package's `_epi_ref` (K6, the post-
activation adds, K6 again) is `dense_conv.apply_epilogue`.
"""

from __future__ import annotations

import torch

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.fused_act import (
    SQRT2,
    act_slope,
    leaky_relu,
    sum_f32,
)


def epilogue_plain(x: torch.Tensor, out_scale=None, noise=None, bias=None,
                   act: bool = True) -> torch.Tensor:
    """What K6 computes, in plain torch (`epilogue_ref`, nc = 1). Counts
    its calls on CUDA tensors (`cuda_calls`): on the card no main path
    should make one."""
    if x.is_cuda:
        epilogue_plain.cuda_calls += 1
    out = x
    if out_scale is not None:
        out = out * out_scale[:, None, None, :]
    if noise is not None:
        out = out + noise
    if bias is not None:
        out = out + bias.reshape(1, 1, 1, -1)
    if act:
        out = leaky_relu(out, 0.2) * SQRT2
    return out


epilogue_plain.cuda_calls = 0


def _check(x, osc, nz, bias) -> None:
    name = "conv_epilogue"
    if x.ndim != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not (B, H, W, C)")
    b, h, w, c = x.shape
    if nz is not None and tuple(nz.shape) != (b, h, w, 1):
        if tuple(nz.shape[:3]) == (b, h, w):
            raise NotImplementedError(
                f"{name}: noise with {nz.shape[3]} phases served the packed "
                "layout, which is not ported")
        raise ValueError(f"{name}: noise {tuple(nz.shape)}, want "
                         f"{(b, h, w, 1)}")
    for key, t, shape in (("out_scale", osc, (b, c)), ("bias", bias, (c,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, want {shape}")


def _epilogue_forward(x, osc, nz, bias, act) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K6 for
    CUDA tensors."""
    if x.device.type == "cpu":
        return epilogue_plain(x, osc, nz, bias, act)
    name = "conv_epilogue"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _build.check_cuda_inputs(name, x, osc, nz, bias)
    b, h, w, c = x.shape
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {x.numel()} elements; the kernel indexes "
                         "with 32 bits")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_conv_epilogue", x.data_ptr(), _build.ptr(osc),
                 _build.ptr(nz), _build.ptr(bias), y.data_ptr(), int(act),
                 _build.dtype_code(x), x.numel(), c, h * w,
                 int(x.data_ptr() % 16 == 0), _build.stream_of(x))
    conv_epilogue.launches += 1
    return y


class _ConvEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act, x, osc, nz, bias):
        y = _epilogue_forward(x, osc, nz, bias, act)
        need_osc = osc is not None and ctx.needs_input_grad[2]
        ctx.save_for_backward(x if need_osc else None, osc,
                              y if act else None)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, g):
        x, osc, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        du = g * act_slope(y, g.dtype) if ctx.act else g
        dx = dosc = dnz = dbias = None
        if need[1]:
            dx = du if osc is None else du * osc[:, None, None, :]
        if need[2]:
            dosc = sum_f32(du * x, (1, 2), osc.dtype)
        if need[3]:
            dnz = sum_f32(du, (3,), g.dtype).unsqueeze(-1)
        if need[4]:
            dbias = sum_f32(du, (0, 1, 2), g.dtype)
        return None, dx, dosc, dnz, dbias


def conv_epilogue(x: torch.Tensor, out_scale=None, noise=None, bias=None,
                  act: bool = True) -> torch.Tensor:
    """K6: the styled epilogue on x (see the module docstring). The
    operands are cast to x's dtype (as the JAX wrapper casts them); the
    output is in x's dtype. Differentiable in x and every operand."""
    _check(x, out_scale, noise, bias)

    def cast(t):
        return None if t is None else t.to(x.dtype).contiguous()

    return _ConvEpilogue.apply(bool(act), x.contiguous(), cast(out_scale),
                               cast(noise), cast(bias))


conv_epilogue.launches = 0
