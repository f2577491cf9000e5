"""Bias + leaky ReLU * sqrt(2): kernel K7 and its plain version.

Counterpart of `vspbfr_tpu/ops/fused_act.py`: `fused_leaky_relu_plain` is
its `fused_leaky_relu` (the XLA form), `fused_leaky_relu` is K7, the Pallas
`fused_leaky_relu_pallas` (`_flr_kernel`), whose CUDA source is
`csrc/fused_act.cu`. The TPU's gate (trailing C % 128 == 0, else XLA) is
not carried over: every (..., C) tensor on the card takes the kernel.

`fused_leaky_relu` runs the plain version for tensors on the CPU and K7
for CUDA tensors (a CUDA tensor launches or raises). K7 reads the bias in
its own dtype (float32 or bfloat16) and rounds it to x's, as the JAX
wrapper's `astype(x.dtype)` does, so an f32 bias costs no cast launch.
Where a gradient is needed it goes through a `torch.autograd.Function`
whose backward is the gradient of the plain version in differentiable
torch ops, so a double backward (R1) runs through it: dx = g * slope, the
slope (gain, or slope * gain) read from the sign of the saved output (both
positive, so the activation keeps the sign of its input), and d_bias = dx
summed over every axis but the last, in at least f32, in the bias's
dtype. Otherwise (`torch.no_grad()`, or nothing requires a gradient) the
forward primitive runs without the Function.

`scaled_leaky_relu` (the code diffuser's, no bias) takes the same route,
as `fused_leaky_relu(x, None)`.

`sum_f32` and `act_slope` are shared with the epilogue Functions
(`epilogue.py`, `dense_conv.py`).
"""

from __future__ import annotations

import math

import torch

from vspbfr_tpu_torch.ops import _build

SQRT2 = math.sqrt(2.0)


def sum_f32(t: torch.Tensor, dims, dtype) -> torch.Tensor:
    """t summed over dims in at least f32, returned in dtype."""
    acc = torch.promote_types(t.dtype, torch.float32)
    return t.to(acc).sum(dim=dims).to(dtype)


def act_slope(v: torch.Tensor, dtype, negative_slope: float = 0.2,
              scale: float = SQRT2) -> torch.Tensor:
    """d(leaky_relu(u) * scale)/du as a function of the sign of u (which
    the activation preserves); v is a value of that sign or a bool mask of
    u >= 0. The two slopes are filled on v's device: a `torch.tensor` of a
    Python number would be a host-to-device copy that stalls the host
    until the stream drains, at every backward."""
    pos = v if v.dtype == torch.bool else v >= 0
    return torch.where(pos, torch.full((), scale, dtype=dtype,
                                       device=v.device),
                       torch.full((), negative_slope * scale, dtype=dtype,
                                  device=v.device))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """`jax.nn.leaky_relu`: where(x >= 0, x, slope * x). At x == 0 its
    gradient is 1, as in JAX (torch's `F.leaky_relu` takes the slope
    there), which is the convention `act_slope` follows."""
    return torch.where(x >= 0, x, x * negative_slope)


def fused_leaky_relu_plain(x: torch.Tensor, bias: torch.Tensor | None = None,
                           negative_slope: float = 0.2,
                           scale: float = SQRT2) -> torch.Tensor:
    """What K7 computes, in plain torch: leaky_relu(x + bias) * scale, bias
    over the trailing (channel) axis. Counts its calls on CUDA tensors
    (`cuda_calls`): on the card no main path should make one."""
    if x.is_cuda:
        fused_leaky_relu_plain.cuda_calls += 1
    if bias is not None:
        x = x + bias.reshape((1,) * (x.ndim - 1) + (-1,))
    return leaky_relu(x, negative_slope) * scale


fused_leaky_relu_plain.cuda_calls = 0


# one launch's arguments: `struct K7Launch` of csrc/fused_act.cu, in order
# (field, `struct` format: int64, or a double)
LAUNCH_FIELDS = (*((f, "q") for f in ("x", "bias", "y", "dtype", "op_dtype",
                                      "n", "C", "aligned")),
                 ("slope", "d"), ("gain", "d"))
_pack, _launch = _build.launcher("vspbfr_fused_lrelu", LAUNCH_FIELDS)


def _flr_forward(x, bias, negative_slope, scale) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K7 for
    CUDA tensors."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"fused_leaky_relu: no kernel for device "
                             f"{x.device}")
        return fused_leaky_relu_plain(
            x, None if bias is None else bias.to(x.dtype), negative_slope,
            scale)
    name = "fused_leaky_relu"
    code = _build.dtype_code(x)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} elements; the kernel indexes with 32 "
                         "bits")
    op_code, (bias,) = _build.operand_code(name, x, (bias,))
    y = torch.empty_like(x)
    if n == 0:
        return y
    xp = x.data_ptr()
    _launch(x, _pack(xp, _build.addr(bias), y.data_ptr(), code, op_code, n,
                     x.shape[-1] if x.ndim else 1, xp % 16 == 0,
                     negative_slope, scale))
    fused_leaky_relu.launches += 1
    return y


class _FusedLeakyRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, negative_slope, scale, x, bias):
        y = _flr_forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(y)
        ctx.slope, ctx.scale = negative_slope, scale
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        dx = g * act_slope(y, g.dtype, ctx.slope, ctx.scale)
        dbias = None
        if ctx.needs_input_grad[3]:
            dbias = sum_f32(dx, tuple(range(dx.ndim - 1)), ctx.bias_dtype)
        return None, None, dx, dbias


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """K7: leaky_relu(x + bias) * scale, bias (C,) over the trailing axis,
    in float32 or bfloat16 and rounded to x's dtype as it is read; the
    output in x's dtype. Differentiable in x and bias. negative_slope and
    scale must be positive (the backward reads the slope from the output's
    sign). Under `torch.no_grad()`, or when neither x nor bias requires a
    gradient, the forward primitive runs without the autograd Function."""
    if not (negative_slope > 0 and scale > 0):
        raise ValueError(f"fused_leaky_relu: negative_slope {negative_slope} "
                         f"and scale {scale} must be positive")
    c = x.shape[-1] if x.ndim else 1
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"fused_leaky_relu: bias {tuple(bias.shape)}, want "
                         f"({c},)")
    if not x.is_contiguous():
        x = x.contiguous()
    if not (torch.is_grad_enabled() and (
            x.requires_grad or (bias is not None and bias.requires_grad))):
        return _flr_forward(x, bias, float(negative_slope), float(scale))
    return _FusedLeakyRelu.apply(float(negative_slope), float(scale), x, bias)


fused_leaky_relu.launches = 0


def scaled_leaky_relu(x: torch.Tensor,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """leaky_relu(x) * sqrt(2) without bias: K7 with no bias."""
    return fused_leaky_relu(x, None, negative_slope)
