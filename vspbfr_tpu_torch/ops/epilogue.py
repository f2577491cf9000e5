"""The styled-conv epilogue chain as one pass: kernel K6 and its plain
version.

Counterpart of `vspbfr_tpu/ops/pallas_epilogue.py` and of the chain
`_epi_ref` (`vspbfr_tpu/ops/pallas_conv.py:387`) that the JAX package runs
around it: `epilogue_plain` is `epilogue_ref`, `epilogue_plain_chain` is
`_epi_ref`, and `conv_epilogue` is K6, the Pallas `_pallas` (`_kernel`)
extended to the whole chain. The CUDA source is `csrc/epilogue.cu`.

    u = out_scale[b, c] * x + noise + bias[c]
    y = lrelu(u) * sqrt2 + sum(post_add)              # act; the skips
    y = lrelu(y + noise2 + bias2[c]) * sqrt2          # second stage, act2

x (B, H, W, C); out_scale (B, C), noise and noise2 (B, H, W, nc) already
scaled by their gains, bias and bias2 (C,), up to `MAX_POST` post-adds of
x's shape: each optional. nc is 1, or 4 in the space-to-depth layout:
channel c then adds the value of phase c // (C / 4) (`_expand_matrix`,
pallas_epilogue.py:33, as an index, `noise_term`), and the noise's
gradient is the sum over its phase's channels (`noise_grad`); the two
noises take the same nc. `phase_launches` counts the launches with nc = 4
apart (they count in `launches` too).

`conv_epilogue` makes one K6 launch for the whole chain on a CUDA tensor
(launches or raises); a CPU tensor takes the plain version. The kernel
reads out_scale, the noises and the biases in their own dtype (float32 or
bfloat16) and rounds them to x's, as the JAX wrappers' `astype(x.dtype)`
does, so a caller's f32 operands cost no cast; the post-adds must be in
x's dtype. The lean path: under `torch.no_grad()`, or when no tensor
requires a gradient, the forward primitive runs without the autograd
Function.

The Function's backward follows the VJP of `_epi_ref` in differentiable
torch ops, so a double backward (stage 3's R1 through D's strided
`ConvLayer`s) runs through it:

- du2 = g times stage 2's slope, read from the sign of the saved output y
  (lrelu * sqrt2 keeps the sign of its input); d_bias2 and d_noise2 from
  du2;
- du = du2 (or g) times stage 1's slope: from the sign of y when nothing
  follows stage 1, else from the sign mask the kernel stores when a
  gradient is needed (the value recovered by subtracting what follows
  would flip sign in bf16 wherever it is within rounding of 0);
- dx = du * out_scale; d_out_scale = sum over (h, w) of du * x with the
  saved input x; d_noise = du summed over channels (over each phase's
  channels where nc = 4); d_bias = du summed
  over (b, h, w); the reductions in at least f32, each gradient in its
  operand's dtype; d_post = g.

As in the JAX package, a second stage together with post-adds has no
backward (it raises).
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

MAX_POST = 2   # post_add tensors K6's and K1e's passes take
NOISE_PHASES = (1, 4)   # the noises' values a pixel (nc)


def noise_term(nz: torch.Tensor, c: int) -> torch.Tensor:
    """The noise (B, H, W, nc) as a term of a (B, H, W, c) tensor: itself
    (broadcast) where nc = 1, each phase's value over its c / 4 channels
    where nc = 4."""
    return nz if nz.shape[-1] == 1 else nz.repeat_interleave(
        c // nz.shape[-1], dim=-1)


def noise_grad(du: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """d_noise from the gradient du of the term `noise_term(nz, C)`: du
    summed over the channels of each of nz's nc values, in at least f32,
    in nz's dtype."""
    b, h, w, c = du.shape
    nc = nz.shape[-1]
    return sum_f32(du.reshape(b, h, w, nc, c // nc), (4,), nz.dtype)


def epilogue_plain(x: torch.Tensor, out_scale=None, noise=None, bias=None,
                   act: bool = True) -> torch.Tensor:
    """One stage of the chain in plain torch (`epilogue_ref`). Counts its
    calls on CUDA tensors (`cuda_calls`): on the card no main path should
    make one."""
    if x.is_cuda:
        epilogue_plain.cuda_calls += 1
    out = x
    if out_scale is not None:
        out = out * out_scale[:, None, None, :]
    if noise is not None:
        out = out + noise_term(noise, x.shape[-1])
    if bias is not None:
        out = out + bias.reshape(1, 1, 1, -1)
    if act:
        out = leaky_relu(out, 0.2) * SQRT2
    return out


epilogue_plain.cuda_calls = 0


def epilogue_plain_chain(z: torch.Tensor, out_scale=None, noise=None,
                         bias=None, act: bool = True, post_add=(),
                         noise2=None, bias2=None,
                         act2: bool = False) -> torch.Tensor:
    """What K6 computes, in plain torch (`_epi_ref`, pallas_conv.py:387):
    the first stage (skipped when it has nothing to do), the post-
    activation adds, then the second stage if it has a piece."""
    out = z
    if out_scale is not None or noise is not None or bias is not None or act:
        out = epilogue_plain(z, out_scale, noise, bias, act)
    for p in post_add:
        out = out + p
    if noise2 is not None or bias2 is not None or act2:
        out = epilogue_plain(out, None, noise2, bias2, act2)
    return out


def has_stage2(noise2, bias2, act2) -> bool:
    return noise2 is not None or bias2 is not None or bool(act2)


def _bad_shape(key, t, want):
    raise ValueError(f"conv_epilogue: {key} {tuple(t.shape)}, want {want}")


def noise_phases(name: str, nz, nz2, shape) -> int:
    """nc of the noises (1 when there are none) for an output of `shape`
    (B, H, W, C): each (B, H, W, nc), nc in NOISE_PHASES (4 only where C %
    4 == 0), the two alike; raises otherwise."""
    b, h, w, c = shape
    ncs = {t.shape[-1] for t in (nz, nz2) if t is not None}
    for key, t in (("noise", nz), ("noise2", nz2)):
        if t is not None and (t.dim() != 4 or t.shape[:3] != (b, h, w)):
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, want "
                             f"{(b, h, w)} and nc")
    nc = ncs.pop() if len(ncs) == 1 else 1
    if ncs or nc not in NOISE_PHASES or c % nc:
        got = [None if t is None else t.shape[-1] for t in (nz, nz2)]
        raise ValueError(f"{name}: noise values a pixel {got} for {c} "
                         "channels; nc must be 1 or 4 (C % 4 == 0), the same "
                         "for both noises")
    return nc


def _check(x, osc, nz, bias, post, nz2, bias2) -> int:
    """The shapes every device takes; raises on any other (each operand
    compared only when present: this runs at every call). Returns the
    noises' nc."""
    shape = x.shape
    if len(shape) != 4:
        raise ValueError(f"conv_epilogue: x {tuple(shape)} is not (B, H, W, "
                         "C)")
    b, h, w, c = shape
    if osc is not None and osc.shape != (b, c):
        _bad_shape("out_scale", osc, (b, c))
    if bias is not None and bias.shape != (c,):
        _bad_shape("bias", bias, (c,))
    if bias2 is not None and bias2.shape != (c,):
        _bad_shape("bias2", bias2, (c,))
    nc = (1 if nz is None and nz2 is None
          else noise_phases("conv_epilogue", nz, nz2, shape))
    if post and (len(post) > MAX_POST
                 or any(p.shape != shape for p in post)):
        raise ValueError(f"conv_epilogue: post_add "
                         f"{[tuple(p.shape) for p in post]}; at most "
                         f"{MAX_POST} of x's shape {tuple(shape)}")
    return nc


# one launch's arguments: `struct K6Launch` of csrc/epilogue.cu, in order
# (field, `struct` format: int64 each)
LAUNCH_FIELDS = tuple((f, "q") for f in (
    "x", "y", "osc", "noise", "bias", "post0", "post1", "noise2", "bias2",
    "mask", "n_post", "act", "act2", "dtype", "op_dtype", "n", "C", "HW",
    "aligned", "nc"))
_pack, _launch = _build.launcher("vspbfr_conv_epilogue", LAUNCH_FIELDS)


def _epilogue_forward(x, osc, nz, bias, act, post, nz2, bias2, act2,
                      want_mask=False):
    """The forward primitive: the plain version for CPU tensors, one K6
    launch for CUDA tensors. Returns (y, mask): with want_mask, mask is the
    bool sign of stage 1's pre-activation, else None."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"conv_epilogue: no kernel for device "
                             f"{x.device}")
        osc, nz, bias, nz2, bias2 = (   # the JAX wrappers' astype(x.dtype)
            None if t is None else t.to(x.dtype)
            for t in (osc, nz, bias, nz2, bias2))
        if not want_mask:
            return epilogue_plain_chain(x, osc, nz, bias, act, post, nz2,
                                        bias2, act2), None
        u = epilogue_plain_chain(x, osc, nz, bias, act=False)
        y = epilogue_plain_chain(u, act=act, post_add=post, noise2=nz2,
                                 bias2=bias2, act2=act2)
        return y, u >= 0
    name = "conv_epilogue"
    code = _build.dtype_code(x)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} elements; the kernel indexes with 32 "
                         "bits")
    op_code, (osc, nz, bias, nz2, bias2) = _build.operand_code(
        name, x, (osc, nz, bias, nz2, bias2))
    if post:
        if any(p.dtype != x.dtype for p in post):
            raise TypeError(f"{name}: post_add in "
                            f"{[p.dtype for p in post]}, x in {x.dtype}")
        post = _build.operand_code(name, x, post)[1]
    xp = x.data_ptr()
    pp = [p.data_ptr() for p in post] + [0] * (MAX_POST - len(post))
    aligned = not (xp % 16 or pp[0] % 16 or pp[1] % 16)
    y = torch.empty_like(x)
    mask = torch.empty_like(x, dtype=torch.bool) if want_mask else None
    if n == 0:
        return y, mask
    _, h, w, c = x.shape
    nc = next((t.shape[-1] for t in (nz, nz2) if t is not None), 1)
    _launch(x, _pack(xp, y.data_ptr(), _build.addr(osc), _build.addr(nz),
                     _build.addr(bias), pp[0], pp[1], _build.addr(nz2),
                     _build.addr(bias2), _build.addr(mask), len(post), act,
                     act2, code, op_code, n, c, h * w, aligned, nc))
    conv_epilogue.launches += 1
    if nc > 1:
        conv_epilogue.phase_launches += 1
    return y, mask


def stage2_grads(g, y, nz2, bias2, act2):
    """(du2, d_noise2, d_bias2) of the second stage for the incoming g:
    stage 2's slope read from the sign of its output y."""
    du2 = g * act_slope(y, g.dtype) if act2 else g
    dnz2 = None if nz2 is None else noise_grad(du2, nz2)
    dbias2 = None if bias2 is None else sum_f32(du2, (0, 1, 2), bias2.dtype)
    return du2, dnz2, dbias2


class _ConvEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act, act2, x, osc, nz, bias, nz2, bias2, *post):
        has2 = has_stage2(nz2, bias2, act2)
        want_mask = bool(act and (has2 or post))
        y, mask = _epilogue_forward(x, osc, nz, bias, act, post, nz2, bias2,
                                    act2, want_mask)
        need = ctx.needs_input_grad
        # y gives the slope of stage 2, and of stage 1 where nothing follows
        ctx.save_for_backward(x if need[3] else None, osc, nz, bias, nz2,
                              bias2, y if act2 or (act and mask is None)
                              else None, mask)
        ctx.act, ctx.act2, ctx.n_post = act, act2, len(post)
        return y

    @staticmethod
    def backward(ctx, g):
        x, osc, nz, bias, nz2, bias2, y, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        dnz2 = dbias2 = None
        g1 = g
        if has_stage2(nz2, bias2, ctx.act2):
            if ctx.n_post:
                raise ValueError("conv_epilogue backward: a second stage "
                                 "together with post_add has no gradient (as "
                                 "in the JAX package)")
            g1, dnz2, dbias2 = stage2_grads(g, y, nz2, bias2, ctx.act2)
        if ctx.act:
            g1 = g1 * act_slope(y if mask is None else mask, g.dtype)
        dx = dosc = None
        if need[2]:
            dx = (g1 if osc is None
                  else g1 * osc.to(g1.dtype)[:, None, None, :])
        if need[3]:
            dosc = sum_f32(g1 * x, (1, 2), osc.dtype)
        dnz = None if nz is None else noise_grad(g1, nz)
        dbias = None if bias is None else sum_f32(g1, (0, 1, 2), bias.dtype)
        return (None, None, dx, dosc, dnz, dbias, dnz2, dbias2,
                *(g for _ in range(ctx.n_post)))


def conv_epilogue(x: torch.Tensor, out_scale=None, noise=None, bias=None,
                  act: bool = True, post_add=(), noise2=None, bias2=None,
                  act2: bool = False) -> torch.Tensor:
    """K6: the epilogue chain on x in one pass (see the module docstring).
    out_scale, the noises and the biases in float32 or bfloat16, the post-
    adds in x's dtype; the output in x's dtype. Differentiable in x and
    every operand."""
    post = tuple(post_add)
    _check(x, out_scale, noise, bias, post, noise2, bias2)
    if not x.is_contiguous():
        x = x.contiguous()
    act, act2 = bool(act), bool(act2)
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, out_scale, noise, bias, noise2, bias2, *post))):
        return _epilogue_forward(x, out_scale, noise, bias, act, post, noise2,
                                 bias2, act2)[0]
    return _ConvEpilogue.apply(act, act2, x, out_scale, noise, bias, noise2,
                               bias2, *post)


conv_epilogue.launches = 0
conv_epilogue.phase_launches = 0
