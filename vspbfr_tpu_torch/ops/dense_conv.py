"""Dense stride-1 convolution: kernel K1, its fused-epilogue form K1e, and
their plain versions.

Counterpart of `vspbfr_tpu/ops/pallas_conv.py` (`conv2d_dense` and
`conv2d_dense_epilogue`, the Pallas `_conv_pallas` with and without
`fuse_epi`). NHWC x HWIO -> NHWC with explicit pads ((py0, py1), (px0,
px1)) and an optional per-(batch, in-channel) input scale, accumulated in
f32. The CUDA source of both is `csrc/dense_conv.cu`.

The wrappers take the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. Every shape goes to the kernel on the
card: the TPU's gate (128-lane channels, >= 32768 pixels) is not carried
over.

`dense_conv` is a `torch.autograd.Function` following the JAX custom VJP
(`_conv_fwd` / `_conv_bwd`, pallas_conv.py:338-360). The same Function
serves both devices, so the CPU tests exercise its backward math:

- dxs = dense_conv(g, flip(w).transpose(in, out), full-correlation pads),
  a K1 launch on the card; dx = dxs * in_scale;
- d_in_scale = sum over (h, w) of dxs * x, reduced in at least f32;
- dw by `torch.nn.grad.conv2d_weight` (cuDNN on the card), as the JAX
  package leaves it to XLA; computed only when asked for.

`dense_conv_epilogue` (K1e) adds the styled-conv epilogue to the store:

    y = lrelu(out_scale * conv(x * in_scale, w) + noise + bias) * sqrt2
        + sum(post_add)
    y = lrelu(y + noise2 + bias2) * sqrt2          # optional second stage

(every piece optional; noise is (B, OH, OW, 1), already scaled by its gain:
the packed nc = 4 noise of the space-to-depth layout is not ported). Its
Function follows `_convepi_bwd` (pallas_conv.py:451-518): the
pre-activations are recovered from the saved output y (lrelu is sign
preserving and invertible), so nothing is recomputed, and dx goes through
`dense_conv`, a K1 launch. As in JAX, a second stage together with
`post_add` has no backward. One departure: where something is added after
the first activation (`post_add`, or a second stage), the activation's
slope is not taken from the value recovered by subtracting it again, whose
sign a bf16 output flips wherever that value is within rounding of 0 (each
flip moves that element's gradient by a factor of 5); when a gradient is
needed the kernel stores the sign as one byte per output element.
`conv2d_dense_epilogue` chooses between the two kernel forms with the JAX
package's switch, `VSPBFR_FUSED_EPI=1`: on, one K1e launch; off (the
default), the two-pass form of the JAX package's `_epi_ref`, K1 and then
`apply_epilogue`: the whole chain (both stages and the post-activation
adds) in one K6 launch.

`epilogue_plain_chain` (`ops/epilogue.py`) is the chain in plain torch,
which the plain versions (`dense_conv_epilogue_plain` and the CPU branch of
K1e) use, so a plain version never reaches a kernel.

Both backwards are built from differentiable calls (the Functions again,
torch ops), so a double backward (stage 3's R1) runs through them.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.epilogue import (
    MAX_POST,
    conv_epilogue,
    epilogue_plain_chain,
    has_stage2,
    stage2_grads,
)
from vspbfr_tpu_torch.ops.fused_act import SQRT2, act_slope, sum_f32


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


def _out_shape(name, x, w, pads, in_scale):
    """Check a K1 / K1e launch's arguments; returns (oh, ow)."""
    b, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    py0, py1, px0, px1 = _norm_pads(pads)
    oh, ow = h + py0 + py1 - kh + 1, wd + px0 + px1 - kw + 1
    if wci != ci or min(py0, py1, px0, px1) < 0 or oh < 1 or ow < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"pads {pads}")
    if in_scale is not None and tuple(in_scale.shape) != (b, ci):
        raise ValueError(f"{name}: in_scale {tuple(in_scale.shape)}")
    return oh, ow


def _dense_conv_forward(x: torch.Tensor, w: torch.Tensor, pads,
                        in_scale: torch.Tensor | None) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K1 for
    CUDA tensors."""
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, pads, in_scale)
    if x.device.type != "cuda":
        raise ValueError(f"dense_conv: no kernel for device {x.device}")
    _build.check_cuda_inputs("dense_conv", x, w, in_scale)
    oh, ow = _out_shape("dense_conv", x, w, pads, in_scale)
    b, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    py0, _, px0, _ = _norm_pads(pads)
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


def _conv_grads(x, w, in_scale, pads, g, need_x, need_w, need_s):
    """(dx, dw, d_in_scale) of the scaled stride-1 conv for the incoming
    gradient g (`_conv_bwd`); each is None unless asked for."""
    py0, py1, px0, px1 = _norm_pads(pads)
    kh, kw = w.shape[0], w.shape[1]
    bpads = ((kh - 1 - py0, kh - 1 - py1), (kw - 1 - px0, kw - 1 - px1))
    if min(min(p) for p in bpads) < 0:
        raise ValueError(f"dense_conv backward: pads {pads} exceed the "
                         f"{kh}x{kw} kernel's reach; the gradient would need "
                         "negative pads")
    g = g.contiguous()
    dx = dw = dis = None
    if need_x or need_s:
        wt = w.flip((0, 1)).transpose(2, 3).contiguous()
        dxs = dense_conv(g, wt, bpads)
        if need_x:
            dx = dxs if in_scale is None else dxs * in_scale[:, None, None, :]
        if need_s:
            acc = torch.promote_types(dxs.dtype, torch.float32)
            dis = (dxs.to(acc) * x.to(acc)).sum(dim=(1, 2)).to(in_scale.dtype)
    if need_w:
        dw = _weight_grad(x, in_scale, g, tuple(w.shape),
                          (py0, py1, px0, px1))
    return dx, dw, dis


class _DenseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, in_scale, pads):
        ctx.save_for_backward(x, w, in_scale)
        ctx.pads = pads
        return _dense_conv_forward(x, w, pads, in_scale)

    @staticmethod
    def backward(ctx, g):
        x, w, in_scale = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, dis = _conv_grads(x, w, in_scale, ctx.pads, g, need[0],
                                  need[1], need[2])
        return dx, dw, dis, None


def dense_conv(x: torch.Tensor, w: torch.Tensor, pads,
               in_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 dense conv. x (B, H, W, Ci), w (KH, KW, Ci, Co) in x's dtype,
    in_scale (B, Ci) or None; pads ((py0, py1), (px0, px1)), each >= 0.
    Differentiable in x, w and in_scale."""
    py0, py1, px0, px1 = _norm_pads(pads)
    return _DenseConv.apply(x, w, in_scale, ((py0, py1), (px0, px1)))


dense_conv.launches = 0


# ---------------------------------------------------------------------------
# K1e: the fused styled epilogue
# ---------------------------------------------------------------------------

def fused_epi_enabled() -> bool:
    """The JAX package's A/B switch for the in-store epilogue
    (`pallas_conv.py:407-419`): `VSPBFR_FUSED_EPI=1` routes the styled
    convs through K1e; default off (K1, then K6). Read at each call."""
    return os.environ.get("VSPBFR_FUSED_EPI", "0") == "1"


def apply_epilogue(z: torch.Tensor, out_scale=None, noise=None, bias=None,
                   act: bool = True, post_add=(), noise2=None, bias2=None,
                   act2: bool = False) -> torch.Tensor:
    """The styled-conv epilogue on a conv output, routed: demod scale,
    noise (B, H, W, 1) already scaled by its weight, bias, lrelu*sqrt2, the
    post-activation adds and the optional second noise/bias/lrelu stage
    (the SMART tail), all in one K6 pass (`conv_epilogue`)."""
    return conv_epilogue(z, out_scale, noise, bias, act, post_add, noise2,
                         bias2, act2)


def dense_conv_epilogue_plain(x, w, pads, in_scale=None, out_scale=None,
                              noise=None, bias=None, act=True, post_add=(),
                              noise2=None, bias2=None, act2=False):
    """What K1e computes, in plain torch: `dense_conv_plain`, then
    `epilogue_plain_chain`."""
    return epilogue_plain_chain(dense_conv_plain(x, w, pads, in_scale),
                                out_scale, noise, bias, act, tuple(post_add),
                                noise2, bias2, act2).contiguous()


def _dense_conv_epi_forward(x, w, pads, isc, osc, nz, bias, act, post, nz2,
                            bias2, act2, want_mask=False):
    """The forward primitive: the plain version for CPU tensors, K1e for
    CUDA tensors. Returns (y, mask): with want_mask, mask is the bool
    (B, OH, OW, Co) sign of the first stage's pre-activation, else None."""
    if x.device.type == "cpu":
        if not want_mask:
            return dense_conv_epilogue_plain(x, w, pads, isc, osc, nz, bias,
                                             act, post, nz2, bias2,
                                             act2), None
        u = epilogue_plain_chain(dense_conv_plain(x, w, pads, isc), osc, nz,
                                 bias, act=False)
        y = epilogue_plain_chain(u, act=act, post_add=post, noise2=nz2,
                                 bias2=bias2, act2=act2)
        return y.contiguous(), u >= 0
    name = "dense_conv_epilogue"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _build.check_cuda_inputs(name, x, w, isc, osc, nz, bias, nz2, bias2,
                             *post)
    oh, ow = _out_shape(name, x, w, pads, isc)
    b, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    want = {"out_scale": (osc, (b, co)), "noise": (nz, (b, oh, ow, 1)),
            "bias": (bias, (co,)), "noise2": (nz2, (b, oh, ow, 1)),
            "bias2": (bias2, (co,))}
    for key, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, want {shape}")
    if len(post) > MAX_POST or any(tuple(p.shape) != (b, oh, ow, co)
                                   for p in post):
        raise ValueError(f"{name}: post_add {[tuple(p.shape) for p in post]};"
                         f" at most {MAX_POST} of shape {(b, oh, ow, co)}")
    py0, _, px0, _ = _norm_pads(pads)
    posts = list(post) + [None] * (MAX_POST - len(post))
    y = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    mask = (torch.empty((b, oh, ow, co), dtype=torch.bool, device=x.device)
            if want_mask else None)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_dense_conv_epi", x.data_ptr(), w.data_ptr(),
                 _build.ptr(isc), y.data_ptr(), _build.ptr(osc),
                 _build.ptr(nz), _build.ptr(bias), _build.ptr(posts[0]),
                 _build.ptr(posts[1]), _build.ptr(nz2), _build.ptr(bias2),
                 _build.ptr(mask), len(post), int(act), int(act2),
                 _build.dtype_code(x), b, h, wd, ci, co, kh, kw, py0, px0,
                 oh, ow, _build.stream_of(x))
    dense_conv_epilogue.launches += 1
    return y, mask


def _unact(y: torch.Tensor, act: bool) -> torch.Tensor:
    """Invert lrelu*sqrt2 elementwise (`_unact`, pallas_conv.py:402)."""
    return torch.where(y >= 0, y, y / 0.2) / SQRT2 if act else y


class _DenseConvEpi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pads, act, act2, x, w, isc, osc, nz, bias, nz2, bias2,
                *post):
        has2 = has_stage2(nz2, bias2, act2)
        want_mask = (act and (has2 or bool(post))
                     and any(ctx.needs_input_grad))
        y, mask = _dense_conv_epi_forward(x, w, pads, isc, osc, nz, bias,
                                          act, post, nz2, bias2, act2,
                                          want_mask)
        ctx.save_for_backward(x, w, isc, osc, nz, bias, nz2, bias2, y, mask,
                              *post)
        ctx.pads, ctx.act, ctx.act2 = pads, act, act2
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, isc, osc, nz, bias, nz2, bias2, y, mask, *post = \
            ctx.saved_tensors
        act, act2 = ctx.act, ctx.act2
        has2 = has_stage2(nz2, bias2, act2)
        if has2 and post:
            raise ValueError("dense_conv_epilogue backward: a second stage "
                             "together with post_add has no gradient (as in "
                             "the JAX package)")
        dnz2 = dbias2 = None
        if has2:
            du2, dnz2, dbias2 = stage2_grads(g, y, nz2, bias2, act2)
            # the stage-1 activated value: invert stage 2 on y
            v = _unact(y, act2)
            if nz2 is not None:
                v = v - nz2
            if bias2 is not None:
                v = v - bias2.reshape(1, 1, 1, -1)
            g1 = du2
        else:
            v = y
            for p in post:
                v = v - p
            g1 = g
        # the first activation's slope: from the kernel's sign mask where
        # it kept one (something was added after it), else from the value
        du = (g1 * act_slope(v if mask is None else mask, g.dtype) if act
              else g1)
        dbias = sum_f32(du, (0, 1, 2), bias.dtype) if bias is not None \
            else None
        dnz = du.sum(dim=-1, keepdim=True) if nz is not None else None
        dosc = None
        dz = du
        if osc is not None:
            u = _unact(v, act)
            if nz is not None:
                u = u - nz
            if bias is not None:
                u = u - bias.reshape(1, 1, 1, -1)
            z = u / osc[:, None, None, :]
            dosc = sum_f32(du * z, (1, 2), osc.dtype)
            dz = du * osc[:, None, None, :]
        need = ctx.needs_input_grad
        dx, dw, dis = _conv_grads(x, w, isc, ctx.pads, dz, need[3], need[4],
                                  need[5])
        dpost = tuple(g for _ in post)
        return (None, None, None, dx, dw, dis, dosc, dnz, dbias, dnz2,
                dbias2, *dpost)


def dense_conv_epilogue(x: torch.Tensor, w: torch.Tensor, pads,
                        in_scale=None, out_scale=None, noise=None, bias=None,
                        act: bool = True, post_add=(), noise2=None,
                        bias2=None, act2: bool = False) -> torch.Tensor:
    """K1e: `dense_conv` with the styled epilogue in the store (see the
    module docstring). Every tensor in x's dtype and contiguous;
    differentiable in each of them."""
    py0, py1, px0, px1 = _norm_pads(pads)
    return _DenseConvEpi.apply(((py0, py1), (px0, px1)), bool(act),
                               bool(act2), x, w, in_scale, out_scale, noise,
                               bias, noise2, bias2, *post_add)


dense_conv_epilogue.launches = 0


def conv2d_dense_epilogue(x: torch.Tensor, w: torch.Tensor, pads,
                          in_scale=None, out_scale=None, noise=None,
                          bias=None, act: bool = True, post_add=(),
                          noise2=None, bias2=None,
                          act2: bool = False) -> torch.Tensor:
    """The styled conv with its epilogue (`conv2d_dense_epilogue`,
    pallas_conv.py:524): with `VSPBFR_FUSED_EPI=1` one K1e launch, the
    epilogue operands cast to x's dtype as the JAX wrapper casts them;
    otherwise K1 followed by `apply_epilogue` (K6)."""
    post_add = tuple(post_add)
    if not fused_epi_enabled():
        return apply_epilogue(dense_conv(x.contiguous(),
                                         w.to(x.dtype).contiguous(), pads,
                                         in_scale),
                              out_scale, noise, bias, act, post_add, noise2,
                              bias2, act2)

    def cast(t):
        return None if t is None else t.to(x.dtype).contiguous()

    return dense_conv_epilogue(
        x.contiguous(), cast(w), pads, cast(in_scale), cast(out_scale),
        cast(noise), cast(bias), act, tuple(cast(p) for p in post_add),
        cast(noise2), cast(bias2), act2)
