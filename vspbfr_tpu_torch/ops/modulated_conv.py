"""StyleGAN2 modulated convolution, unpacked NHWC / HWIO.

Counterpart of the unpacked branch of `vspbfr_tpu/ops/modulated_conv.py`
(plus the two weight-assembly helpers of `vspbfr_tpu/ops/packed.py` that
the unpacked subpixel up-conv needs). The input-scaled formulation

    y = demod(style) * conv(x * style, W / sqrt(fan_in))

routes as the JAX package does: stride-1 dilation-1 convs to K1
(`dense_conv`, with the style folded in as `in_scale`; with an epilogue,
to `conv2d_dense_epilogue`, which is K1e under `VSPBFR_FUSED_EPI=1` and
K1 then K6 otherwise; the up and down convs' epilogue is K6,
`apply_epilogue`),
SMART's dilated branches to K2 (`dilated_multi_conv`), and up-convs with
c_out < 128 to the subpixel composed conv (K1) followed by the phase
interleave K3 (`d2s`).
Strided and dilated single convs and the c_out >= 128 transposed conv go to
`F.conv2d` / `F.conv_transpose2d`, as the JAX package leaves them to XLA.

With `packed_in` / `packed_out` the conv runs on the space-to-depth layout
(`ops/packed.py`), with the same parameters: `_modulated_conv2d_packed`
routes each form to its packed op, and SMART's four branches become two
launches, `modulated_conv2d_d12_packed` (dilations 1 and 2: one K1 on the
(3, 3, 4C, 8Cb) assembled kernel, the demod as the epilogue's out_scale)
and `modulated_conv2d_d48_packed` (dilations 4 and 8: one grouped K2).

With `spatial` (a `parallel.spatial.Spatial`) the conv runs on this
rank's rows of an H-sharded map, by the same route. A packed conv (either
side packed, the unpacked-packed transitions included) hands it to its
packed form (`ops/packed.py`: windows in packed rows); SMART's packed
pair takes the window of the assembled kernel's pads (d1 + d2, K1) and of
4 packed rows (d4 + d8, grouped K2, the middle rows kept). Unpacked, a
conv that pads H by (top, bottom) takes the window of those rows around
this rank's (`window_rows`) and pads H by nothing (K1, K1e, the subpixel
up-conv's K1 + K3, the blurred stride-2 down-conv, the dilated convs); the
transposed up-conv + blur and SMART's K2 run on a wider window and keep
the middle rows. Where neither the input's nor the output's resolution is
sharded the context is dropped, and the call is the unsharded one. Every
use of the style, the weight and the epilogue is on this rank's rows (an
up-conv scales its window of a whole input; a down-conv to a whole output
runs its epilogue on its rows before `Spatial.settle` gathers them), so
their gradients are this rank's parts, which the model axis sums
(`parallel/spatial.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.ops import packed as pk
from vspbfr_tpu_torch.ops.d2s import d2s
from vspbfr_tpu_torch.ops.dense_conv import (
    apply_epilogue,
    conv2d_dense_epilogue,
    conv_nhwc,
    dense_conv,
)
from vspbfr_tpu_torch.ops.dilated_conv import (
    dilated_multi_conv,
    dilated_pair_conv,
)
from vspbfr_tpu_torch.ops.upfirdn2d import blur as _blur


def _pads(padding):
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return padding


def window_rows(x: torch.Tensor, top: int, bottom: int, spatial):
    """(x, H pads) for a conv that pads H by (top, bottom): x and (top,
    bottom) without `spatial`; with it, this rank's rows of x with the
    `top` / `bottom` rows around them (`Spatial.window`) and no H pads."""
    return pk._window(x, (top, bottom), spatial, False)


def on_rows(x: torch.Tensor, fn, reach: int, up: int, spatial,
            packed: bool = False):
    """fn(x), or with `spatial` fn on this rank's rows (`Spatial.rows_op`:
    the window of `reach` rows each side, the middle rows kept; `packed`:
    x and the output packed, the rows packed rows)."""
    if spatial is None:
        return fn(x)
    return spatial.rows_op(x, fn, reach, up=up, packed=packed)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Plain conv, NHWC x HWIO -> NHWC; padding int or ((t, b), (l, r)).
    Stride-1, dilation-1, groups-1 convs run on K1."""
    pads = _pads(padding)
    if stride == 1 and dilation == 1 and groups == 1:
        return dense_conv(x.contiguous(), w.to(x.dtype).contiguous(), pads)
    return conv_nhwc(x, w, stride, pads, dilation, groups)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: int = 2,
                     padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """torch-semantics conv_transpose2d for an HWIO weight (I=c_in)."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                             w.permute(2, 3, 0, 1).to(x.dtype), stride=stride,
                             padding=padding, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def compose_blur_kernel(w: torch.Tensor, taps: tuple,
                        gain: float = 1.0) -> torch.Tensor:
    """(k+lk-1)^2 HWIO kernel E = full correlation of W with the normalized
    separable FIR times gain; computed in float32."""
    k, _, ci, co = w.shape
    lk = len(taps)
    t = np.asarray(taps, np.float64)
    k2d = np.outer(t, t)
    kc = torch.tensor(k2d / k2d.sum() * gain, dtype=torch.float32,
                      device=w.device)
    wj = w.float().permute(2, 3, 0, 1).reshape(ci * co, 1, k, k)
    e = F.conv2d(wj, kc[None, None], padding=lk - 1)
    dk = k + lk - 1
    return e.reshape(ci, co, dk, dk).permute(2, 3, 0, 1).to(w.dtype)


def fused_blur_strided_conv(x: torch.Tensor, w: torch.Tensor, taps: tuple,
                            pad: tuple, stride: int = 2,
                            spatial=None) -> torch.Tensor:
    """blur(x, taps, pad) then conv(w, stride) as ONE strided conv with the
    composed kernel. With `spatial`: this rank's rows of the output (the
    caller settles them after its epilogue)."""
    e = compose_blur_kernel(w, taps)
    xw, pady = window_rows(x, pad[0], pad[1], spatial)
    return conv_nhwc(xw, e, stride, (pady, (pad[0], pad[1])))


def up_conv_blur_unpacked(x: torch.Tensor, w: torch.Tensor,
                          taps: tuple, spatial=None,
                          style=None) -> torch.Tensor:
    """StyleGAN2 up path (stride-2 transposed conv + FIR blur) as the
    subpixel composed conv on K1, emitting the 4 output phases as channel
    groups, then the phase interleave K3. x (B, h, w, Ci) -> (B, 2h, 2w, Co),
    scaled by `style` (B, Ci) first. With `spatial`: this rank's 2h/n
    output rows (the style scales the window)."""
    wp, pady, padx = pk.assembled_kernel(w, "up", taps)
    x, pady = window_rows(x, *pady, spatial)
    if style is not None:
        x = x * style[:, None, None, :]
    out4 = dense_conv(x.contiguous(), wp.to(x.dtype).contiguous(), (pady, padx))
    return d2s(out4, w.shape[3])


def _transpose_blur(xs, ws, blur_kernel, dilation: int = 1):
    """The up path as the stride-2 transposed conv, then the FIR blur (the
    c_out >= 128 form, as the JAX package leaves it to XLA)."""
    out = conv_transpose2d(xs, ws, stride=2, padding=0, dilation=dilation)
    if blur_kernel is None:
        return out
    factor, k = 2, ws.shape[0]
    p = (len(blur_kernel) - factor) - (k - 1) * dilation
    return _blur(out, blur_kernel, pad=((p + 1) // 2 + factor - 1, p // 2 + 1),
                 upsample_factor=factor)


def demod_coeffs(w: torch.Tensor, style: torch.Tensor, scale: float,
                 eps: float = 1e-8) -> torch.Tensor:
    """Per-(sample, out-channel) rsqrt(sum((scale*W*s)^2) + eps).
    w (kh, kw, c_in, c_out), style (B, c_in) -> (B, c_out)."""
    w2sum = ((scale * w) ** 2).sum(dim=(0, 1))
    return torch.rsqrt((style ** 2) @ w2sum.to(style.dtype) + eps)


def modulated_conv2d_multi(x: torch.Tensor, ws, rates, style: torch.Tensor,
                           eps: float = 1e-8, spatial=None) -> torch.Tensor:
    """All of SMART's stride-1 3x3 dilated branches in one K2 launch,
    outputs concatenated, demodulation applied at the store. With
    `spatial` at a sharded resolution: K2 on the window of the largest
    dilation's rows each side, the middle rows kept."""
    c_in, k = ws[0].shape[2], ws[0].shape[0]
    scale = 1.0 / ((c_in * k * k) ** 0.5)
    dv = torch.cat([demod_coeffs(w, style, scale, eps) for w in ws], -1)
    dv = dv.to(x.dtype).contiguous()
    wsc = [(scale * w).to(x.dtype).contiguous() for w in ws]
    sty = style.to(x.dtype).contiguous()
    return on_rows(x, lambda t: dilated_multi_conv(
        t.contiguous(), wsc, tuple(rates), in_scale=sty, out_scale=dv),
        max(rates) * (k // 2), 1, spatial)


def d12_kernel(w1: torch.Tensor, w2: torch.Tensor):
    """(kernel, pad_y, pad_x) of the packed d1 + d2 conv: the assembled
    dilation-1 kernel of w1 beside w2's block-diagonal one (dilation 2 is
    phase-diagonal at the half grid's dilation 1), (3, 3, 4C, 8Cb)."""
    c_in, cb = w1.shape[2], w1.shape[3]
    wp1, pady, padx = pk.assembled_kernel(w1, "s1")
    wd2 = torch.zeros((3, 3, 4 * c_in, 4 * cb), dtype=w2.dtype,
                      device=w2.device)
    for ph in range(4):
        wd2[:, :, ph * c_in:(ph + 1) * c_in, ph * cb:(ph + 1) * cb] = w2
    return torch.cat([wp1, wd2], dim=3), pady, padx


def modulated_conv2d_d12_packed(x: torch.Tensor, w1: torch.Tensor,
                                w2: torch.Tensor, style: torch.Tensor,
                                eps: float = 1e-8,
                                spatial=None) -> torch.Tensor:
    """SMART's dilation-1 and dilation-2 branches as ONE packed conv
    (`modulated_conv2d_d12_packed`, modulated_conv.py:201): on the half
    grid both are 3x3 pad-1 kernels (d=1 mixes phases, d=2 is phase-
    diagonal), concatenated on the output channels into one (3, 3, 4C, 8Cb)
    K1 launch; the demod is the epilogue's out_scale. Output channels:
    [d1 phase-major 4Cb | d2 phase-major 4Cb]. x (B, h, w, 4C); w1, w2
    (3, 3, C, Cb); style (B, C). spatial: this rank's rows (x sharded)."""
    scale = 1.0 / ((w1.shape[2] * 9) ** 0.5)
    wp, pady, padx = d12_kernel(scale * w1, scale * w2)
    dv = torch.cat([pk.pack_vector(demod_coeffs(w, style, scale, eps))
                    for w in (w1, w2)], -1)
    x, pady = pk._window(x, pady, spatial, True)
    return pk._conv(x, wp.to(x.dtype), pady, padx,
                    in_scale=pk.pack_vector(style).to(x.dtype).contiguous(),
                    epi=dict(out_scale=dv, act=False))


def modulated_conv2d_d48_packed(x: torch.Tensor, w4: torch.Tensor,
                                w8: torch.Tensor, style: torch.Tensor,
                                eps: float = 1e-8,
                                spatial=None) -> torch.Tensor:
    """SMART's dilation-4 and dilation-8 branches as ONE grouped K2 launch
    (`modulated_conv2d_d48_packed`, modulated_conv.py:242): on the half
    grid both are phase-diagonal convs at dilations 2 and 4, the weights
    shared by the four phase groups, the demod at the store. Output
    channels: [d4 phase-major 4Cb | d8 phase-major 4Cb]. spatial: K2 on
    the window of 4 packed rows each side, the middle rows kept."""
    c_in = w4.shape[2]
    scale = 1.0 / ((c_in * 9) ** 0.5)
    dv = torch.cat([pk.pack_vector(demod_coeffs(w, style, scale, eps))
                    for w in (w4, w8)], -1)
    w4s = (scale * w4).to(x.dtype).contiguous()
    w8s = (scale * w8).to(x.dtype).contiguous()
    sty = pk.pack_vector(style).to(x.dtype).contiguous()
    dv = dv.to(x.dtype).contiguous()
    return on_rows(x, lambda t: dilated_pair_conv(
        t.contiguous(), w4s, w8s, 2, 4, groups=4, in_scale=sty,
        out_scale=dv), 4, 1, spatial, packed=True)


def _modulated_conv2d_packed(x, w, style, *, demodulate, up, down, dilation,
                             blur_kernel, eps, packed_in, packed_out,
                             epilogue, spatial=None):
    """The packed-layout modulated conv (`_modulated_conv2d_packed`,
    modulated_conv.py:307): x (B, h, w, 4Ci) when packed_in else (B, H, W,
    Ci); the output packed iff packed_out. The style rides the conv's
    in_scale, the demod the epilogue's out_scale. spatial: the packed form
    on this rank's rows (a down-conv settles its output)."""
    k, _, c_in, _ = w.shape
    scale = 1.0 / ((c_in * k * k) ** 0.5)
    dv = None
    if demodulate:
        d = demod_coeffs(w, style, scale, eps)
        dv = pk.pack_vector(d) if packed_out else d
    sty = (pk.pack_vector(style) if packed_in else style).to(x.dtype)
    sty = sty.contiguous()
    ws = (scale * w).to(x.dtype)
    epi = dict(epilogue, out_scale=dv) if epilogue is not None else None
    if up:
        if not packed_out or dilation != 1:
            raise ValueError("packed up-conv: packed output, dilation 1")
        out = pk.up_conv_blur_packed(x, ws, tuple(blur_kernel),
                                     packed_in=packed_in, in_scale=sty,
                                     epi=epi, spatial=spatial)
    elif down:
        if not packed_in or dilation != 1:
            raise ValueError("packed down-conv: packed input, dilation 1")
        fn = (pk.blur_down_conv_packed_packed if packed_out
              else pk.blur_down_conv_packed)
        out = fn(x, ws, tuple(blur_kernel), in_scale=sty, epi=epi,
                 spatial=spatial)
    else:
        if not (packed_in and packed_out):
            raise ValueError("packed stride-1 conv: packed input and output")
        if k == 1:
            out = pk.conv1x1_packed(x, ws, in_scale=sty, epi=epi)
        else:
            out = pk.conv2d_packed(x, ws, dilation=dilation, in_scale=sty,
                                   epi=epi, spatial=spatial)
    if epilogue is not None or dv is None:
        return out
    return pk._epi_after(out, dict(out_scale=dv, act=False))


def modulated_conv2d(x: torch.Tensor, w: torch.Tensor, style: torch.Tensor, *,
                     demodulate: bool = True, up: bool = False,
                     down: bool = False, dilation: int = 1,
                     blur_kernel: tuple | None = None, eps: float = 1e-8,
                     packed_in: bool = False, packed_out: bool = False,
                     epilogue=None, spatial=None):
    """Style-modulated conv. x (B, H, W, Cin), w (k, k, Cin, Cout), style
    (B, Cin) already affine-mapped; 1/sqrt(fan_in) is applied here.
    packed_in / packed_out select the space-to-depth layout of the input
    and the output (the parameters are the same). spatial: a
    `parallel.spatial.Spatial` when the map may be H-sharded.

    epilogue: optional dict(noise=, bias=, act=, post_add=) applied after
    the demodulation (see `apply_epilogue`); the return value is then the
    activated tensor."""
    fir = isinstance(blur_kernel, (tuple, list))
    if spatial is not None:
        res = x.shape[2] * (2 if packed_in else 1)
        res_out = 2 * res if up else (res // 2 if down else res)
        if not (spatial.sharded(res) or spatial.sharded(res_out)):
            spatial = None
        elif (up or down) and (dilation != 1 or not fir):
            raise NotImplementedError("spatial sharding: up / down convs at "
                                      "dilation 1 with FIR taps only")
    if packed_in or packed_out:
        return _modulated_conv2d_packed(
            x, w, style, demodulate=demodulate, up=up, down=down,
            dilation=dilation, blur_kernel=blur_kernel, eps=eps,
            packed_in=packed_in, packed_out=packed_out, epilogue=epilogue,
            spatial=spatial)
    kh, kw, c_in, c_out = w.shape
    if kh != kw:
        raise ValueError("square kernels only")
    k = kh
    scale = 1.0 / ((c_in * k * k) ** 0.5)
    d = demod_coeffs(w, style, scale, eps) if demodulate else None
    ws = (scale * w).to(x.dtype)
    sty = style.to(x.dtype)

    if up:
        if dilation == 1 and fir and c_out < 128:
            out = up_conv_blur_unpacked(x, ws, tuple(blur_kernel), spatial,
                                        style=sty)
        else:
            # sharded: a window of 2 rows each side (output row y reads
            # input rows (y - 3) / 2 .. (y + 2) / 2), the middle rows kept
            out = on_rows(x, lambda t: _transpose_blur(
                t * sty[:, None, None, :], ws, blur_kernel, dilation),
                2, 2, spatial)
    elif down:
        xs = x * sty[:, None, None, :]
        factor = 2
        p = (len(blur_kernel) - factor) + (k - 1)
        pad0, pad1 = (p + 1) // 2, p // 2
        if dilation == 1 and fir:
            out = fused_blur_strided_conv(xs, ws, tuple(blur_kernel),
                                          (pad0, pad1), stride=2,
                                          spatial=spatial)
        else:
            xs = _blur(xs, blur_kernel, pad=(pad0, pad1))
            out = conv2d(xs, ws, stride=2, padding=0, dilation=dilation)
    else:
        padding = ((k - 1) * dilation) // 2
        if k == 1 and c_out < 128:
            # lane-starved 1x1 (ToRGB): per-batch weight, as the JAX path
            wb = sty[:, :, None] * ws[0, 0]
            out = torch.einsum("bhwc,bco->bhwo", x, wb)
        elif dilation == 1:
            x, pady = window_rows(x, padding, padding, spatial)
            pads = (pady, (padding, padding))
            if epilogue is not None:
                return conv2d_dense_epilogue(
                    x, ws, pads, in_scale=sty.contiguous(), out_scale=d,
                    **epilogue)
            out = dense_conv(x.contiguous(), ws.contiguous(), pads,
                             in_scale=sty.contiguous())
        else:
            xs, pady = window_rows(x * sty[:, None, None, :], padding,
                                   padding, spatial)
            out = conv2d(xs, ws, padding=(pady, (padding, padding)),
                         dilation=dilation)

    if epilogue is not None:
        out = apply_epilogue(out, out_scale=d, **epilogue)
    elif demodulate:
        out = out * d[:, None, None, :]
    if down and spatial is not None:
        out = spatial.settle(out)
    return out
