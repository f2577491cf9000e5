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
The space-to-depth layout is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.ops.d2s import d2s
from vspbfr_tpu_torch.ops.dense_conv import (
    apply_epilogue,
    conv2d_dense_epilogue,
    conv_nhwc,
    dense_conv,
)
from vspbfr_tpu_torch.ops.dilated_conv import dilated_multi_conv
from vspbfr_tpu_torch.ops.upfirdn2d import blur as _blur


def _pads(padding):
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return padding


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
                            pad: tuple, stride: int = 2) -> torch.Tensor:
    """blur(x, taps, pad) then conv(w, stride) as ONE strided conv with the
    composed kernel."""
    e = compose_blur_kernel(w, taps)
    return conv_nhwc(x, e, stride, ((pad[0], pad[1]), (pad[0], pad[1])))


def _map_up(dk: int, c0: int):
    """Transposed stride-2 composed op y[j] = sum_i D[j + c0 - 2i] x[i] on
    an unpacked input: output phase a in [0, 2) -> [(u, t)] taps
    (`ops/packed.py:165`, packed_in=False)."""
    def m(a, e):
        del e  # single input phase
        return [(-((t - a - c0) // 2), t) for t in range(dk)
                if (t - a - c0) % 2 == 0]
    return m


def _assemble2(d2: torch.Tensor, map_y, map_x, n_in_ph: int, n_out_ph: int):
    """2D phase-kernel assembly (`ops/packed.py:114`): returns the kernel
    (KpY, KpX, n_in_ph^2*Ci, n_out_ph^2*Co), pad_y and pad_x. Built as one
    contraction of d2 with a 0/1 selection tensor made in numpy."""
    dky, dkx, ci, co = d2.shape

    def collect(m):
        out = {(a, e): m(a, e) for a in range(n_out_ph)
               for e in range(n_in_ph)}
        us = [u for lst in out.values() for u, _ in lst]
        return out, min(us), max(us)

    my, y0, y1 = collect(map_y)
    mx, x0, x1 = collect(map_x)
    kpy, kpx = y1 - y0 + 1, x1 - x0 + 1
    sel = np.zeros((kpy, kpx, n_in_ph, n_in_ph, n_out_ph, n_out_ph, dky, dkx),
                   np.float32)
    for (ay, ey), ly in my.items():
        for (ax, ex), lx in mx.items():
            for uy, ty in ly:
                for ux, tx in lx:
                    sel[uy - y0, ux - x0, ey, ex, ay, ax, ty, tx] += 1.0
    s = torch.as_tensor(sel, device=d2.device)
    wp = torch.einsum("uvefabst,stio->uvefiabo", s, d2.float())
    wp = wp.reshape(kpy, kpx, n_in_ph * n_in_ph * ci, n_out_ph * n_out_ph * co)
    return wp.to(d2.dtype), (-y0, y1), (-x0, x1)


def up_conv_blur_unpacked(x: torch.Tensor, w: torch.Tensor,
                          taps: tuple) -> torch.Tensor:
    """StyleGAN2 up path (stride-2 transposed conv + FIR blur) as the
    subpixel composed conv on K1, emitting the 4 output phases as channel
    groups, then the phase interleave K3. x (B, h, w, Ci) -> (B, 2h, 2w, Co)."""
    k, lk, factor = w.shape[0], len(taps), 2
    d2 = compose_blur_kernel(w, taps, gain=float(factor ** 2))
    p = (lk - factor) - (k - 1)
    pad0 = (p + 1) // 2 + factor - 1
    m = _map_up(k + lk - 1, lk - 1 - pad0)
    wp, pady, padx = _assemble2(d2, m, m, 1, 2)
    out4 = dense_conv(x.contiguous(), wp.to(x.dtype).contiguous(), (pady, padx))
    return d2s(out4, w.shape[3])


def demod_coeffs(w: torch.Tensor, style: torch.Tensor, scale: float,
                 eps: float = 1e-8) -> torch.Tensor:
    """Per-(sample, out-channel) rsqrt(sum((scale*W*s)^2) + eps).
    w (kh, kw, c_in, c_out), style (B, c_in) -> (B, c_out)."""
    w2sum = ((scale * w) ** 2).sum(dim=(0, 1))
    return torch.rsqrt((style ** 2) @ w2sum.to(style.dtype) + eps)


def modulated_conv2d_multi(x: torch.Tensor, ws, rates, style: torch.Tensor,
                           eps: float = 1e-8) -> torch.Tensor:
    """All of SMART's stride-1 3x3 dilated branches in one K2 launch,
    outputs concatenated, demodulation applied at the store."""
    c_in, k = ws[0].shape[2], ws[0].shape[0]
    scale = 1.0 / ((c_in * k * k) ** 0.5)
    dv = torch.cat([demod_coeffs(w, style, scale, eps) for w in ws], -1)
    dv = dv.to(x.dtype).contiguous()
    return dilated_multi_conv(
        x.contiguous(), [(scale * w).to(x.dtype).contiguous() for w in ws],
        tuple(rates), in_scale=style.to(x.dtype).contiguous(), out_scale=dv)


def modulated_conv2d(x: torch.Tensor, w: torch.Tensor, style: torch.Tensor, *,
                     demodulate: bool = True, up: bool = False,
                     down: bool = False, dilation: int = 1,
                     blur_kernel: tuple | None = None, eps: float = 1e-8,
                     epilogue=None):
    """Style-modulated conv. x (B, H, W, Cin), w (k, k, Cin, Cout), style
    (B, Cin) already affine-mapped; 1/sqrt(fan_in) is applied here.

    epilogue: optional dict(noise=, bias=, act=, post_add=) applied after
    the demodulation (see `apply_epilogue`); the return value is then the
    activated tensor."""
    kh, kw, c_in, c_out = w.shape
    if kh != kw:
        raise ValueError("square kernels only")
    k = kh
    scale = 1.0 / ((c_in * k * k) ** 0.5)
    d = demod_coeffs(w, style, scale, eps) if demodulate else None
    ws = (scale * w).to(x.dtype)
    sty = style.to(x.dtype)

    if up:
        xs = x * sty[:, None, None, :]
        if (dilation == 1 and isinstance(blur_kernel, (tuple, list))
                and c_out < 128):
            out = up_conv_blur_unpacked(xs, ws, tuple(blur_kernel))
        else:
            out = conv_transpose2d(xs, ws, stride=2, padding=0,
                                   dilation=dilation)
            if blur_kernel is not None:
                factor = 2
                p = (len(blur_kernel) - factor) - (k - 1) * dilation
                out = _blur(out, blur_kernel,
                            pad=((p + 1) // 2 + factor - 1, p // 2 + 1),
                            upsample_factor=factor)
    elif down:
        xs = x * sty[:, None, None, :]
        factor = 2
        p = (len(blur_kernel) - factor) + (k - 1)
        pad0, pad1 = (p + 1) // 2, p // 2
        if dilation == 1 and isinstance(blur_kernel, (tuple, list)):
            out = fused_blur_strided_conv(xs, ws, tuple(blur_kernel),
                                          (pad0, pad1), stride=2)
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
            if epilogue is not None:
                return conv2d_dense_epilogue(
                    x, ws, _pads(padding), in_scale=sty.contiguous(),
                    out_scale=d, **epilogue)
            out = dense_conv(x.contiguous(), ws.contiguous(),
                             _pads(padding), in_scale=sty.contiguous())
        else:
            out = conv2d(x * sty[:, None, None, :], ws, padding=padding,
                         dilation=dilation)

    if epilogue is not None:
        return apply_epilogue(out, out_scale=d, **epilogue)
    if demodulate:
        out = out * d[:, None, None, :]
    return out
