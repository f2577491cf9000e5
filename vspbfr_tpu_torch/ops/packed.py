"""Space-to-depth packed layout: the layout converters and every conv form
the packed resolutions run.

Counterpart of `vspbfr_tpu/ops/packed.py`. A resolution at or above a
model's `packed_min_res` holds its feature maps as (B, R/2, R/2, 4C), the
channels phase-major:

    out[..., (2a+b)*C + c] = x[..., 2i+a, 2j+b, c]

and each conv becomes one conv on the packed tensor with a kernel
re-scattered from the unpacked one at call time, so the parameters and
checkpoints are the unpacked layout's:

  * stride-1 k x k conv, odd dilation -> one dense conv with the assembled
    (k', k', 4Ci, 4Co) kernel (`_map_s1`): K1, or with an epilogue K1 + K6
    (K1e under `VSPBFR_FUSED_EPI=1`);
  * even dilation d -> phases never mix: one grouped K2 launch (`groups`
    = 4, the weight shared by the four phases) at dilation d/2, never the
    block-diagonal dense kernel, which would do 4x the multiply-adds;
  * up-conv + blur -> the composed transposed kernel subsampled per output
    phase, a dense conv emitting the packed output directly (K1; from a
    packed input, 16 phases and one K3 interleave);
  * blur + stride-2 conv from a packed input -> a stride-1 dense conv (K1)
    to an unpacked output, or one stride-2 conv to a packed output
    (`F.conv2d`, as the JAX package leaves it to XLA);
  * 1x1 conv -> phases independent: an einsum or matmul (no Pallas kernel
    in the JAX package either).

The layout converters are K4 (`space_to_depth`, `s2d` with inner = C) and
K3 (`depth_to_space`, `d2s` with inner = C / 4): `gather_s2d` /
`interleave_d2s` of the JAX package with inner = C are exactly this
layout. An epilogue after a form that does not end in a dense conv is one
K6 pass (`_epi_after`, `apply_epilogue`).

The kernel assembly (`_assemble2`) is one contraction of the weight with a
static 0/1 selection tensor, so it is differentiable (training reaches the
unpacked parameters through it) and runs on the weight's device.

`spatial` (a `parallel.spatial.Spatial`, given only where the input's or
the output's resolution is H-sharded) runs a form on this rank's rows, in
the map's own rows (`parallel/spatial.py`): the assembled kernel's H pads
become the window's top and bottom rows with no H padding (the stride-2
packed-to-packed down-conv's (top, bottom - 1)); an even dilation's
grouped K2 runs on the window of dilation / 2 rows and keeps the middle
rows; the down-convs run their epilogue on their rows, then `settle`
gathers an output below the threshold. The 1x1 form needs no halo.
"""

from __future__ import annotations

import numpy as np
import torch

from vspbfr_tpu_torch.ops.d2s import d2s, s2d
from vspbfr_tpu_torch.ops.dense_conv import (
    apply_epilogue,
    conv2d_dense_epilogue,
    conv_nhwc,
    dense_conv,
)
from vspbfr_tpu_torch.ops.dilated_conv import dilated_multi_conv


def _conv(x, wp, pady, padx, in_scale=None, epi=None) -> torch.Tensor:
    """Stride-1 dense conv: K1, or with the styled epilogue dict `epi`
    (out_scale / noise / bias / act / post_add / noise2 / bias2 / act2)
    `conv2d_dense_epilogue`. in_scale (B, Ci) in x's dtype."""
    pads = (tuple(pady), tuple(padx))
    if epi is not None:
        return conv2d_dense_epilogue(x, wp, pads, in_scale=in_scale, **epi)
    return dense_conv(x.contiguous(), wp.to(x.dtype).contiguous(), pads,
                      in_scale)


def _window(x, pady, spatial, packed: bool):
    """(x, H pads) for a conv that pads H by pady: x and pady without
    `spatial`; with it, this rank's rows of x with pady's rows around them
    (`Spatial.window`, in x's own rows) and no H pads."""
    if spatial is None:
        return x, tuple(pady)
    return spatial.window(x, pady[0], pady[1], packed), (0, 0)


def _epi_after(out, epi):
    """The epilogue dict on an already computed conv output: one K6 pass
    (`apply_epilogue`)."""
    if epi is None:
        return out
    return apply_epilogue(out.contiguous(), **epi)


# ---------------------------------------------------------------------------
# layout converters
# ---------------------------------------------------------------------------

def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2h, 2w, C) -> (B, h, w, 4C), phase-major (K4 on the card)."""
    return s2d(x.contiguous(), x.shape[-1])


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_depth: (B, h, w, 4C) -> (B, 2h, 2w, C) (K3 on
    the card)."""
    return d2s(x.contiguous(), x.shape[-1] // 4)


def pack_vector(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector (bias, style, demod row) tiled over the four
    phase groups: (..., C) -> (..., 4C)."""
    return torch.cat([v, v, v, v], dim=-1)


# ---------------------------------------------------------------------------
# kernel assembly
#
# Per spatial axis every form is y[o] = sum_t D[t] x[alpha*o + t - off];
# writing the coordinates as 2 * grid + phase turns it into a plain conv on
# the half grid whose taps are D re-indexed by phase. A map takes (output
# phase a, input phase e) to the list of (grid offset u, tap t) it reads.
# ---------------------------------------------------------------------------

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


def _map_s1(k: int, pad: int, dil: int = 1):
    """Stride-1 conv y[o] = sum_t D[t] x[o + t*dil - pad], packed in and
    out (odd dilations)."""
    def m(a, e):
        return [((a + t * dil - pad - e) // 2, t) for t in range(k)
                if (a + t * dil - pad - e) % 2 == 0]
    return m


def _map_up(dk: int, c0: int, packed_in: bool):
    """Transposed stride-2 composed op y[j] = sum_i D[j + c0 - 2i] x[i]:
    unpacked input -> output phases a in [0, 2); packed input (phases e in
    [0, 2)) -> output phases A in [0, 4) on the input's grid."""
    if not packed_in:
        def m(a, e):
            del e  # one input phase
            return [(-((t - a - c0) // 2), t) for t in range(dk)
                    if (t - a - c0) % 2 == 0]
        return m

    def m4(a, e):
        return [(-((t - a - c0 + 2 * e) // 4), t) for t in range(dk)
                if (t - a - c0 + 2 * e) % 4 == 0]
    return m4


def _map_down(dk: int, pad0: int):
    """Strided composed op y[o] = sum_t D[t] x[2o + t - pad0] from a packed
    input (phases e in [0, 2)) to an unpacked output on the same grid."""
    def m(a, e):
        del a  # one output phase
        return [((t - e - pad0) // 2, t) for t in range(dk)
                if (t - e - pad0) % 2 == 0]
    return m


def _map_down_packed(dk: int, pad0: int):
    """The same op to a packed output: y[2q+a] reads x[4q + 2a + t - pad0],
    i.e. grid offset a + (t - pad0 - e) / 2 on a stride-2 conv."""
    def m(a, e):
        return [(a + (t - pad0 - e) // 2, t) for t in range(dk)
                if (t - pad0 - e) % 2 == 0]
    return m


def _phase16_perm(c: int) -> np.ndarray:
    """Output-channel order of a 16-phase kernel (`_assemble2` gives (Ay,
    Ax) with A = 2g + a) as (gy, gx, ay, ax, c), so that the g factor
    interleaves (K3) over the contiguous (ay, ax, c) block."""
    perm = np.empty(16 * c, np.int64)
    for gy in range(2):
        for gx in range(2):
            for ay in range(2):
                for ax in range(2):
                    new = (((gy * 2 + gx) * 2 + ay) * 2 + ax) * c
                    old = (((2 * gy + ay) * 4) + (2 * gx + ax)) * c
                    perm[new:new + c] = np.arange(old, old + c)
    return perm


def _up_taps(k: int, taps: tuple):
    """(composed kernel size, c0) of the StyleGAN2 up path's blur pads
    (`models/RestoreNet.py:297-312`)."""
    lk, factor = len(taps), 2
    p = (lk - factor) - (k - 1)
    pad0 = (p + 1) // 2 + factor - 1
    return k + lk - 1, lk - 1 - pad0


def _down_taps(k: int, taps: tuple):
    """(composed kernel size, pad0) of the down path's blur pads
    (`models/RestoreNet.py:398-418`)."""
    lk, factor = len(taps), 2
    p = (lk - factor) + (k - 1)
    return k + lk - 1, (p + 1) // 2


def assembled_kernel(w: torch.Tensor, form: str, taps: tuple = (1, 3, 3, 1),
                     dilation: int = 1):
    """(kernel, pad_y, pad_x) of the one conv a packed form runs, from the
    unpacked (k, k, Ci, Co) weight w (already scaled): "s1" a stride-1
    conv at an odd dilation, packed in and out (K1); "up" / "up_packed"
    the up-conv + blur from an unpacked / packed input to a packed output
    (K1; "up_packed" emits 16 phases, its output channels ordered for one
    K3 interleave); "down" the blur + stride-2 conv from a packed input to
    an unpacked output (K1); "down_packed" to a packed output (a stride-2
    conv)."""
    from vspbfr_tpu_torch.ops.modulated_conv import compose_blur_kernel

    k = w.shape[0]
    if form == "s1":
        m = _map_s1(k, ((k - 1) * dilation) // 2, dilation)
        return _assemble2(w, m, m, 2, 2)
    if form in ("up", "up_packed"):
        packed_in = form == "up_packed"
        m = _map_up(*_up_taps(k, taps), packed_in)
        wp, pady, padx = _assemble2(compose_blur_kernel(w, taps, gain=4.0),
                                    m, m, 2 if packed_in else 1,
                                    4 if packed_in else 2)
        if packed_in:
            wp = wp[..., torch.as_tensor(_phase16_perm(w.shape[3]),
                                         device=wp.device)]
        return wp, pady, padx
    dk, pad0 = _down_taps(k, taps)
    m = _map_down_packed(dk, pad0) if form == "down_packed" else _map_down(
        dk, pad0)
    return _assemble2(compose_blur_kernel(w, taps, gain=1.0), m, m, 2,
                      2 if form == "down_packed" else 1)


# ---------------------------------------------------------------------------
# packed ops
# ---------------------------------------------------------------------------

def conv2d_packed(x: torch.Tensor, w: torch.Tensor, dilation: int = 1,
                  in_ch_perm=None, in_scale: torch.Tensor | None = None,
                  epi=None, spatial=None) -> torch.Tensor:
    """Stride-1 'same' conv on a packed tensor == packed(conv(unpacked)).
    x (B, h, w, 4Ci); w (k, k, Ci, Co) the unpacked kernel; in_scale (B,
    4Ci) in x's dtype. in_ch_perm: a packed-input-channel permutation
    folded into the assembled kernel (x's channel j holds packed channel
    in_ch_perm[j]); odd dilations only. spatial: this rank's rows."""
    if dilation % 2 == 0:   # SMART's 3x3 branches: K2 checks the shape
        if in_ch_perm is not None:
            raise ValueError("conv2d_packed: in_ch_perm needs an odd "
                             "dilation")
        wd = w.to(x.dtype).contiguous()

        def grouped(t):
            return dilated_multi_conv(t.contiguous(), [wd], (dilation // 2,),
                                      groups=4, in_scale=in_scale)

        out = (grouped(x) if spatial is None else
               spatial.rows_op(x, grouped, dilation // 2, packed=True))
        return _epi_after(out, epi)
    wp, pady, padx = assembled_kernel(w, "s1", dilation=dilation)
    if in_ch_perm is not None:
        wp = wp[:, :, torch.tensor(in_ch_perm, device=wp.device)]
    x, pady = _window(x, pady, spatial, True)
    return _conv(x, wp, pady, padx, in_scale=in_scale, epi=epi)


def conv1x1_packed(x: torch.Tensor, w: torch.Tensor, in_ch_perm=None,
                   in_scale: torch.Tensor | None = None,
                   epi=None) -> torch.Tensor:
    """1x1 conv on the packed layout: the phases map independently with a
    shared weight. x (B, h, w, 4Ci); w (1, 1, Ci, Co) or (Ci, Co). With
    in_ch_perm the block-diagonal (4Ci, 4Co) weight, its rows permuted, is
    one matmul; in_scale (B, 4Ci) folds into a per-sample weight."""
    if w.dim() == 4:
        w = w[0, 0]
    b, h, wd, _ = x.shape
    ci, co = w.shape
    w = w.to(x.dtype)
    if in_ch_perm is not None:
        # the block-diagonal (4Ci, 4Co) weight, its rows permuted
        full = torch.block_diag(w, w, w, w)[torch.tensor(in_ch_perm,
                                                         device=w.device)]
        if in_scale is not None:
            wb = in_scale[:, :, None].to(x.dtype) * full
            return _epi_after(torch.einsum("bhwc,bco->bhwo", x, wb), epi)
        return _epi_after(x @ full, epi)
    if in_scale is not None:
        wb = in_scale.reshape(b, 4, ci)[:, :, :, None].to(x.dtype) * w
        out = torch.einsum("bhwpc,bpco->bhwpo", x.reshape(b, h, wd, 4, ci),
                           wb)
        return _epi_after(out.reshape(b, h, wd, 4 * co), epi)
    out = x.reshape(b, h, wd, 4, ci) @ w
    return _epi_after(out.reshape(b, h, wd, 4 * co), epi)


def up_conv_blur_packed(x: torch.Tensor, w: torch.Tensor, taps: tuple,
                        packed_in: bool,
                        in_scale: torch.Tensor | None = None,
                        epi=None, spatial=None) -> torch.Tensor:
    """StyleGAN2 up path (transposed stride-2 conv + FIR blur) emitting the
    packed output at 2x the resolution. packed_in False: x (B, h, w, Ci)
    -> (B, h, w, 4Co), the phase channels straight out of one dense conv
    (the epilogue rides it); packed_in True: x (B, h, w, 4Ci) -> (B, 2h,
    2w, 4Co), a 16-phase conv and one K3 interleave. spatial: this rank's
    output rows, from the window of a sharded or a whole input."""
    wp, pady, padx = assembled_kernel(w, "up_packed" if packed_in else "up",
                                      taps)
    x, pady = _window(x, pady, spatial, packed_in)
    if not packed_in:
        return _conv(x, wp, pady, padx, in_scale=in_scale, epi=epi)
    out16 = _conv(x, wp, pady, padx, in_scale=in_scale)
    return _epi_after(d2s(out16, 4 * w.shape[3]), epi)


def blur_down_conv_packed(x: torch.Tensor, w: torch.Tensor, taps: tuple,
                          in_scale: torch.Tensor | None = None,
                          epi=None, spatial=None) -> torch.Tensor:
    """StyleGAN2 down path (FIR blur + stride-2 conv) from a packed input:
    x (B, h, w, 4Ci) at res 2h -> (B, h, w, Co) unpacked at res h, one
    stride-1 dense conv. spatial: on this rank's rows, the epilogue's
    noise its rows (a block of them where the output is whole), then
    settled."""
    wp, pady, padx = assembled_kernel(w, "down", taps)
    x, pady = _window(x, pady, spatial, True)
    out = _conv(x, wp, pady, padx, in_scale=in_scale, epi=epi)
    return out if spatial is None else spatial.settle(out)


def blur_down_conv_packed_packed(x: torch.Tensor, w: torch.Tensor,
                                 taps: tuple,
                                 in_scale: torch.Tensor | None = None,
                                 epi=None, spatial=None) -> torch.Tensor:
    """The down path from a packed input to a packed output: x (B, h, w,
    4Ci) at res 2h -> (B, h/2, w/2, 4Co) at res h, one stride-2 conv on
    the packed grids (`F.conv2d`; the JAX package leaves it to XLA).
    spatial: as `blur_down_conv_packed`, the shard's h rows (even) to its
    h/2 output rows."""
    wp, (py0, py1), (px0, px1) = assembled_kernel(w, "down_packed", taps)
    # out[q] = sum_u K[u - u0] x[2q + u]: pads (-u0, u1 - 1) give h / 2;
    # on rows the window's first row is the shard's first minus u0, so
    # the stride stays aligned with the shard's rows
    if spatial is not None and x.shape[1] % 2:
        raise ValueError(f"packed down-conv: a shard of {x.shape[1]} rows")
    x, pady = _window(x, (py0, py1 - 1), spatial, True)
    xs = x if in_scale is None else x * in_scale[:, None, None, :]
    out = conv_nhwc(xs, wp, 2, (pady, (px0, px1 - 1)))
    out = _epi_after(out, epi)
    return out if spatial is None else spatial.settle(out, packed=True)


def upsample2d_packed(x: torch.Tensor, taps: tuple,
                      packed_in: bool, spatial=None) -> torch.Tensor:
    """FIR 2x upsample (`models/RestoreNet.py:43-60`) to a packed output
    (the ToRGB skip chain): the depthwise FIR as a dense kernel with
    diagonal channel blocks (C is 3 or 12 here), K1, and from a packed
    input one K3 interleave. spatial: this rank's output rows."""
    lk, factor = len(taps), 2
    t = np.asarray(taps, np.float64)
    k2 = np.outer(t, t)
    k2 = k2 / k2.sum() * factor ** 2
    c = x.shape[-1] // (4 if packed_in else 1)
    d2 = torch.as_tensor(k2[:, :, None, None] * np.eye(c)[None, None],
                         dtype=x.dtype, device=x.device)
    pad0 = (lk - factor + 1) // 2 + factor - 1
    m = _map_up(lk, lk - 1 - pad0, packed_in)
    if not packed_in:
        wp, pady, padx = _assemble2(d2, m, m, 1, 2)
        x, pady = _window(x, pady, spatial, False)
        return _conv(x, wp, pady, padx)
    wp, pady, padx = _assemble2(d2, m, m, 2, 4)
    wp = wp[..., torch.as_tensor(_phase16_perm(c), device=wp.device)]
    x, pady = _window(x, pady, spatial, True)
    return d2s(_conv(x, wp, pady, padx), 4 * c)
