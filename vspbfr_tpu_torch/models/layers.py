"""StyleGAN2 / SMART building blocks as torch modules, NHWC.

Counterpart of `vspbfr_tpu/models/layers.py`, plus torch versions of the
three flax layers the JAX package uses directly (`Dense`, `Conv`,
`LayerNorm`). The `packed*` flags select the space-to-depth layout
(`ops/packed.py`) of a layer's input and output, (B, R/2, R/2, 4C) with
phase-major channels; the parameters are the same in either layout.
Parameter names and layouts mirror the flax tree: linears (in, out), convs
HWIO, and `convs_3/conv/weight` there is `convs.3.conv.weight` here (see
`vspbfr_tpu_torch/convert.py`).

Equalized-lr convention: weights are stored unscaled, drawn from N(0, 1)
(divided by lr_mul for linears), and 1/sqrt(fan_in) (times lr_mul) is
applied at use time. Each module with parameters of its own defines
`init_from(generator)`, which draws them with the JAX package's init
distributions; `init_module` runs it over a whole tree.

Noise injection draws (B, H, W, 1) float32 normals from an explicit
`torch.Generator` when no noise tensor is passed; a packed layer draws
(B, h, w, 4), one value a phase, and takes given (B, 2h, 2w, 1) noise
through `space_to_depth`.

`spatial` (a `parallel.spatial.Spatial`, default None: today's path) runs
a layer on this rank's rows of H-sharded maps: its convs on windows of
their neighbours' rows, its noise the shard's rows of the global draw. A
map's resolution (its width, twice that in a layer's packed layout) says
whether it is sharded, in either layout (`parallel/spatial.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vspbfr_tpu_torch.ops import (
    conv2d,
    fused_leaky_relu,
    modulated_conv2d,
    modulated_conv2d_multi,
    upsample2d,
)
from vspbfr_tpu_torch.ops.dense_conv import (
    apply_epilogue,
    conv2d_dense_epilogue,
    conv_nhwc,
)
from vspbfr_tpu_torch.ops import packed as pk
from vspbfr_tpu_torch.ops.modulated_conv import (
    fused_blur_strided_conv,
    modulated_conv2d_d12_packed,
    modulated_conv2d_d48_packed,
    on_rows,
    window_rows,
)

BLUR_KERNEL = (1, 3, 3, 1)  # the FIR taps of every up/down path
RATES = (1, 2, 4, 8)       # SMART / LargeConv dilation rates


def _branch_major_perm(features: int, n_branches: int) -> tuple:
    """The packed-channel permutation that maps the fusion conv's
    phase-major (ph, br, cb) input onto the branch-major (br, ph, cb)
    concatenation the SMART / LargeConv branches produce: perm[j] is the
    packed channel held at data channel j (`_branch_major_perm`,
    layers.py:40). Folded into the fusion's weight, never applied to the
    tensor."""
    cb = features // n_branches
    perm = np.empty(4 * features, np.int64)
    for br in range(n_branches):
        for ph in range(4):
            j = br * 4 * cb + ph * cb
            perm[j:j + cb] = ph * features + br * cb + np.arange(cb)
    return tuple(int(v) for v in perm)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def init_module(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `root` from `generator` (CPU)."""
    with torch.no_grad():
        for m in root.modules():
            if hasattr(m, "init_from"):
                m.init_from(generator)
    return root


def _normal(p: torch.Tensor, gen: torch.Generator, std: float = 1.0) -> None:
    p.copy_(torch.randn(p.shape, generator=gen).mul_(std))


def _lecun_normal(p: torch.Tensor, gen: torch.Generator, fan_in: int) -> None:
    """flax lecun_normal: N(0, 1/fan_in) truncated at +-2 std, rescaled to
    unit variance after truncation. In place on the float64 draw (the same
    operations in the same order: the same values, without a temporary a
    step)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(p.shape, generator=gen, dtype=torch.float64)
    u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
    p.copy_(u.mul_(math.sqrt(2.0)).mul_(std).clamp_(-2 * std, 2 * std))


def draw_noise(shape, like: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
    """float32 N(0, 1) noise of `shape` cast to like's dtype: a bf16 run sees
    the same stream as the f32 one."""
    if generator is None:
        raise ValueError("no noise tensor given and no torch.Generator to "
                         "draw it from")
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=torch.float32).to(like.dtype)


def pixel_norm(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, dim) + eps) (`models/RestoreNet.py:24-29`)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# flax-layout counterparts
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """flax nn.Dense: kernel (in, out), lecun-normal; bias zeros."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_from(self, gen):
        _lecun_normal(self.kernel, gen, self.kernel.shape[0])
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        out = x @ self.kernel
        return out if self.bias is None else out + self.bias


class Conv(nn.Module):
    """flax nn.Conv with explicit padding: kernel HWIO, lecun-normal; bias
    zeros. kernel_size is k or (kh, kw); padding p (all sides) or ((top,
    bottom), (left, right)). Runs on `F.conv2d`, as the JAX package leaves
    these convs to XLA. Computes in the input's dtype (the kernel and bias
    are cast at use, as flax's `dtype=` does)."""

    def __init__(self, in_ch: int, features: int, kernel_size,
                 stride: int = 1, padding=0, use_bias: bool = True):
        super().__init__()
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        self.stride = stride
        self.pads = (((padding, padding), (padding, padding))
                     if isinstance(padding, int) else padding)
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_ch, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_from(self, gen):
        kh, kw, ci, _ = self.kernel.shape
        _lecun_normal(self.kernel, gen, kh * kw * ci)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        out = conv_nhwc(x, self.kernel, self.stride, self.pads)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis with scale and bias, eps 1e-6
    (torch's default is 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.features, self.eps = features, eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_from(self, gen):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return nn.functional.layer_norm(x, (self.features,), self.scale,
                                        self.bias, self.eps)


# ---------------------------------------------------------------------------
# StyleGAN2 / SMART blocks
# ---------------------------------------------------------------------------

class EqualLinear(nn.Module):
    """Equalized-lr linear with bias, optional fused lrelu
    (`models/RestoreNet.py:142-176`)."""

    def __init__(self, in_dim: int, features: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False):
        super().__init__()
        self.bias_init, self.lr_mul, self.activation = (bias_init, lr_mul,
                                                        activation)
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.weight = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_from(self, gen):
        _normal(self.weight, gen, 1.0 / self.lr_mul)
        self.bias.fill_(self.bias_init)

    def forward(self, x):
        out = x @ (self.weight * self.scale)
        b = self.bias * self.lr_mul
        if self.activation:
            return fused_leaky_relu(out, b)
        return out + b


class EqualConv2d(nn.Module):
    """Equalized-lr conv (`models/RestoreNet.py:104-139`; dilated variant
    `:683-722`), bias only with use_bias. pre_blur=(pad0, pad1) composes a
    FIR blur with those pads into the kernel of a strided conv (one conv
    instead of blur + conv, as the JAX package does). packed: the
    space-to-depth layout in and out (stride 1), with packed_in_perm, a
    permutation of the packed input channels, folded into the kernel."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = False, pre_blur: tuple | None = None,
                 packed: bool = False, packed_in_perm: tuple | None = None):
        super().__init__()
        if packed and (stride != 1 or pre_blur is not None):
            raise ValueError("EqualConv2d: the packed layout is stride 1")
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.pre_blur = pre_blur
        self.packed, self.packed_in_perm = packed, packed_in_perm
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size ** 2)
        self.weight = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_ch, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_from(self, gen):
        _normal(self.weight, gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x, epi=None, spatial=None):
        """epi: optional epilogue dict (see `apply_epilogue`); a stride-1
        conv without a bias of its own takes it in its store
        (`conv2d_dense_epilogue`). spatial: a `parallel.spatial.Spatial`
        when x may be H-sharded (stride 1 or the blurred stride-2 conv)."""
        w = self.weight * self.scale
        if spatial is not None and not spatial.sharded(
                spatial.res_of(x, self.packed)):
            spatial = None
        if spatial is not None and self.stride != 1 and self.pre_blur is None:
            raise NotImplementedError("spatial sharding: stride-1 or blurred "
                                      "stride-2 EqualConv2d only")
        if self.packed:
            if self.bias is not None and epi is not None:
                raise ValueError("EqualConv2d: a bias of its own and an "
                                 "epilogue")
            if w.shape[0] == 1:
                out = pk.conv1x1_packed(x, w, in_ch_perm=self.packed_in_perm,
                                        epi=epi)
            else:
                out = pk.conv2d_packed(x, w, dilation=self.dilation,
                                       in_ch_perm=self.packed_in_perm,
                                       epi=epi, spatial=spatial)
            if self.bias is not None:
                out = out + pk.pack_vector(self.bias).to(out.dtype)
            return out
        p = self.padding
        if self.pre_blur is not None:
            out = fused_blur_strided_conv(x, w, BLUR_KERNEL, self.pre_blur,
                                          stride=self.stride, spatial=spatial)
        else:
            x, pady = window_rows(x, p, p, spatial)
            if (epi is not None and self.stride == 1 and self.dilation == 1
                    and self.bias is None):
                return conv2d_dense_epilogue(x, w, (pady, (p, p)), **epi)
            out = conv2d(x, w, stride=self.stride, padding=(pady, (p, p)),
                         dilation=self.dilation)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if epi is not None:
            out = apply_epilogue(out, **epi)
        # the bias and the epilogue on this rank's rows, then the rows'
        # layout (a down-conv below the threshold gathers)
        return out if spatial is None else spatial.settle(out)


class FusedLeakyReLU(nn.Module):
    """Per-channel learnable bias + lrelu*sqrt(2) (`op/fused_act.py:199-213`);
    packed: the bias tiled over the four phase groups (K7 either way)."""

    def __init__(self, features: int, packed: bool = False):
        super().__init__()
        self.packed = packed
        self.bias = nn.Parameter(torch.empty(features))

    def init_from(self, gen):
        self.bias.zero_()

    def vector(self) -> torch.Tensor:
        """The bias as the layer's layout adds it."""
        return pk.pack_vector(self.bias) if self.packed else self.bias

    def forward(self, x):
        return fused_leaky_relu(x, self.vector())


class NoiseInjection(nn.Module):
    """The scalar learnable noise gain (`models/RestoreNet.py:557-569`);
    callers add `scaled(...)` in their epilogue."""

    def __init__(self, packed: bool = False):
        super().__init__()
        self.packed = packed
        self.weight = nn.Parameter(torch.empty(1))

    def init_from(self, gen):
        self.weight.zero_()

    def scaled(self, shape, like, noise=None, generator=None, spatial=None,
               rows=None):
        """weight * noise for an output of `shape` (B, H, W, C). Unpacked:
        noise (B, H, W, 1), drawn when none is given. Packed: (B, H, W, 4),
        one value a phase, drawn in that layout when none is given (the
        same N(0, 1) draws as unpacked, in another order: cross-layout
        comparisons pass noise); given noise may be (B, 2H, 2W, 1), which
        goes through `space_to_depth`, or already (B, H, W, 4). With
        `spatial` (`shape` the whole map's): the output's rows of the
        noise, or this rank's block of `rows` rows, in the layout's own
        rows (`Spatial.noise`: a packed draw is the global batch's packed
        draw cut to packed rows)."""
        b, h, w = shape[:3]
        nc = 4 if self.packed else 1
        if self.packed and noise is not None and noise.shape[-1] == 1:
            noise = pk.space_to_depth(noise)
        if spatial is not None:
            return self.weight * spatial.noise(
                (b, h, w, nc), noise,
                lambda s: draw_noise(s, like, generator), rows,
                packed=self.packed)
        if noise is None:
            noise = draw_noise((b, h, w, nc), like, generator)
        if tuple(noise.shape) != (b, h, w, nc):
            raise ValueError(f"noise {tuple(noise.shape)} for an output "
                             f"{tuple(shape)}, packed {self.packed}")
        return self.weight * noise


class ModulatedConv2d(nn.Module):
    """Style-modulated conv with its own affine modulation, or with
    style_dim=None an externally modulated one (SMART's branches)
    (`models/RestoreNet.py:421-555`)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 style_dim: int | None, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 dilation: int = 1, packed_in: bool = False,
                 packed_out: bool = False):
        super().__init__()
        self.demodulate, self.upsample, self.downsample = (demodulate,
                                                           upsample,
                                                           downsample)
        self.dilation = dilation
        self.packed_in, self.packed_out = packed_in, packed_out
        self.modulation = (EqualLinear(style_dim, in_ch, bias_init=1.0)
                           if style_dim is not None else None)
        self.weight = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_ch, features))

    def init_from(self, gen):
        _normal(self.weight, gen)

    def forward(self, x, style, epilogue=None, spatial=None):
        if self.modulation is not None:
            style = self.modulation(style)
        return modulated_conv2d(
            x, self.weight, style, demodulate=self.demodulate,
            up=self.upsample, down=self.downsample, dilation=self.dilation,
            blur_kernel=BLUR_KERNEL, packed_in=self.packed_in,
            packed_out=self.packed_out, epilogue=epilogue, spatial=spatial)


class StyledConv(nn.Module):
    """3x3 ModulatedConv2d + noise injection + fused lrelu
    (`models/RestoreNet.py:571-643`, StyledConv and StyledConv_down)."""

    def __init__(self, in_ch: int, features: int, style_dim: int,
                 upsample: bool = False, downsample: bool = False,
                 packed_in: bool = False, packed_out: bool = False):
        super().__init__()
        self.upsample, self.downsample = upsample, downsample
        self.packed_in, self.packed_out = packed_in, packed_out
        self.features = features
        self.noise = NoiseInjection(packed=packed_out)
        self.activate = FusedLeakyReLU(features, packed=packed_out)
        self.conv = ModulatedConv2d(in_ch, features, 3, style_dim,
                                    upsample=upsample, downsample=downsample,
                                    packed_in=packed_in,
                                    packed_out=packed_out)

    def resolutions(self, xshape) -> tuple[int, int]:
        """The input's and the output's resolutions for an input of shape
        xshape (its width, twice that packed; H may be a shard)."""
        res = xshape[2] * (2 if self.packed_in else 1)
        return res, (2 * res if self.upsample
                     else res // 2 if self.downsample else res)

    def out_shape(self, xshape) -> tuple:
        """The output's shape for an input of shape xshape (the layouts'
        static geometry, `_styled_out_shape`, layers.py:286)."""
        b, res = xshape[0], self.resolutions(xshape)[1]
        if self.packed_out:
            return (b, res // 2, res // 2, 4 * self.features)
        return (b, res, res, self.features)

    def forward(self, x, style, noise=None, post_add=(), generator=None,
                spatial=None):
        """post_add: tensors of the output shape added after the lrelu (the
        RestoreNet decoder's skip fusion, `models/RestoreNet.py:1029-1035`;
        with `spatial`, the output's rows)."""
        rows = None
        res, res_out = self.resolutions(x.shape)
        if spatial is not None and self.downsample and spatial.sharded(res):
            # the conv's rows before they settle, in the output's layout
            rows = spatial.step(res_out, self.packed_out)
        nz = self.noise.scaled(self.out_shape(x.shape), x, noise, generator,
                               spatial, rows)
        return self.conv(x, style, epilogue=dict(
            noise=nz, bias=self.activate.vector(), act=True,
            post_add=tuple(post_add)), spatial=spatial)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) + bias, plus the upsampled skip
    (`models/RestoreNet.py:647-666`). packed: the features and the RGB in
    the packed layout; skip_packed: the half-resolution skip's layout."""

    def __init__(self, in_ch: int, style_dim: int, packed: bool = False,
                 skip_packed: bool = False):
        super().__init__()
        self.packed, self.skip_packed = packed, skip_packed
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    packed_in=packed, packed_out=packed)
        self.bias = nn.Parameter(torch.empty(3))

    def init_from(self, gen):
        self.bias.zero_()

    def forward(self, x, style, skip=None, spatial=None):
        if not self.packed:
            out = self.conv(x, style, spatial=spatial) + self.bias
            if skip is not None:
                out = out + on_rows(
                    skip, lambda t: upsample2d(t, BLUR_KERNEL), 1, 2, spatial)
            return out
        if spatial is not None and not spatial.sharded(
                spatial.res_of(x, True)):
            spatial = None
        out = self.conv(x, style, spatial=spatial) + pk.pack_vector(self.bias)
        if skip is not None:
            out = out + pk.upsample2d_packed(skip, BLUR_KERNEL,
                                             packed_in=self.skip_packed,
                                             spatial=spatial)
        return out


class ConvLayer(nn.Module):
    """[Blur + stride 2] EqualConv2d [+ fused lrelu]
    (`models/RestoreNet.py:1130-1172`). The activation's bias (module
    `activate`) rides the conv's epilogue; without activation the conv owns
    the bias (use_bias)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 downsample: bool = False, use_bias: bool = True,
                 activate: bool = True, packed: bool = False,
                 packed_in_perm: tuple | None = None):
        super().__init__()
        k = kernel_size
        conv_bias = use_bias and not activate
        if packed:
            if downsample:
                raise ValueError("ConvLayer: the packed layout is stride 1")
            self.conv = EqualConv2d(in_ch, features, k, padding=k // 2,
                                    use_bias=conv_bias, packed=True,
                                    packed_in_perm=packed_in_perm)
        elif downsample:
            p = (len(BLUR_KERNEL) - 2) + (k - 1)
            self.conv = EqualConv2d(in_ch, features, k, stride=2,
                                    use_bias=conv_bias,
                                    pre_blur=((p + 1) // 2, p // 2))
        else:
            self.conv = EqualConv2d(in_ch, features, k, padding=k // 2,
                                    use_bias=conv_bias)
        self.act = activate
        self.activate = (FusedLeakyReLU(features, packed=packed)
                         if activate and use_bias else None)

    def forward(self, x, epi_extra=None, spatial=None):
        """epi_extra: extra epilogue pieces (noise2/bias2/act2: the SMART
        tail) applied after the activation."""
        if not self.act:
            if epi_extra:
                raise ValueError("ConvLayer: epi_extra needs activate=True")
            return self.conv(x, spatial=spatial)
        bias = None if self.activate is None else self.activate.vector()
        return self.conv(x, epi=dict(bias=bias, act=True,
                                     **(epi_extra or {})), spatial=spatial)


class ResBlock(nn.Module):
    """StyleGAN2 discriminator residual block
    (`models/RestoreNet.py:1175-1200`)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3)
        self.conv2 = ConvLayer(in_ch, features, 3, downsample=True)
        self.skip = ConvLayer(in_ch, features, 1, downsample=True,
                              activate=False, use_bias=False)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) / math.sqrt(2)


class SMARTLayer(nn.Module):
    """Style-Modulated AggRegation Transformation: one style affine drives
    four parallel dilated 3x3 modulated convs (rates 1/2/4/8, out/4
    channels each), concatenated, then a 3x3 fusion conv, noise and fused
    lrelu (`models/RestoreNet.py:179-268`). Stride 1: no SMART on the
    serving path upsamples. packed: the space-to-depth layout in and out;
    the branches run as two launches (`modulated_conv2d_d12_packed`, one
    K1, and `modulated_conv2d_d48_packed`, one grouped K2), their
    branch-major concatenation read by the fusion conv through a
    permutation folded into its weight."""

    def __init__(self, in_ch: int, features: int, style_dim: int,
                 packed: bool = False):
        super().__init__()
        self.packed = packed
        branch = features // len(RATES)
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.dilated = nn.ModuleList(
            ModulatedConv2d(in_ch, branch, 3, None, dilation=r,
                            packed_in=packed, packed_out=packed)
            for r in RATES)
        self.noise = NoiseInjection(packed=packed)
        self.activate = FusedLeakyReLU(features, packed=packed)
        self.fusion = ConvLayer(
            branch * len(RATES), features, 3, packed=packed,
            packed_in_perm=(_branch_major_perm(features, len(RATES))
                            if packed else None))

    def forward(self, x, style, noise=None, return_intermediates: bool = False,
                generator=None, spatial=None):
        """return_intermediates=True also returns the per-dilation branch
        outputs and the final tensor (`forward_vis`)."""
        mod = self.modulation(style)
        ws = [m.weight for m in self.dilated]
        if return_intermediates:
            outs = [m(x, mod, spatial=spatial) for m in self.dilated]
        elif self.packed:
            # the pair on rows where x is sharded (the noise below takes
            # `spatial` at any level: the global batch's draw)
            sp = (spatial if spatial is not None
                  and spatial.sharded(spatial.res_of(x, True)) else None)
            outs = [modulated_conv2d_d12_packed(x, ws[0], ws[1], mod,
                                                spatial=sp),
                    modulated_conv2d_d48_packed(x, ws[2], ws[3], mod,
                                                spatial=sp)]
        else:
            # all branches in one K2 launch
            outs = [modulated_conv2d_multi(x, ws, RATES, mod,
                                           spatial=spatial)]
        out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        b, _, w, c = out.shape          # square maps: W (H may be a shard)
        nz = self.noise.scaled((b, w, w, c), out, noise, generator, spatial)
        out = self.fusion(out, epi_extra=dict(
            noise2=nz, bias2=self.activate.vector(), act2=True),
            spatial=spatial)
        if return_intermediates:
            return out, outs + [out]
        return out


class LargeConvLayer(nn.Module):
    """Unmodulated multi-dilation aggregation: four dilated equal-convs ->
    concat -> 1x1 fusion -> fused lrelu (`models/RestoreNet.py:725-787`;
    stride 1, the only form on the serving path). packed: the
    space-to-depth layout in and out, the fusion reading the branch-major
    concatenation through a permutation folded into its weight."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 packed: bool = False):
        super().__init__()
        k = kernel_size
        branch = features // len(RATES)
        self.dilated = nn.ModuleList(
            EqualConv2d(in_ch, branch, k, padding=((k - 1) * r) // 2,
                        dilation=r, packed=packed)
            for r in RATES)
        self.fusion = ConvLayer(
            branch * len(RATES), features, 1, packed=packed,
            packed_in_perm=(_branch_major_perm(features, len(RATES))
                            if packed else None))
        self.activate = FusedLeakyReLU(features, packed=packed)

    def forward(self, x, spatial=None):
        out = torch.cat([m(x, spatial=spatial) for m in self.dilated],
                        dim=-1)
        return self.activate(self.fusion(out, spatial=spatial))


class StyleMLP(nn.Module):
    """PixelNorm + n_mlp equalized linears with fused lrelu
    (`models/RestoreNet.py:837-846`)."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 8,
                 lr_mul: float = 0.01):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            self.add_module(f"fc{i}", EqualLinear(style_dim, style_dim,
                                                  lr_mul=lr_mul,
                                                  activation=True))

    def forward(self, z):
        x = pixel_norm(z)
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x


def layer_resolutions(layer, xshape) -> tuple[int, int]:
    """The input's and the output's resolutions of a styled layer
    (StyledConv, SMARTLayer, ToRGB) on an input of shape xshape: the
    width, twice that where the layer's input is packed."""
    if isinstance(layer, StyledConv):
        return layer.resolutions(xshape)
    res = xshape[2] * (2 if layer.packed else 1)
    return res, res


def styled_runner(spatial, style, styles):
    """run(layer, x, i, ...) = layer(x, style(i), ...), a styled layer
    reading style code i. With `spatial` the layer runs in
    `Spatial.layer`'s context (its input's and its output's resolutions,
    `layer_resolutions`, say whether it is on this rank's rows), and one
    on rows reads row i of `styles` (every code, (B, n, D)) through one
    `Spatial.summed`: the model axis sums the codes' row parts once a
    forward, not once a layer."""
    if spatial is None:
        return lambda layer, x, i, *a, **kw: layer(x, style(i), *a, **kw)
    rows_styles = spatial.summed(styles)

    def run(layer, x, i, *args, **kw):
        with spatial.layer(layer, *layer_resolutions(layer, x.shape)) as rows:
            return layer(x, rows_styles[:, i] if rows else style(i), *args,
                         spatial=spatial, **kw)
    return run


def minibatch_stddev(x: torch.Tensor, group_size: int = 4,
                     num_new_features: int = 1,
                     eps: float = 1e-8) -> torch.Tensor:
    """Append the cross-sample stddev statistic channel
    (`models/RestoreNet.py:1243-1252`): per group of min(B, group_size)
    samples, the biased stddev over the group, averaged over H, W and the
    channel groups, tiled over the image."""
    b, h, w, c = x.shape
    g = min(b, group_size)
    y = x.reshape(g, -1, h, w, num_new_features, c // num_new_features)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + eps)
    y = y.mean(dim=(1, 2, 4), keepdim=True).squeeze(4)   # (B/g, 1, 1, F)
    return torch.cat([x, y.repeat(g, h, w, 1)], dim=-1)


def truncate_styles(styles: torch.Tensor, truncation: float,
                    truncation_latent: torch.Tensor) -> torch.Tensor:
    """w <- t_lat + trunc * (w - t_lat)
    (`e4e/models/stylegan2/model.py:498-506`)."""
    return truncation_latent + truncation * (styles - truncation_latent)


def styles_to_latent(styles: torch.Tensor, n_latent: int,
                     inject_index: int | None) -> torch.Tensor:
    """(S, B, D) styles, S in {1, 2} -> (B, n_latent, D): rows below
    inject_index take styles[0], the rest styles[1]
    (`e4e/models/stylegan2/model.py:487-523`)."""
    lat0 = styles[0][:, None, :].expand(-1, n_latent, -1)
    if styles.shape[0] == 1:
        return lat0.contiguous()
    if inject_index is None:
        inject_index = n_latent // 2
    lat1 = styles[1][:, None, :].expand(-1, n_latent, -1)
    idx = torch.arange(n_latent, device=styles.device)[None, :, None]
    return torch.where(idx < inject_index, lat0, lat1)
