"""StyleGAN2 / SMART building blocks as torch modules, NHWC.

Counterpart of `vspbfr_tpu/models/layers.py` (unpacked layout only), plus
torch versions of the three flax layers the JAX package uses directly
(`Dense`, `Conv`, `LayerNorm`). Parameter names and layouts mirror the
flax tree: linears (in, out), convs HWIO, and `convs_3/conv/weight` there
is `convs.3.conv.weight` here (see `vspbfr_tpu_torch/convert.py`).

Equalized-lr convention: weights are stored unscaled, drawn from N(0, 1)
(divided by lr_mul for linears), and 1/sqrt(fan_in) (times lr_mul) is
applied at use time. Each module with parameters of its own defines
`init_from(generator)`, which draws them with the JAX package's init
distributions; `init_module` runs it over a whole tree.

Noise injection draws (B, H, W, 1) float32 normals from an explicit
`torch.Generator` when no noise tensor is passed.
"""

from __future__ import annotations

import math
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
from vspbfr_tpu_torch.ops.modulated_conv import fused_blur_strided_conv

BLUR_KERNEL = (1, 3, 3, 1)  # the FIR taps of every up/down path
RATES = (1, 2, 4, 8)       # SMART / LargeConv dilation rates


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
    p.copy_(torch.randn(p.shape, generator=gen) * std)


def _lecun_normal(p: torch.Tensor, gen: torch.Generator, fan_in: int) -> None:
    """flax lecun_normal: N(0, 1/fan_in) truncated at +-2 std, rescaled to
    unit variance after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(p.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    p.copy_((torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std).clamp(
        -2 * std, 2 * std))


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
    instead of blur + conv, as the JAX package does)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = False, pre_blur: tuple | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.pre_blur = pre_blur
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size ** 2)
        self.weight = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_ch, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_from(self, gen):
        _normal(self.weight, gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x, epi=None):
        """epi: optional epilogue dict (see `apply_epilogue`); a stride-1
        conv without a bias of its own takes it in its store
        (`conv2d_dense_epilogue`)."""
        w = self.weight * self.scale
        if self.pre_blur is not None:
            out = fused_blur_strided_conv(x, w, BLUR_KERNEL, self.pre_blur,
                                          stride=self.stride)
        elif (epi is not None and self.stride == 1 and self.dilation == 1
              and self.bias is None):
            p = self.padding
            return conv2d_dense_epilogue(x, w, ((p, p), (p, p)), **epi)
        else:
            out = conv2d(x, w, stride=self.stride, padding=self.padding,
                         dilation=self.dilation)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out if epi is None else apply_epilogue(out, **epi)


class FusedLeakyReLU(nn.Module):
    """Per-channel learnable bias + lrelu*sqrt(2) (`op/fused_act.py:199-213`)."""

    def __init__(self, features: int):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(features))

    def init_from(self, gen):
        self.bias.zero_()

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class NoiseInjection(nn.Module):
    """The scalar learnable noise gain (`models/RestoreNet.py:557-569`);
    callers add `scaled(...)` in their epilogue."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def init_from(self, gen):
        self.weight.zero_()

    def scaled(self, shape, like, noise=None, generator=None):
        """weight * noise, drawing (B, H, W, 1) noise when none is given."""
        if noise is None:
            noise = draw_noise(shape, like, generator)
        return self.weight * noise


class ModulatedConv2d(nn.Module):
    """Style-modulated conv with its own affine modulation, or with
    style_dim=None an externally modulated one (SMART's branches)
    (`models/RestoreNet.py:421-555`)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 style_dim: int | None, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 dilation: int = 1):
        super().__init__()
        self.demodulate, self.upsample, self.downsample = (demodulate,
                                                           upsample,
                                                           downsample)
        self.dilation = dilation
        self.modulation = (EqualLinear(style_dim, in_ch, bias_init=1.0)
                           if style_dim is not None else None)
        self.weight = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_ch, features))

    def init_from(self, gen):
        _normal(self.weight, gen)

    def forward(self, x, style, epilogue=None):
        if self.modulation is not None:
            style = self.modulation(style)
        return modulated_conv2d(
            x, self.weight, style, demodulate=self.demodulate,
            up=self.upsample, down=self.downsample, dilation=self.dilation,
            blur_kernel=BLUR_KERNEL, epilogue=epilogue)


class StyledConv(nn.Module):
    """3x3 ModulatedConv2d + noise injection + fused lrelu
    (`models/RestoreNet.py:571-643`, StyledConv and StyledConv_down)."""

    def __init__(self, in_ch: int, features: int, style_dim: int,
                 upsample: bool = False, downsample: bool = False):
        super().__init__()
        self.upsample, self.downsample = upsample, downsample
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(features)
        self.conv = ModulatedConv2d(in_ch, features, 3, style_dim,
                                    upsample=upsample, downsample=downsample)

    def forward(self, x, style, noise=None, post_add=(), generator=None):
        """post_add: tensors of the output shape added after the lrelu (the
        RestoreNet decoder's skip fusion, `models/RestoreNet.py:1029-1035`)."""
        b, h = x.shape[0], x.shape[1]
        res = 2 * h if self.upsample else (h // 2 if self.downsample else h)
        nz = self.noise.scaled((b, res, res, 1), x, noise, generator)
        return self.conv(x, style, epilogue=dict(
            noise=nz, bias=self.activate.bias, act=True,
            post_add=tuple(post_add)))


class ToRGB(nn.Module):
    """1x1 modulated conv (no demod) + bias, plus the upsampled skip
    (`models/RestoreNet.py:647-666`)."""

    def __init__(self, in_ch: int, style_dim: int):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(3))

    def init_from(self, gen):
        self.bias.zero_()

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        if skip is not None:
            out = out + upsample2d(skip, BLUR_KERNEL)
        return out


class ConvLayer(nn.Module):
    """[Blur + stride 2] EqualConv2d [+ fused lrelu]
    (`models/RestoreNet.py:1130-1172`). The activation's bias (module
    `activate`) rides the conv's epilogue; without activation the conv owns
    the bias (use_bias)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 downsample: bool = False, use_bias: bool = True,
                 activate: bool = True):
        super().__init__()
        k = kernel_size
        conv_bias = use_bias and not activate
        if downsample:
            p = (len(BLUR_KERNEL) - 2) + (k - 1)
            self.conv = EqualConv2d(in_ch, features, k, stride=2,
                                    use_bias=conv_bias,
                                    pre_blur=((p + 1) // 2, p // 2))
        else:
            self.conv = EqualConv2d(in_ch, features, k, padding=k // 2,
                                    use_bias=conv_bias)
        self.act = activate
        self.activate = (FusedLeakyReLU(features) if activate and use_bias
                         else None)

    def forward(self, x, epi_extra=None):
        """epi_extra: extra epilogue pieces (noise2/bias2/act2: the SMART
        tail) applied after the activation."""
        if not self.act:
            if epi_extra:
                raise ValueError("ConvLayer: epi_extra needs activate=True")
            return self.conv(x)
        bias = None if self.activate is None else self.activate.bias
        return self.conv(x, epi=dict(bias=bias, act=True,
                                     **(epi_extra or {})))


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
    serving path upsamples."""

    def __init__(self, in_ch: int, features: int, style_dim: int):
        super().__init__()
        branch = features // len(RATES)
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.dilated = nn.ModuleList(
            ModulatedConv2d(in_ch, branch, 3, None, dilation=r)
            for r in RATES)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(features)
        self.fusion = ConvLayer(branch * len(RATES), features, 3)

    def forward(self, x, style, noise=None, return_intermediates: bool = False,
                generator=None):
        """return_intermediates=True also returns the per-dilation branch
        outputs and the final tensor (`forward_vis`)."""
        mod = self.modulation(style)
        if return_intermediates:
            outs = [m(x, mod) for m in self.dilated]
        else:
            # all branches in one K2 launch
            outs = [modulated_conv2d_multi(
                x, [m.weight for m in self.dilated], RATES, mod)]
        out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        nz = self.noise.scaled((*out.shape[:3], 1), out, noise, generator)
        out = self.fusion(out, epi_extra=dict(
            noise2=nz, bias2=self.activate.bias, act2=True))
        if return_intermediates:
            return out, outs + [out]
        return out


class LargeConvLayer(nn.Module):
    """Unmodulated multi-dilation aggregation: four dilated equal-convs ->
    concat -> 1x1 fusion -> fused lrelu (`models/RestoreNet.py:725-787`;
    stride 1, the only form on the serving path)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int):
        super().__init__()
        k = kernel_size
        branch = features // len(RATES)
        self.dilated = nn.ModuleList(
            EqualConv2d(in_ch, branch, k, padding=((k - 1) * r) // 2,
                        dilation=r)
            for r in RATES)
        self.fusion = ConvLayer(branch * len(RATES), features, 1)
        self.activate = FusedLeakyReLU(features)

    def forward(self, x):
        out = torch.cat([m(x) for m in self.dilated], dim=-1)
        return self.activate(self.fusion(out))


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
