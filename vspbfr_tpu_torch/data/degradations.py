"""The degradation chain on the host: kernel samplers, noise, JPEG, the
whole chain (`degrade_image`) and its configuration.

Counterpart of `vspbfr_tpu/data/degradations.py` (the reference's
vendored basicsr subset, `my_basicsr/my_degradations.py`): every sampler
takes an explicit `np.random.Generator`, so a chain is deterministic given
its seed, and draws in the JAX package's order, so one seed gives the same
kernel, haze, scale, noise field and quality in both. Kernel families:
iso/aniso bivariate Gaussian, generalized Gaussian, plateau, and the
circular sinc low-pass. The kernels also feed the device chain
(`device_degrade.py`).

The JAX package computes the chain with OpenCV; this module computes the
same functions in numpy (the card's host has no OpenCV): `cv2.filter2D`
as an FFT cross-correlation with a REFLECT_101 border, `cv2.resize`
INTER_LINEAR as a separable two-tap pass in cv2's order and coordinates,
imencode's float -> uint8 conversion (round half to even, saturate), the
`cvtColor` gray weights, and the JPEG round-trip (`host_jpeg.py`, libjpeg's
integer pipeline, exact).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from vspbfr_tpu_torch.data.host_jpeg import jpeg_roundtrip


# --------------------------------------------------------------------------
# blur kernels
# --------------------------------------------------------------------------

def _mesh_grid(kernel_size: int) -> np.ndarray:
    ax = np.arange(-(kernel_size // 2), kernel_size // 2 + 1, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)  # (K, K, 2)


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.diag([sig_x ** 2, sig_y ** 2])
    u = np.array([[math.cos(theta), -math.sin(theta)],
                  [math.sin(theta), math.cos(theta)]])
    return u @ d @ u.T


def _quad_form(sigma_matrix: np.ndarray, grid: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma_matrix)
    return np.einsum("klj,ji,kli->kl", grid, inv, grid)


def bivariate_gaussian_kernel(kernel_size: int, sig_x: float, sig_y: float = None,
                              theta: float = 0.0, isotropic: bool = True) -> np.ndarray:
    sm = (np.diag([sig_x ** 2, sig_x ** 2]) if isotropic
          else _sigma_matrix(sig_x, sig_y, theta))
    k = np.exp(-0.5 * _quad_form(sm, _mesh_grid(kernel_size)))
    return (k / k.sum()).astype(np.float32)


def bivariate_generalized_gaussian_kernel(kernel_size: int, sig_x: float,
                                          sig_y: float, theta: float,
                                          beta: float,
                                          isotropic: bool = True) -> np.ndarray:
    sm = (np.diag([sig_x ** 2, sig_x ** 2]) if isotropic
          else _sigma_matrix(sig_x, sig_y, theta))
    k = np.exp(-0.5 * np.power(_quad_form(sm, _mesh_grid(kernel_size)), beta))
    return (k / k.sum()).astype(np.float32)


def bivariate_plateau_kernel(kernel_size: int, sig_x: float, sig_y: float,
                             theta: float, beta: float,
                             isotropic: bool = True) -> np.ndarray:
    sm = (np.diag([sig_x ** 2, sig_x ** 2]) if isotropic
          else _sigma_matrix(sig_x, sig_y, theta))
    k = 1.0 / (np.power(_quad_form(sm, _mesh_grid(kernel_size)), beta) + 1.0)
    return (k / k.sum()).astype(np.float32)


def circular_lowpass_kernel(cutoff: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2D sinc filter (`my_degradations.py:358-376`)."""
    from scipy import special as _special

    if kernel_size % 2 != 1:
        raise ValueError(f"sinc kernel size {kernel_size} is not odd")
    c = (kernel_size - 1) / 2
    y, x = np.mgrid[0:kernel_size, 0:kernel_size].astype(np.float64)
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = cutoff * _special.j1(cutoff * r) / (2 * np.pi * r)
    k[int(c), int(c)] = cutoff ** 2 / (4 * np.pi)
    k = k / k.sum()
    if pad_to > kernel_size:
        p = (pad_to - kernel_size) // 2
        k = np.pad(k, p)
    return k.astype(np.float32)


def random_mixed_kernel(
    rng: np.random.Generator,
    kernel_list: Sequence[str] = ("iso", "aniso"),
    kernel_prob: Sequence[float] = (0.5, 0.5),
    kernel_size: int = 21,
    sigma_range: tuple[float, float] = (0.6, 5.0),
    rotation_range: tuple[float, float] = (-math.pi, math.pi),
    betag_range: tuple[float, float] = (0.5, 8.0),
    betap_range: tuple[float, float] = (1.0, 4.0),
) -> np.ndarray:
    """Sample a kernel family then its parameters
    (`my_degradations.py:295-352`)."""
    kind = rng.choice(np.asarray(kernel_list, dtype=object),
                      p=np.asarray(kernel_prob) / np.sum(kernel_prob))
    sig_x = rng.uniform(*sigma_range)
    sig_y = rng.uniform(*sigma_range)
    theta = rng.uniform(*rotation_range)

    def sample_beta(lo, hi):
        # basicsr samples below/above 1 with p=0.5 each
        return rng.uniform(lo, 1.0) if rng.uniform() < 0.5 else rng.uniform(1.0, hi)

    if kind == "iso":
        return bivariate_gaussian_kernel(kernel_size, sig_x, isotropic=True)
    if kind == "aniso":
        return bivariate_gaussian_kernel(kernel_size, sig_x, sig_y, theta,
                                         isotropic=False)
    if kind == "generalized_iso":
        return bivariate_generalized_gaussian_kernel(
            kernel_size, sig_x, sig_y, theta, sample_beta(*betag_range), True)
    if kind == "generalized_aniso":
        return bivariate_generalized_gaussian_kernel(
            kernel_size, sig_x, sig_y, theta, sample_beta(*betag_range), False)
    if kind == "plateau_iso":
        return bivariate_plateau_kernel(
            kernel_size, sig_x, sig_y, theta, sample_beta(*betap_range), True)
    if kind == "plateau_aniso":
        return bivariate_plateau_kernel(
            kernel_size, sig_x, sig_y, theta, sample_beta(*betap_range), False)
    if kind == "sinc":
        cutoff = rng.uniform(np.pi / 3, np.pi)
        return circular_lowpass_kernel(cutoff, kernel_size)
    raise ValueError(f"unknown kernel type {kind!r}")


# --------------------------------------------------------------------------
# cv2's parts, in numpy
# --------------------------------------------------------------------------

# cvtColor's gray taps (R, G, B): COLOR_RGB2GRAY reads channel 0 as red,
# COLOR_BGR2GRAY as blue (the reference applies the latter to RGB data,
# `dataset.py:306-315` upstream, so R gets the B weight)
RGB2GRAY = (0.299, 0.587, 0.114)
BGR2GRAY = (0.114, 0.587, 0.299)


def to_gray(img: np.ndarray, weights=BGR2GRAY) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W) float32, `cv2.cvtColor` to gray."""
    w = [np.float32(c) for c in weights]
    return img[..., 0] * w[0] + img[..., 1] * w[1] + img[..., 2] * w[2]


def to_u8(x: np.ndarray) -> np.ndarray:
    """Float -> uint8 as OpenCV converts it (round half to even,
    saturate)."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.filter2D(img, -1, kernel)`: cross-correlation with the centre
    anchor and a REFLECT_101 border, of (H, W, C) float32 by an odd (K, K)
    kernel, as one FFT product (a direct 41x41 filter is ~1.3 G
    multiply-adds at 512 px)."""
    h, w = img.shape[:2]
    k = kernel.shape[0]
    p = k // 2
    xp = np.pad(img.astype(np.float64), ((p, p), (p, p), (0, 0)),
                mode="reflect")
    shape = xp.shape[:2]
    f = np.fft.rfft2(xp, axes=(0, 1))
    kf = np.fft.rfft2(kernel[::-1, ::-1].astype(np.float64), s=shape)
    y = np.fft.irfft2(f * kf[..., None], s=shape, axes=(0, 1))
    return y[k - 1:k - 1 + h, k - 1:k - 1 + w].astype(np.float32)


def _linear_taps(dst: int, src: int):
    """cv2 INTER_LINEAR's source index and float32 weights for each
    destination pixel of one axis: f = (j + 0.5) * src / dst - 0.5 in
    float64, indices clamped (replicated border)."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(f).astype(np.int64)
    a1 = (f - i0).astype(np.float32)
    a1[(i0 < 0) | (i0 >= src - 1)] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1.0) - a1, a1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=INTER_LINEAR)` of
    (H, W, C) float32: the rows' two-tap pass, then the columns', in
    float32."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(width, w)
    rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
    y0, y1, b0, b1 = _linear_taps(height, h)
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]


# --------------------------------------------------------------------------
# noise / compression
# --------------------------------------------------------------------------

def add_gaussian_noise(rng: np.random.Generator, img: np.ndarray,
                       sigma_range: tuple[float, float] = (0.0, 1.0),
                       gray_prob: float = 0.0, clip: bool = True) -> np.ndarray:
    """Gaussian noise with sigma measured in /255 units
    (`my_degradations.py:386-492`)."""
    sigma = rng.uniform(*sigma_range)
    if gray_prob > 0 and rng.uniform() < gray_prob:
        n = rng.standard_normal(img.shape[:2]).astype(np.float32)[..., None]
        n = np.repeat(n, img.shape[2], axis=2) * sigma / 255.0
    else:
        n = rng.standard_normal(img.shape).astype(np.float32) * sigma / 255.0
    out = img + n
    return np.clip(out, 0.0, 1.0) if clip else out


def add_poisson_noise(rng: np.random.Generator, img: np.ndarray,
                      scale_range: tuple[float, float] = (0.0, 1.0),
                      gray_prob: float = 0.0, clip: bool = True) -> np.ndarray:
    """Poisson (shot) noise (`my_degradations.py:518-678`): quantize to the
    image's unique-value count, Poisson-sample, scale the residual."""
    scale = rng.uniform(*scale_range)
    if gray_prob > 0 and rng.uniform() < gray_prob:
        base = to_gray((img * 255).astype(np.float32), RGB2GRAY) / 255.0
        base = base[..., None]
    else:
        base = img
    base = np.clip(base, 0, 1)
    vals = len(np.unique(base))
    vals = 2 ** np.ceil(np.log2(vals))
    noisy = rng.poisson(base * vals) / float(vals)
    noise = (noisy - base) * scale
    if base.shape[2] == 1:
        noise = np.repeat(noise, img.shape[2], axis=2)
    out = img + noise
    return np.clip(out, 0.0, 1.0) if clip else out


def add_jpeg_compression(rng: np.random.Generator, img: np.ndarray,
                         quality_range: tuple[float, float] = (90, 100)
                         ) -> np.ndarray:
    """JPEG round-trip at a drawn quality (`my_degradations.py:681-710`):
    [0, 1] float -> uint8 as imencode converts it -> libjpeg's round-trip
    (`host_jpeg.py`) -> [0, 1] float32."""
    quality = rng.uniform(*quality_range)
    img = np.clip(img, 0, 1)
    out = jpeg_roundtrip(to_u8(img * 255.0), int(quality))
    return np.float32(out) / 255.0


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Defaults = `dataset.py:222-236` (ImageFolder_restore_free_form)."""

    blur_kernel_half_range: tuple[int, int] = (19, 20)  # k = 2*randint+1 -> 39/41
    kernel_list: Sequence[str] = ("iso", "aniso")
    kernel_prob: Sequence[float] = (0.5, 0.5)
    blur_sigma: tuple[float, float] = (0.1, 10.0)
    downsample_range: tuple[float, float] = (0.8, 8.0)
    noise_range: tuple[float, float] | None = (0.0, 20.0)
    jpeg_range: tuple[float, float] | None = (60, 100)
    hazy_prob: float | None = 0.008
    hazy_alpha: tuple[float, float] = (0.75, 0.95)


def degrade_image(rng: np.random.Generator, img_gt: np.ndarray,
                  cfg: DegradationConfig = DegradationConfig()) -> np.ndarray:
    """GT (H, W, 3) float32 [0,1] -> degraded LQ, same size.

    Chain (`dataset.py:327-372`): random mixed blur -> optional hazy
    alpha-blend -> random bilinear downscale -> Gaussian noise -> JPEG ->
    resize back -> quantize to uint8 grid.
    """
    h, w = img_gt.shape[:2]
    half = rng.integers(cfg.blur_kernel_half_range[0],
                        cfg.blur_kernel_half_range[1] + 1)
    ksize = int(half) * 2 + 1
    kernel = random_mixed_kernel(
        rng, cfg.kernel_list, cfg.kernel_prob, ksize,
        sigma_range=cfg.blur_sigma)
    lq = filter2d(img_gt, kernel)

    if cfg.hazy_prob is not None and rng.uniform() < cfg.hazy_prob:
        alpha = rng.uniform(*cfg.hazy_alpha)
        lq = lq * alpha + (1.0 - alpha)

    scale = rng.uniform(*cfg.downsample_range)
    lq = resize_linear(lq, int(w // scale), int(h // scale))
    if cfg.noise_range is not None:
        lq = add_gaussian_noise(rng, lq, cfg.noise_range)
    if cfg.jpeg_range is not None:
        lq = add_jpeg_compression(rng, lq, cfg.jpeg_range)
    lq = resize_linear(lq, w, h)
    return np.clip((lq * 255.0).round(), 0, 255).astype(np.float32) / 255.0
