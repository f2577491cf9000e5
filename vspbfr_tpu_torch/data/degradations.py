"""The degradation chain's blur-kernel samplers and its configuration.

Counterpart of the numpy half of `vspbfr_tpu/data/degradations.py` (the
reference's vendored basicsr subset, `my_basicsr/my_degradations.py`):
every sampler takes an explicit `np.random.Generator`, so a chain is
deterministic given its seed. These build the per-sample kernels on the
host; `device_degrade.py` applies them on the device. Kernel families:
iso/aniso bivariate Gaussian, generalized Gaussian, plateau, and the
circular sinc low-pass. The host-side noise, JPEG and `degrade_image`
wait with the host chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


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
