"""Evaluation metrics on NHWC batches: PSNR, SSIM, LPIPS and FID.

Counterpart of `vspbfr_tpu/evaluation.py`. FID compares Gaussians fitted
to features of the restored and the GT images: InceptionV3 pool3 for
standard FID (`losses/inception.py`), or the LPIPS VGG16 trunk
(`make_vgg_feature_fn`, "FID-VGG", comparable only across runs of this
harness).

`frechet_distance` takes the trace of the matrix square root of C1 C2 in
its symmetric form, tr sqrt(S C2 S) with S = C1^(1/2), through two
symmetric eigendecompositions in float64 (scipy's `sqrtm` of the product
has the same trace). The JAX package sums the square roots of the
eigenvalues of the non-symmetric product instead: the same trace in exact
arithmetic, computed another way (a deviation of method; on random
rank-deficient statistics both agree with scipy's `sqrtm` to ~1e-7,
tests/test_torch_eval.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR; inputs (B, H, W, C) in [-1, 1] by default."""
    mse = ((a.float() - b.float()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def ssim(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 2.0) -> torch.Tensor:
    """Per-sample SSIM (gaussian 11x11, sigma 1.5, valid window,
    channel-averaged)."""
    size, sigma = 11, 1.5
    g = np.exp(-0.5 * ((np.arange(size) - size // 2) / sigma) ** 2)
    g = (g / g.sum()).astype(np.float32)
    c = a.shape[-1]
    win = torch.as_tensor(np.outer(g, g), device=a.device)
    win = win[None, None].expand(c, 1, size, size)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win, groups=c)

    a, b = a.float(), b.float()
    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_a = filt(a * a) - mu_a2
    s_b = filt(b * b) - mu_b2
    s_ab = filt(a * b) - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    m = ((2 * mu_ab + c1) * (2 * s_ab + c2)) / (
        (mu_a2 + mu_b2 + c1) * (s_a + s_b + c2))
    return m.mean(dim=(1, 2, 3))


def _sqrt_psd(m: np.ndarray) -> np.ndarray:
    """Symmetric square root of a symmetric PSD matrix (eigenvalues below 0
    from rounding clamp to 0)."""
    w, v = np.linalg.eigh((m + m.T) / 2)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FID between N(mu1, cov1) and N(mu2, cov2), float64:
    |mu1 - mu2|^2 + tr C1 + tr C2 - 2 tr sqrt(C1^(1/2) C2 C1^(1/2))."""
    mu1, mu2, cov1, cov2 = (np.asarray(v, np.float64)
                            for v in (mu1, mu2, cov1, cov2))
    s1 = _sqrt_psd(cov1)
    m = s1 @ cov2 @ s1
    tr_sqrt = np.sum(np.sqrt(np.clip(np.linalg.eigvalsh((m + m.T) / 2),
                                     0.0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * tr_sqrt)


class FeatureStats:
    """Streaming mean / covariance of features for FID. The sums are
    float64 numpy on the host, as in the JAX package: the one part of the
    scoring that leaves the device (a batch's features, a few kB, go to
    the host)."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    def finalize(self):
        mu = self.sum / self.n
        cov = self.outer / self.n - np.outer(mu, mu)
        cov *= self.n / max(self.n - 1, 1)
        return mu, cov


def make_vgg_feature_fn(lpips) -> Callable[[torch.Tensor], torch.Tensor]:
    """FID-VGG feature function: the LPIPS net's VGG16 relu5_3 tap
    (`lpips`, a `losses.LPIPS`), global-average-pooled; (B, 512)."""

    @torch.no_grad()
    def feature_fn(img: torch.Tensor) -> torch.Tensor:
        return lpips._taps(img.float())[-1].mean(dim=(1, 2))

    return feature_fn


class PairScorer:
    """Running scores over (restored, gt) NHWC batches on one device: the
    per-sample means of `metrics` (psnr, ssim), of `lpips_apply(restored,
    gt)` when given, and the FID between `feature_fn`'s features of the
    restored and the GT images when given."""

    def __init__(self, metrics=("psnr", "ssim"), lpips_apply=None,
                 feature_fn=None):
        self.fns = {m: {"psnr": psnr, "ssim": ssim}[m] for m in metrics}
        if lpips_apply is not None:
            self.fns["lpips"] = lpips_apply
        self.feature_fn = feature_fn
        self.sums = dict.fromkeys(self.fns, 0.0)
        self.stats = None
        self.n = 0

    @torch.no_grad()
    def update(self, restored: torch.Tensor, gt: torch.Tensor) -> None:
        restored, gt = restored.float(), gt.float()
        for k, fn in self.fns.items():
            self.sums[k] += float(fn(restored, gt).sum())
        if self.feature_fn is not None:
            fr, fg = self.feature_fn(restored), self.feature_fn(gt)
            if self.stats is None:
                self.stats = (FeatureStats(fr.shape[1]),
                              FeatureStats(fg.shape[1]))
            self.stats[0].update(fr)
            self.stats[1].update(fg)
        self.n += restored.shape[0]

    def result(self) -> dict[str, float]:
        out = {k: v / self.n for k, v in self.sums.items()}
        if self.stats is not None:
            out["fid"] = frechet_distance(*self.stats[0].finalize(),
                                          *self.stats[1].finalize())
        return out


def evaluate_pairs(restored_iter, metrics=("psnr", "ssim"),
                   lpips_apply=None, feature_fn=None) -> dict[str, float]:
    """Aggregate metrics over an iterator of (restored, gt) NHWC batches."""
    scorer = PairScorer(metrics, lpips_apply, feature_fn)
    for restored, gt in restored_iter:
        scorer.update(restored, gt)
    return scorer.result()
