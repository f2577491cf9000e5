"""The degradation chain on the device: the training data path.

Counterpart of `vspbfr_tpu/data/device_degrade.py` (its one-program form,
`degrade_all` with the device JPEG). The host samples each image's
parameters and builds its blur kernel (`sample_params`, `factor_kernels`);
the device runs the whole chain on a batch:

    reflect-pad -> per-sample blur (SVD-separable banded matmuls) ->
    optional hazy blend -> dynamic bilinear downscale x[0.8, 8] onto a
    static buffer -> gaussian noise + clip -> u8 quantise -> JPEG round-trip
    (`device_jpeg.py`) -> bilinear resize back -> u8-grid quantise ->
    optional gray

and finishes the GT the same way (gray, and the stage-2 uint8 round-trip
with `quantize_gt`). Semantics follow the JAX package, which follows
`degradations.py::degrade_image` / the reference's `dataset.py:327-372`.
The noise field comes from one `torch.Generator` per sample, seeded from
the sample's seed: the same distribution as the JAX package's, not the
same numbers. Shapes are static: the downscaled image lives in a
(buf, buf) buffer (buf = size / min_scale, on the 16-pixel JPEG MCU grid)
and each sample's true (dh, dw) enters only through the resize matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.data.datasets import DataLoader
from vspbfr_tpu_torch.data.degradations import (
    DegradationConfig,
    random_mixed_kernel,
)
from vspbfr_tpu_torch.data.device_jpeg import (
    jpeg_roundtrip_batch,
    quality_tables,
)

# cv2 COLOR_BGR2GRAY taps as the reference's to-gray path applies them to
# RGB data (`dataset.py:306-315` upstream), so R gets the B weight
_GRAY_W_RGB = (0.114, 0.587, 0.299)
# rank buckets of the separable blur (the last is exact for 41x41)
_RANK_BUCKETS = (12, 24, 41)


@dataclasses.dataclass
class DegradeParams:
    """Per-batch sampled degradation parameters (host numpy)."""

    kernels: np.ndarray      # (B, K, K) f32, zero-padded to the max K
    alpha: np.ndarray        # (B,) f32 hazy blend alpha; 1.0 = no haze
    dh: np.ndarray           # (B,) i32 downscaled height
    dw: np.ndarray           # (B,) i32 downscaled width
    sigma: np.ndarray        # (B,) f32 gaussian noise sigma (in /255 units)
    quality: np.ndarray      # (B,) i32 JPEG quality
    gray: np.ndarray         # (B,) bool grayscale flag


def sample_params(rng: np.random.Generator, batch: int, size: int,
                  cfg: DegradationConfig, gray_prob: float = 0.0
                  ) -> DegradeParams:
    """One chain's parameters per image, with the distributions and the
    per-sample draw order of `degrade_image` (`dataset.py:327-372`)."""
    kmax = 2 * cfg.blur_kernel_half_range[1] + 1
    kernels = np.zeros((batch, kmax, kmax), np.float32)
    alpha = np.ones((batch,), np.float32)
    dh = np.empty((batch,), np.int32)
    dw = np.empty((batch,), np.int32)
    sigma = np.zeros((batch,), np.float32)
    quality = np.full((batch,), 100, np.int32)
    gray = np.zeros((batch,), bool)
    for i in range(batch):
        half = rng.integers(cfg.blur_kernel_half_range[0],
                            cfg.blur_kernel_half_range[1] + 1)
        ks = int(half) * 2 + 1
        k = random_mixed_kernel(rng, cfg.kernel_list, cfg.kernel_prob, ks,
                                sigma_range=cfg.blur_sigma)
        p = (kmax - ks) // 2
        kernels[i, p:p + ks, p:p + ks] = k
        if cfg.hazy_prob is not None and rng.uniform() < cfg.hazy_prob:
            alpha[i] = rng.uniform(*cfg.hazy_alpha)
        scale = rng.uniform(*cfg.downsample_range)
        dh[i] = int(size // scale)
        dw[i] = int(size // scale)
        if cfg.noise_range is not None:
            sigma[i] = rng.uniform(*cfg.noise_range)
        if cfg.jpeg_range is not None:
            quality[i] = int(rng.uniform(*cfg.jpeg_range))
        if gray_prob > 0.0:
            gray[i] = rng.uniform() < gray_prob
    return DegradeParams(kernels, alpha, dh, dw, sigma, quality, gray)


def factor_kernels(kernels: np.ndarray, tol: float = 1e-7):
    """Host-side SVD of (B, K, K) blur kernels into separable column/row
    taps, k_b = sum_i u[b, :, i] v[b, :, i]^T, truncated to the smallest
    rank bucket whose residual singular values are < tol for every sample
    (the last bucket is exact). Returns (u, v, rank), u and v (B, K, rank)."""
    b, k, _ = kernels.shape
    u = np.zeros((b, k, k), np.float32)
    v = np.zeros((b, k, k), np.float32)
    need = 1
    for i in range(b):
        uu, ss, vt = np.linalg.svd(kernels[i].astype(np.float64))
        u[i] = (uu * ss).astype(np.float32)
        v[i] = vt.T.astype(np.float32)
        need = max(need, int(np.sum(ss >= tol)))
    rank = min(next((r for r in _RANK_BUCKETS if r >= min(need, k)), k), k)
    return u[:, :, :rank], v[:, :, :rank], rank


def _banded(taps: torch.Tensor, n_out: int, n_in: int) -> torch.Tensor:
    """Toeplitz band matrices M[..., j, w] = taps[..., w - j]
    (0 <= w - j < K) from (..., K) taps by the pad/tile/reshape trick
    (needs n_in + 1 - K >= n_out, true for 'valid' convs)."""
    k = taps.shape[-1]
    if n_in + 1 - k < n_out:
        raise ValueError(f"band {n_out}x{n_in} too small for {k} taps")
    lead = taps.shape[:-1]
    row = torch.cat([taps, taps.new_zeros(lead + (n_in + 1 - k,))], dim=-1)
    t = row.repeat(*([1] * len(lead)), n_out)
    return t[..., : n_out * n_in].reshape(lead + (n_out, n_in))


def blur_batch_separable(x: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Per-sample 2D FIR in the SVD-separable form with a REFLECT_101
    border (cv2.filter2D: cross-correlation, centre anchor):
    y_b = sum_i Bcol(u_bi) @ x_pad @ Brow(v_bi)^T. x (B, H, W, C); u, v
    (B, K, R)."""
    b, h, w, c = x.shape
    p = u.shape[1] // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
               mode="reflect").permute(0, 2, 3, 1)
    by = _banded(u.transpose(1, 2), h, h + 2 * p)   # (B, R, h, H + 2p)
    bx = _banded(v.transpose(1, 2), w, w + 2 * p)
    t = torch.einsum("brhH,bHWc->brhWc", by, xp)
    return torch.einsum("brhWc,brwW->bhwc", t, bx)


def _resize_axis_matrix(out_px: int, in_px: int, src: torch.Tensor,
                        dst: torch.Tensor) -> torch.Tensor:
    """(B, out_px, in_px) bilinear operators for one axis, cv2 INTER_LINEAR
    coordinates f = (j + 0.5) * src/dst - 0.5 with clamped (replicated)
    indices; src and dst are (B,) f32 sizes."""
    j = torch.arange(out_px, dtype=torch.float32, device=src.device)
    f = (j[None] + 0.5) * (src / dst)[:, None] - 0.5
    i0f = torch.floor(f)
    wt = f - i0f
    hi = (src.to(torch.int64) - 1)[:, None]
    i0 = torch.clamp(i0f.to(torch.int64), min=0)
    i0 = torch.minimum(i0, hi)
    i1 = torch.minimum(torch.clamp(i0f.to(torch.int64) + 1, min=0), hi)
    cols = torch.arange(in_px, device=src.device)[None, None]
    m0 = (cols == i0[..., None]).float() * (1.0 - wt)[..., None]
    m1 = (cols == i1[..., None]).float() * wt[..., None]
    return m0 + m1


def resize_bilinear_dynamic(x: torch.Tensor, src_h, src_w, dst_h, dst_w,
                            out_px: int) -> torch.Tensor:
    """Bilinear resize of each sample's valid (src_h, src_w) region of a
    static (B, H, W, C) buffer onto the valid (dst_h, dst_w) region of a
    static (B, out_px, out_px, C) buffer, as two batched matmuls. Sizes
    are (B,) f32 tensors. Rows and columns beyond the valid output
    interpolate clamped border pixels (finite, ignored downstream)."""
    ry = _resize_axis_matrix(out_px, x.shape[1], src_h, dst_h)
    rx = _resize_axis_matrix(out_px, x.shape[2], src_w, dst_w)
    rows = torch.einsum("boi,biwc->bowc", ry, x)
    return torch.einsum("bpw,bowc->bopc", rx, rows)


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """cv2 convertTo(CV_8U, 255): round half to even, saturate."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def _to_gray(x: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_GRAY_W_RGB, device=x.device)
    g = torch.sum(x * w, dim=-1, keepdim=True).expand_as(x)
    return torch.where(gray[:, None, None, None], g, x)


class DeviceDegrader:
    """The whole chain as one batched pass on the device of its input."""

    def __init__(self, size: int = 512,
                 cfg: DegradationConfig = DegradationConfig()):
        self.size = size
        self.cfg = cfg
        # static downscale buffer: the largest downscaled size, rounded up
        # to the 16x16 JPEG MCU grid
        self.buf = int(np.ceil(size / cfg.downsample_range[0]))
        self.buf += (-self.buf) % 16

    def noise(self, seeds: np.ndarray, device) -> torch.Tensor:
        """(B, buf, buf, 3) f32 N(0, 1), one generator per sample seed, so a
        sample's noise does not depend on its batch."""
        out = []
        for s in seeds:
            gen = torch.Generator(device=device).manual_seed(int(s))
            out.append(torch.randn((self.buf, self.buf, 3), generator=gen,
                                   device=device))
        return torch.stack(out)

    def degrade_all(self, gt_u8: torch.Tensor, p: DegradeParams,
                    seeds: np.ndarray, quantize_gt: bool = False):
        """gt_u8 (B, size, size, 3) uint8 on the device -> (lq, gt), both
        (B, size, size, 3) f32 in [-1, 1] on that device."""
        dev = gt_u8.device
        u, v, _ = factor_kernels(np.asarray(p.kernels))
        tl = np.stack([quality_tables(int(q))[0] for q in p.quality])
        tc = np.stack([quality_tables(int(q))[1] for q in p.quality])

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        alpha, sigma = t(p.alpha), t(p.sigma)
        dh, dw = t(p.dh), t(p.dw)
        gray = t(p.gray, torch.bool)
        full = torch.full_like(dh, float(self.size))
        gt = gt_u8.float() / 255.0
        x = blur_batch_separable(gt, t(u), t(v))
        a = alpha[:, None, None, None]
        x = x * a + (1.0 - a)
        x = resize_bilinear_dynamic(x, full, full, dh, dw, self.buf)
        x = torch.clamp(x + self.noise(seeds, dev)
                        * (sigma / 255.0)[:, None, None, None], 0.0, 1.0)
        small = _quantize_u8(x)
        jp = jpeg_roundtrip_batch(small, t(p.dh, torch.int64),
                                  t(p.dw, torch.int64), t(tl), t(tc))
        x = resize_bilinear_dynamic(jp.float() / 255.0, dh, dw, full, full,
                                    self.size)
        lq = _to_gray(_quantize_u8(x).float() / 255.0, gray)
        gt = _to_gray(gt, gray)
        gt = (torch.round(gt * 255.0) / 127.5 - 1.0 if quantize_gt
              else gt * 2.0 - 1.0)
        return lq * 2.0 - 1.0, gt


class DeviceDegradeLoader:
    """(lq, gt) training batches, degraded on `device` (the card unless
    the caller asks for another).

    Wraps the threaded `DataLoader` over a GT-only view of a
    `RestoreTrainDataset` (uint8 GT and a per-sample seed, from the
    dataset's own `sample_gt`), samples each image's parameters from its
    seed on the host, uploads the uint8 batch and runs `degrade_all`. The
    dataset's quantize_gt, gray_prob and config apply. Yields (lq, gt),
    both (B, H, W, 3) f32 in [-1, 1] on `device`."""

    def __init__(self, dataset, batch_size: int, *, device="cuda",
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0):
        self.ds = dataset
        self.device = torch.device(device)
        self.dd = DeviceDegrader(size=dataset.im_size[0], cfg=dataset.config)
        self.gray_prob = float(dataset.gray_prob or 0.0)
        self.quantize_gt = dataset.quantize_gt
        self.inner = DataLoader(_GTView(dataset), batch_size,
                                num_workers=num_workers, prefetch=prefetch,
                                seed=seed)

    def batches_per_epoch(self) -> int:
        return self.inner.batches_per_epoch()

    def params(self, seeds: np.ndarray) -> DegradeParams:
        parts = [sample_params(np.random.default_rng(int(s)), 1,
                               self.ds.im_size[0], self.ds.config,
                               self.gray_prob) for s in seeds]
        return DegradeParams(*[np.concatenate([getattr(q, f.name)
                                               for q in parts])
                               for f in dataclasses.fields(DegradeParams)])

    def forever(self, start_epoch: int = 0, start_batch: int = 0):
        for gt_u8, seeds in self.inner.forever(start_epoch, start_batch):
            seeds = np.asarray(seeds, np.uint32)
            gt = torch.as_tensor(gt_u8).to(self.device, non_blocking=True)
            yield self.dd.degrade_all(gt, self.params(seeds), seeds,
                                      self.quantize_gt)


@dataclasses.dataclass
class _GTView:
    """GT-only dataset adapter: (gt u8 HWC, per-sample degradation seed)."""

    ds: Any

    def __len__(self):
        return len(self.ds)

    def sample(self, idx: int, epoch: int = 0):
        gt, rng = self.ds.sample_gt(idx, epoch)
        seed = rng.integers(0, np.iinfo(np.uint32).max, dtype=np.uint32)
        return gt, np.uint32(seed)
