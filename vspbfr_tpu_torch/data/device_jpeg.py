"""JPEG round-trip simulation on the device (the lossy core of libjpeg).

Counterpart of `vspbfr_tpu/data/device_jpeg.py`. The degradation chain's
JPEG step (`my_basicsr/my_degradations.py:681-710` upstream) is an
encode-then-decode whose entropy coding is lossless, so the round-trip is
the deterministic lossy core:

    RGB -> JFIF YCbCr -> 4:2:0 chroma box-downsample -> per-8x8-block
    DCT-II -> quantise by the quality-scaled Annex-K tables (round) ->
    dequantise -> IDCT -> fancy (9-3-3-1 triangle) chroma upsample ->
    RGB -> clamp/round to u8

in float, batched over samples. libjpeg computes it in fixed point, so
outputs differ from it by a few +-1 levels scattered per block. Block grids
work on the static padded buffer; values beyond a sample's valid (dh, dw)
region are border-replicated first, as libjpeg's MCU edge padding does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ITU-T T.81 Annex K quantisation base tables (row-major)
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float64)
_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float64)


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg jpeg_set_quality / jpeg_add_quant_table scaling."""
    q = int(np.clip(quality, 1, 100))
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def scale_tbl(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.float32)

    return scale_tbl(_Q_LUMA), scale_tbl(_Q_CHROMA)


def _dct_matrix(device) -> torch.Tensor:
    """Orthonormal 8-point DCT-II matrix D: coefficients = D @ block @ D.T."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    d *= np.sqrt(2.0 / 8.0)
    d[0] *= 1.0 / np.sqrt(2.0)
    return torch.tensor(d.astype(np.float32), device=device)


def _replicate_border(x: torch.Tensor, dh: torch.Tensor,
                      dw: torch.Tensor) -> torch.Tensor:
    """Replicate row dh-1 and column dw-1 outward on (B, H, W[, C])."""
    b, h, w = x.shape[:3]
    ar_h = torch.arange(h, device=x.device)
    ar_w = torch.arange(w, device=x.device)
    src_r = torch.minimum(ar_h[None], (dh - 1)[:, None])
    src_c = torch.minimum(ar_w[None], (dw - 1)[:, None])
    bi = torch.arange(b, device=x.device)[:, None, None]
    return x[bi, src_r[:, :, None], src_c[:, None, :]]


def _box_down2(p: torch.Tensor) -> torch.Tensor:
    """2x2 box average (libjpeg h2v2_downsample; bias-free float form)."""
    b, h, w = p.shape
    return p.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _fancy_up2(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2 'fancy' (triangle 9-3-3-1 / 16) chroma upsample with
    replicated borders; (B, h, w) -> (B, 2h, 2w)."""
    cp = F.pad(c[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    n = cp[:, 1:-1, 1:-1]
    up, dn = cp[:, :-2, 1:-1], cp[:, 2:, 1:-1]
    lf, rt = cp[:, 1:-1, :-2], cp[:, 1:-1, 2:]
    ul, ur = cp[:, :-2, :-2], cp[:, :-2, 2:]
    dl, dr = cp[:, 2:, :-2], cp[:, 2:, 2:]

    def phase(vert, horiz, diag):
        return (9.0 * n + 3.0 * vert + 3.0 * horiz + diag) / 16.0

    p00, p01 = phase(up, lf, ul), phase(up, rt, ur)
    p10, p11 = phase(dn, lf, dl), phase(dn, rt, dr)
    b, h, w = c.shape
    out = torch.stack([torch.stack([p00, p01], dim=3),
                       torch.stack([p10, p11], dim=3)], dim=2)
    return out.reshape(b, 2 * h, 2 * w)


def jpeg_roundtrip_plane(p: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """(B, H, W) planes in [0, 255], per-sample (B, 8, 8) tables:
    DCT-quantise-dequantise-IDCT on every 8x8 block."""
    b, h, w = p.shape
    d = _dct_matrix(p.device)
    blk = p.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    coef = torch.einsum("ij,bxyjk,lk->bxyil", d, blk - 128.0, d)
    t = tbl[:, None, None]
    q = torch.round(coef / t) * t
    out = torch.einsum("ji,bxyjk,kl->bxyil", d, q, d) + 128.0
    return out.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def jpeg_roundtrip_batch(imgs_u8: torch.Tensor, dh: torch.Tensor,
                         dw: torch.Tensor, tl: torch.Tensor,
                         tc: torch.Tensor) -> torch.Tensor:
    """Device JPEG round-trip of the valid (dh, dw) region of each static
    (H, W, 3) u8 buffer (H, W multiples of 16). imgs_u8 (B, H, W, 3); dh,
    dw (B,) int; tl, tc (B, 8, 8) per-sample quality tables. Returns the
    full buffers, round-tripped, u8."""
    x = _replicate_border(imgs_u8.float(), dh, dw)
    # cv2/libjpeg treats channel 0 as blue, and the reference feeds its RGB
    # arrays to cv2.imencode as they are: apply the BGR convention to
    # whatever order arrives (the round-trip keeps the order)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    y2 = jpeg_roundtrip_plane(y, tl)
    # libjpeg pads each component to its block grid after downsampling:
    # re-replicate the chroma planes at the true ceil(d/2) size
    ch, cw = (dh + 1) // 2, (dw + 1) // 2

    def chroma(p):
        small = _replicate_border(_box_down2(p), ch, cw)
        return _fancy_up2(jpeg_roundtrip_plane(small, tc))

    cb2, cr2 = chroma(cb), chroma(cr)
    r2 = y2 + 1.402 * (cr2 - 128.0)
    g2 = y2 - 0.344136286 * (cb2 - 128.0) - 0.714136286 * (cr2 - 128.0)
    b2 = y2 + 1.772 * (cb2 - 128.0)
    out = torch.stack([b2, g2, r2], dim=-1)  # ch0 = blue, as it arrived
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
