"""The JPEG round-trip of the host chain, exactly as libjpeg computes it.

Counterpart of the `cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q])`
/ `cv2.imdecode` pair of `vspbfr_tpu/data/degradations.py` and
`device_degrade.py` (the reference's `my_basicsr/my_degradations.py:
681-710`). Entropy coding is lossless, so an encode-then-decode is
libjpeg's integer pipeline alone, which this module computes in numpy,
vectorised over every 8x8 block, for baseline 4:2:0 at the quality's
Annex-K tables (what cv2 writes):

1. RGB -> YCbCr in 16-bit fixed point (`jccolor.c`; Cb and Cr round with
   ONE_HALF - 1). cv2 reads channel 0 as blue, and the callers hand it
   their arrays as they are, so channel 0 is taken as blue here too.
2. Y is padded by edge replication to whole blocks.
3. Chroma is padded at full resolution (rows to an even count, columns to
   twice the chroma block width), summed over 2x2 with a bias of 1, 2,
   1, 2, ... by column and shifted by 2 (`jcsample.c` h2v2); the plane's
   rows are then padded to whole blocks by replicating its last row.
4. The islow forward DCT (`jfdctint.c`) of samples minus 128.
5. Quantisation: (|c| + 4q) // 8q with the sign put back (`jcdctmgr.c`).
6. Dequantisation and the islow inverse DCT (`jidctint.c`), its output
   read through the range-limit table at `x & 1023`.
7. h2v2 fancy upsampling (`jdsample.c`: 3 x nearer + farther, by rows then
   columns, rounded by 8 and 7, edges replicated); box upsampling when
   the chroma plane is at most 2 wide.
8. YCbCr -> RGB in fixed point (`jdcolor.c`), clamped.

No float enters, so the result equals cv2's bit for bit for any size (the
float form on the device, `device_jpeg.py`, only approximates it).
"""

from __future__ import annotations

import numpy as np

from vspbfr_tpu_torch.data.device_jpeg import quality_tables

_SCALE = 16
_HALF = 1 << (_SCALE - 1)
# islow DCT constants: CONST_BITS 13, PASS1_BITS 2 (FIX(x) = round(x 2^13))
_CONST, _PASS1 = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fix(x: float) -> int:
    return int(x * (1 << _SCALE) + 0.5)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_limit() -> np.ndarray:
    """libjpeg's post-IDCT range-limit table, indexed by (v & 1023) for an
    output v relative to 128 (`jdmaster.c` prepare_range_limit_table)."""
    x = np.arange(1024)
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0],
                     x - 896).astype(np.uint8)


_LIMIT = _idct_limit()


def _pad_edge(p: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def _blocks(p: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) plane -> (by, bx, 8, 8) blocks."""
    h, w = p.shape
    return p.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _plane(b: np.ndarray) -> np.ndarray:
    by, bx = b.shape[:2]
    return b.swapaxes(1, 2).reshape(8 * by, 8 * bx)


def _fdct_pass(v: list, first: bool) -> list:
    """One pass of `jpeg_fdct_islow` over the 8 arrays v[0..7] (rows when
    first, then columns)."""
    tmp0, tmp7 = v[0] + v[7], v[0] - v[7]
    tmp1, tmp6 = v[1] + v[6], v[1] - v[6]
    tmp2, tmp5 = v[2] + v[5], v[2] - v[5]
    tmp3, tmp4 = v[3] + v[4], v[3] - v[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = _CONST - _PASS1 if first else _CONST + _PASS1
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << _PASS1
        out[4] = (tmp10 - tmp11) << _PASS1
    else:
        out[0] = _descale(tmp10 + tmp11, _PASS1)
        out[4] = _descale(tmp10 - tmp11, _PASS1)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, n)
    out[6] = _descale(z1 - tmp12 * _F1847, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _idct_pass(v: list, n: int) -> list:
    """One pass of `jpeg_idct_islow` over the 8 arrays v[0..7] (columns
    first, then rows); outputs descaled by n bits."""
    z1 = (v[2] + v[6]) * _F0541
    tmp2 = z1 - v[6] * _F1847
    tmp3 = z1 + v[2] * _F0765
    tmp0 = (v[0] + v[4]) << _CONST
    tmp1 = (v[0] - v[4]) << _CONST
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1 = t0 * _F0298, t1 * _F2053
    t2, t3 = t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return [_descale(tmp10 + t3, n), _descale(tmp11 + t2, n),
            _descale(tmp12 + t1, n), _descale(tmp13 + t0, n),
            _descale(tmp13 - t0, n), _descale(tmp12 - t1, n),
            _descale(tmp11 - t2, n), _descale(tmp10 - t3, n)]


def _roundtrip_plane(p: np.ndarray, table: np.ndarray) -> np.ndarray:
    """A plane of whole blocks (int64 samples 0..255) through FDCT,
    quantisation, dequantisation and IDCT; returns uint8 samples."""
    b = _blocks(p - 128)
    rows = _fdct_pass([b[..., k] for k in range(8)], first=True)
    cols = _fdct_pass([np.stack(rows, -1)[..., k, :] for k in range(8)],
                      first=False)
    coef = np.stack(cols, -2)                       # [..., u, v]
    q8 = table.astype(np.int64) * 8
    qc = np.sign(coef) * ((np.abs(coef) + (q8 >> 1)) // q8)
    dq = qc * table.astype(np.int64)
    ws = _idct_pass([dq[..., k, :] for k in range(8)], _CONST - _PASS1)
    ws = np.stack(ws, -2)
    out = _idct_pass([ws[..., k] for k in range(8)], _CONST + _PASS1 + 3)
    return _plane(_LIMIT[np.stack(out, -1) & 1023])


def _downsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """h2v2 downsampling of a full-resolution chroma plane to whole blocks
    (`jcprep.c` / `jcsample.c` padding and bias)."""
    cw = 8 * -(-w // 16)
    c = _pad_edge(c, h + h % 2, 2 * cw)
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = 1 + (np.arange(cw) & 1)
    return _pad_edge((s + bias) >> 2, 8 * -(-h // 16), cw)


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """The decoder's h2v2 upsampling of a chroma plane's real
    (ceil(h/2), ceil(w/2)) part to (h, w)."""
    ch, cw = -(-h // 2), -(-w // 2)
    c = c[:ch, :cw]
    if cw <= 2:                       # jdsample.c: box, no fancy
        return np.repeat(np.repeat(c, 2, 0), 2, 1)[:h, :w]
    y = np.arange(h)
    near = y // 2
    far = np.clip(np.where(y % 2 == 0, near - 1, near + 1), 0, ch - 1)
    col = 3 * c[near] + c[far]                      # (h, cw)
    j = np.arange(w) // 2
    odd = np.arange(w) % 2
    side = np.clip(np.where(odd == 1, j + 1, j - 1), 0, cw - 1)
    return (3 * col[:, j] + col[:, side] + 8 - odd) >> 4


def jpeg_roundtrip(img_u8: np.ndarray, quality: int) -> np.ndarray:
    """cv2's encode (baseline, 4:2:0, `quality`) then decode of an
    (H, W, 3) uint8 image, channel 0 taken as blue; returns uint8 (H, W,
    3), equal to `cv2.imdecode(cv2.imencode(".jpg", img_u8, ...)[1], 1)`."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    x = img.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    off = (128 << _SCALE) + _HALF - 1
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b
         + _HALF) >> _SCALE
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + off) >> _SCALE
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off) >> _SCALE
    tl, tc = (t.astype(np.int64) for t in quality_tables(int(quality)))
    y = _roundtrip_plane(_pad_edge(y, 8 * -(-h // 8), 8 * -(-w // 8)),
                         tl)[:h, :w].astype(np.int64)
    cb, cr = (_upsample(_roundtrip_plane(_downsample(c, h, w), tc)
                        .astype(np.int64), h, w) for c in (cb, cr))
    cc = np.arange(256) - 128
    cr_r = (_fix(1.402) * cc + _HALF) >> _SCALE
    cb_b = (_fix(1.772) * cc + _HALF) >> _SCALE
    cr_g = -_fix(0.71414) * cc
    cb_g = -_fix(0.34414) * cc + _HALF
    out = np.stack([y + cb_b[cb], y + ((cb_g[cb] + cr_g[cr]) >> _SCALE),
                    y + cr_r[cr]], -1)
    return np.clip(out, 0, 255).astype(np.uint8)
