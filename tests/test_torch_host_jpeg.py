"""The host chain's JPEG round-trip against libjpeg, on the CPU.

- `host_jpeg.jpeg_roundtrip` (libjpeg's integer pipeline in numpy) against
  `cv2.imdecode(cv2.imencode(".jpg", ...))` (libjpeg-turbo): bit for bit,
  at sizes from 1x1 to 640 px (odd, even, under one block, under one MCU,
  chroma 1 or 2 wide), on random, smooth, saturated and noisy-smooth
  images, at qualities 60 to 100.
- The C++ engine's round-trip (`native.jpeg_roundtrip`) against
  `jpeg_roundtrip` on the same grid: bit for bit.
- `DeviceDegrader.host_jpeg` (each sample's (dh, dw) crop of a padded
  buffer) against the JAX package's, which calls cv2: bit for bit.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vspbfr_tpu.data import device_degrade as jdd  # noqa: E402
from vspbfr_tpu_torch.data import device_degrade as tdd  # noqa: E402
from vspbfr_tpu_torch.data import native  # noqa: E402
from vspbfr_tpu_torch.data.host_jpeg import jpeg_roundtrip  # noqa: E402

SIZES = [(1, 1), (2, 5), (6, 1), (7, 9), (8, 8), (15, 17), (16, 16),
         (33, 47), (64, 96), (101, 77), (97, 203), (64, 64), (256, 256),
         (640, 640)]
QUALITIES = (60, 75, 90, 99, 100)


def _images(h, w, seed):
    """Random, smooth, saturated and noisy-smooth (H, W, 3) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                       (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    return {
        "random": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "smooth": np.round(smooth).astype(np.uint8),
        "saturated": np.where(rng.random((h, w, 3)) < 0.5, 0,
                              255).astype(np.uint8),
        "noisy_smooth": np.clip(smooth + rng.normal(0, 12, smooth.shape), 0,
                                255).astype(np.uint8),
    }


def _cv2_roundtrip(img, q):
    ok, enc = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), q])
    assert ok
    return cv2.imdecode(enc, 1)


@pytest.mark.parametrize("h,w", SIZES)
def test_jpeg_roundtrip_equals_cv2(h, w):
    for kind, img in _images(h, w, seed=h * 1000 + w).items():
        for q in QUALITIES:
            got = jpeg_roundtrip(img, q)
            assert got.dtype == np.uint8 and got.shape == img.shape
            np.testing.assert_array_equal(got, _cv2_roundtrip(img, q),
                                          err_msg=f"{kind} q{q}")


@pytest.mark.parametrize("h,w", SIZES)
def test_native_jpeg_equals_host_jpeg(h, w):
    for kind, img in _images(h, w, seed=h * 1000 + w + 1).items():
        for q in QUALITIES:
            np.testing.assert_array_equal(native.jpeg_roundtrip(img, q),
                                          jpeg_roundtrip(img, q),
                                          err_msg=f"{kind} q{q}")


def test_jpeg_roundtrip_refuses_other_inputs():
    with pytest.raises(ValueError, match="uint8"):
        jpeg_roundtrip(np.zeros((8, 8, 3), np.float32), 90)
    with pytest.raises(ValueError, match="uint8"):
        native.jpeg_roundtrip(np.zeros((8, 8), np.uint8), 90)


@pytest.mark.parametrize("size", [64, 512])
def test_device_degrader_host_jpeg_equals_jax(size):
    dd = tdd.DeviceDegrader(size)
    rng = np.random.default_rng(size)
    b = 4
    small = rng.integers(0, 256, (b, dd.buf, dd.buf, 3), dtype=np.uint8)
    p = tdd.sample_params(rng, b, size, dd.cfg)
    p.dh[0], p.dw[0] = dd.buf, dd.buf        # the largest downscale
    p.dh[1], p.dw[1] = 1, 3                  # below one block
    jp = jdd.DegradeParams(*[getattr(p, f) for f in (
        "kernels", "alpha", "dh", "dw", "sigma", "quality", "gray")])
    np.testing.assert_array_equal(
        dd.host_jpeg(small, p),
        jdd.DeviceDegrader(size).host_jpeg(small, jp))
