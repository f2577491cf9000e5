"""The port's training data path against the JAX package, on the CPU.

- `sample_params` and `factor_kernels`: the same numpy code on the same
  seed, so exactly equal.
- The GT side of `RestoreTrainDataset` (load, flip, Lanczos resize, random
  crop) against the JAX dataset on the same PNGs and seeds: exactly equal,
  with the same degradation seeds after it.
- The device JPEG round-trip and the whole device chain (`degrade_all`)
  against JAX's `DeviceDegrader` on injected identical parameters with
  noise sigma 0 (the two frameworks draw different noise). Both compute in
  f32 in different orders, so a pixel whose value lands within rounding of
  a quantisation step can flip by one level, and a flip before the JPEG
  step can move a DCT coefficient across a quantiser step, which spreads a
  few levels over its 8x8 block. Bounds, in u8 levels: JPEG mean |diff|
  <= 0.01, max <= 1; the whole chain mean <= 0.02, max <= 4 (measured: the
  JPEG step exact, the chain mean 0.004, max 1). The GT side
  is equal but for one-level flips where a gray sample's weighted sum
  rounds (< 0.1% of the values).
- The loader: shapes, ranges, the stage-2 uint8 GT grid, and the same
  batches from two loader instances (resume safety).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.data import datasets as jds  # noqa: E402
from vspbfr_tpu.data import device_degrade as jdd  # noqa: E402
from vspbfr_tpu.data.degradations import DegradationConfig as JCfg  # noqa: E402
from vspbfr_tpu.data.device_jpeg import (  # noqa: E402
    jpeg_roundtrip_batch as j_jpeg,
    quality_tables as j_qt,
)
from vspbfr_tpu_torch.data import device_degrade as tdd  # noqa: E402
from vspbfr_tpu_torch.data.datasets import RestoreTrainDataset  # noqa: E402
from vspbfr_tpu_torch.data.degradations import DegradationConfig  # noqa: E402
from vspbfr_tpu_torch.data.device_jpeg import (  # noqa: E402
    jpeg_roundtrip_batch,
    quality_tables,
)

SIZE = 64
SMALL = dict(blur_kernel_half_range=(3, 5), downsample_range=(0.8, 4.0))


def _pngs(tmp_path, n=3, size=(70, 90)):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(n):
        yy, xx = np.mgrid[0:size[0], 0:size[1]]
        img = np.stack([(xx * 3 + i * 40) % 256, (yy * 2) % 256,
                        (xx + yy) % 256], -1).astype(np.float64)
        img += rng.normal(0, 8, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            tmp_path / f"{i}.png")
    return str(tmp_path)


def test_sample_params_and_factor_kernels_equal_jax():
    for kw in ({}, SMALL):
        p = tdd.sample_params(np.random.default_rng(1), 4, SIZE,
                              DegradationConfig(**kw), gray_prob=0.5)
        r = jdd.sample_params(np.random.default_rng(1), 4, SIZE, JCfg(**kw),
                              gray_prob=0.5)
        for f in ("kernels", "alpha", "dh", "dw", "sigma", "quality", "gray"):
            np.testing.assert_array_equal(getattr(p, f), getattr(r, f))
        for a, b in zip(tdd.factor_kernels(p.kernels),
                        jdd.factor_kernels(r.kernels)):
            np.testing.assert_array_equal(a, b)


def test_train_dataset_gt_side_equals_jax(tmp_path):
    root = _pngs(tmp_path)
    port = RestoreTrainDataset(root, im_size=(SIZE, SIZE), seed=3)
    ref = jds.RestoreTrainDataset(root, im_size=(SIZE, SIZE), seed=3,
                                  use_native=False)
    for idx in range(3):
        for epoch in (0, 1):
            a, rng_a = port.sample_gt(idx, epoch)
            b, rng_b = ref.sample_gt(idx, epoch)
            assert a.dtype == np.uint8 and a.shape == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(a, b)
            assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


def test_train_dataset_reads_uint8_npy(tmp_path):
    img = (np.random.default_rng(4).random((SIZE, SIZE, 3)) * 255).astype(
        np.uint8)
    np.save(tmp_path / "a.npy", img)
    ds = RestoreTrainDataset(str(tmp_path), im_size=(SIZE, SIZE), seed=0)
    got, _ = ds.sample_gt(0)
    assert np.array_equal(got, img) or np.array_equal(got, img[:, ::-1])
    np.save(tmp_path / "a.npy", img.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        ds.sample_gt(0)


def test_device_jpeg_matches_jax():
    rng = np.random.default_rng(5)
    b, buf = 3, 48
    imgs = (rng.random((b, buf, buf, 3)) * 255).astype(np.uint8)
    dh = np.array([48, 37, 20], np.int32)
    dw = np.array([48, 37, 20], np.int32)
    qs = (95, 70, 40)
    tl = np.stack([quality_tables(q)[0] for q in qs])
    tc = np.stack([quality_tables(q)[1] for q in qs])
    np.testing.assert_array_equal(tl, np.stack([j_qt(q)[0] for q in qs]))
    ref = np.asarray(j_jpeg(jnp.asarray(imgs), jnp.asarray(dh),
                            jnp.asarray(dw), jnp.asarray(tl),
                            jnp.asarray(tc))).astype(np.int32)
    got = jpeg_roundtrip_batch(torch.tensor(imgs), torch.tensor(dh),
                               torch.tensor(dw), torch.tensor(tl),
                               torch.tensor(tc)).numpy().astype(np.int32)
    d = np.abs(got - ref)
    assert d.mean() <= 0.01 and d.max() <= 1, (d.mean(), d.max())


@pytest.mark.parametrize("quantize_gt", [True, False])
def test_degrade_all_matches_jax_with_sigma_zero(quantize_gt):
    rng = np.random.default_rng(6)
    b = 4
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    gt = np.stack([np.stack([(xx * (3 + i)) % 256, (yy * 2 + 17 * i) % 256,
                             ((xx + yy) * 2) % 256], -1) for i in range(b)])
    gt = np.clip(gt + rng.normal(0, 6, gt.shape), 0, 255).astype(np.uint8)
    p = tdd.sample_params(np.random.default_rng(7), b, SIZE,
                          DegradationConfig(**SMALL), gray_prob=0.5)
    p.sigma[:] = 0.0
    p.alpha[1] = 0.8                       # one hazy sample
    seeds = np.arange(b, dtype=np.uint32)
    jp = jdd.DegradeParams(*[getattr(p, f) for f in (
        "kernels", "alpha", "dh", "dw", "sigma", "quality", "gray")])
    lq_r, gt_r = jdd.DeviceDegrader(SIZE, JCfg(**SMALL)).degrade_batch_device(
        gt, jp, seeds, quantize_gt)
    lq, gt_t = tdd.DeviceDegrader(SIZE, DegradationConfig(**SMALL)).degrade_all(
        torch.tensor(gt), p, seeds, quantize_gt)
    assert lq.shape == gt_t.shape == (b, SIZE, SIZE, 3)
    dg = np.abs(gt_t.numpy() - np.asarray(gt_r))
    assert dg.max() <= 1 / 127.5 + 1e-6 and (dg > 1e-6).mean() < 1e-3
    d = np.abs(lq.numpy() - np.asarray(lq_r)) * 127.5
    assert d.mean() <= 0.02 and d.max() <= 4, (d.mean(), d.max())


def test_device_degrade_loader(tmp_path):
    root = _pngs(tmp_path, n=4)
    ds = RestoreTrainDataset(root, im_size=(SIZE, SIZE), quantize_gt=True,
                             gray_prob=None, config=DegradationConfig(**SMALL),
                             seed=2)

    def grab(n):
        it = tdd.DeviceDegradeLoader(ds, 2, device="cpu", num_workers=2,
                                     seed=2).forever()
        return [next(it) for _ in range(n)]

    a, b = grab(3), grab(3)
    for (lq_a, gt_a), (lq_b, gt_b) in zip(a, b):
        assert lq_a.shape == gt_a.shape == (2, SIZE, SIZE, 3)
        assert lq_a.dtype == gt_a.dtype == torch.float32
        assert -1.0 <= float(lq_a.min()) and float(lq_a.max()) <= 1.0
        # stage-2 GT sits on the uint8 grid
        levels = (gt_a + 1.0) * 127.5
        assert torch.allclose(levels, levels.round(), atol=1e-4)
        assert torch.equal(lq_a, lq_b) and torch.equal(gt_a, gt_b)


def test_loader_refuses_a_set_smaller_than_a_batch(tmp_path):
    ds = RestoreTrainDataset(_pngs(tmp_path, n=3), im_size=(SIZE, SIZE))
    with pytest.raises(ValueError, match="no full batch"):
        next(tdd.DeviceDegradeLoader(ds, 4, device="cpu",
                                     num_workers=1).forever())
