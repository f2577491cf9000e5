"""The port's host degradation chain against OpenCV and the JAX package,
on the CPU (images of at most 128 px).

- Exactly equal on the same rng: `add_gaussian_noise` (per-channel and
  gray noise), `add_poisson_noise` without the gray draw, and
  `add_jpeg_compression`. The gray taps equal cv2's (`cvtColor` of
  one-hot pixels); a gray image is within one float32 rounding of cv2's,
  which sums with fused multiply-adds (measured: 1.7e-7 relative), so the
  Poisson noise with the gray draw is equal to 1e-6 (measured: 5.1e-8).
- `filter2d` and `resize_linear` against `cv2.filter2D` /
  `cv2.resize(INTER_LINEAR)`: max |diff| <= 1e-5 (measured: filter 0,
  resize 1.2e-7).
- Against the JAX package on the same seeds, in uint8 levels of the
  outputs: `degrade_image`, and `RestoreTrainDataset.sample` at
  n_degraded=2 with the numpy chain and with the C++ engines (the port's
  `csrc/host/degrade.cpp` against the JAX package's OpenCV one, the
  tracked `libvspbfr_degrade.so`), with quantize_gt and with gray forced.
  The float stages agree to ~1e-7, so a value within that of a rounding
  step flips by one level, and a flip before the JPEG step can move a DCT
  coefficient across a quantiser step, which spreads over its 8x8 block.
  Bound: >= 99% of the values equal, max |diff| <= 16 levels (measured:
  degrade_image >= 99.94% equal, max 2; sample >= 99.85% with numpy,
  >= 99.97% with the engines, max 2).
- `DeviceDegrader.degrade_batch` (stage_a -> host JPEG -> stage_b)
  against the JAX package's on injected parameters with sigma 0: the
  stages run in f32 in two frameworks, and at a whole scale ratio (32 ->
  64 px) a quarter of the bilinear outputs are exact half-level ties
  that either side's last-bit rounding breaks its own way. Bound, in u8
  levels: mean |diff| <= 0.05, max 1 (measured: mean 0.021, max 1; the
  stage_a outputs equal but for a value in ~10^4).
- The split loader, `DeviceDegradeLoader(jpeg="host")`, against the JAX
  package's with noise_range (0, 0) (the frameworks draw different
  noise): >= 99% of the LQ values equal and mean |diff| <= 0.05 levels
  (measured: >= 99.80%, mean 0.002, max 1); the GT equal but for
  one-level flips where a gray sample's weighted sum rounds (measured:
  equal).
- The CLIs on the CPU at the tiny config: one stage-3 step with `--loader
  host --n_degraded 2` and one stage-2 step with `--jpeg host`.
- No module of the port imports cv2, jax or vspbfr_tpu, and none imports
  PIL at module level.
"""

import pathlib
import re
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from vspbfr_tpu.data import datasets as jds  # noqa: E402
from vspbfr_tpu.data import degradations as jdeg  # noqa: E402
from vspbfr_tpu.data import device_degrade as jdd  # noqa: E402
from vspbfr_tpu.data import native as jnative  # noqa: E402
from vspbfr_tpu_torch.data import degradations as deg  # noqa: E402
from vspbfr_tpu_torch.data import device_degrade as tdd  # noqa: E402
from vspbfr_tpu_torch.data.datasets import RestoreTrainDataset  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64


def _smooth(rng, h, w):
    """Smooth-ish [0, 1] float32 content (faces compress well)."""
    base = rng.random((h // 4, w // 4, 3)).astype(np.float32)
    return np.clip(cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC),
                   0, 1)


def _faces(tmp_path, n=3, size=SIZE, png=True):
    """n smooth faces as PNGs (the JAX datasets read pictures) or uint8
    `.npy` (the port's CLIs read either)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "faces"
    d.mkdir()
    for i in range(n):
        img = np.round(_smooth(rng, size, size) * 255).astype(np.uint8)
        if png:
            Image.fromarray(img).save(d / f"f{i}.png")
        else:
            np.save(d / f"f{i}.npy", img)
    return str(d)


def _levels_agree(a, b, frac=0.99, max_diff=16):
    """a, b in [-1, 1] (or [0, 1] with scale 255): the share of equal u8
    levels and the largest difference."""
    d = np.abs(np.rint(np.asarray(a) * 127.5) - np.rint(np.asarray(b) * 127.5))
    assert (d == 0).mean() >= frac and d.max() <= max_diff, (
        (d == 0).mean(), d.max())


@pytest.mark.parametrize("gray_prob", [0.0, 1.0])
def test_noise_and_jpeg_equal_jax(gray_prob):
    img = _smooth(np.random.default_rng(1), 48, 40)
    for name in ("add_gaussian_noise", "add_poisson_noise"):
        got = getattr(deg, name)(np.random.default_rng(3), img, (0, 5),
                                 gray_prob=gray_prob)
        ref = getattr(jdeg, name)(np.random.default_rng(3), img, (0, 5),
                                  gray_prob=gray_prob)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if name == "add_poisson_noise" and gray_prob:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        deg.add_jpeg_compression(np.random.default_rng(4), img, (60, 100)),
        jdeg.add_jpeg_compression(np.random.default_rng(4), img, (60, 100)))


def test_gray_taps_equal_cv2():
    eye = np.eye(3, dtype=np.float32)[None]            # one-hot pixels
    for weights, code in ((deg.RGB2GRAY, cv2.COLOR_RGB2GRAY),
                          (deg.BGR2GRAY, cv2.COLOR_BGR2GRAY)):
        np.testing.assert_array_equal(deg.to_gray(eye, weights),
                                      cv2.cvtColor(eye, code))
        img = np.random.default_rng(5).random((20, 30, 3)).astype(np.float32)
        np.testing.assert_allclose(deg.to_gray(img, weights),
                                   cv2.cvtColor(img, code), rtol=2e-7)
    assert deg.BGR2GRAY == jdd._GRAY_W_RGB


@pytest.mark.parametrize("h,w,ks", [(32, 32, 41), (64, 80, 39), (128, 96, 7)])
def test_filter2d_matches_cv2(h, w, ks):
    rng = np.random.default_rng(h + ks)
    img = rng.random((h, w, 3)).astype(np.float32)
    k = deg.random_mixed_kernel(rng, kernel_size=ks, sigma_range=(0.1, 10))
    d = np.abs(deg.filter2d(img, k) - cv2.filter2D(img, -1, k))
    assert d.max() <= 1e-5, d.max()


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)), ((64, 80), (23, 51)),
                                     ((17, 9), (64, 64)), ((128, 128), (128, 128)),
                                     ((128, 128), (120, 125)), ((60, 60), (1, 1))])
def test_resize_linear_matches_cv2(src, dst):
    img = np.random.default_rng(src[0]).random((*src, 3)).astype(np.float32)
    got = deg.resize_linear(img, dst[1], dst[0])
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("size", [64, 128])
def test_degrade_image_matches_jax(size):
    rng = np.random.default_rng(size)
    for seed in range(3):
        gt = _smooth(rng, size, size)
        got = deg.degrade_image(np.random.default_rng(seed), gt)
        ref = jdeg.degrade_image(np.random.default_rng(seed), gt)
        assert got.dtype == np.float32 and got.shape == gt.shape
        _levels_agree(got * 2 - 1, ref * 2 - 1)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("quantize_gt,gray_prob", [(False, 0.008),
                                                   (True, None),
                                                   (False, 1.0)])
def test_dataset_sample_matches_jax(tmp_path, use_native, quantize_gt,
                                    gray_prob):
    assert jnative.available()
    root = _faces(tmp_path)
    kw = dict(im_size=(SIZE, SIZE), n_degraded=2, quantize_gt=quantize_gt,
              gray_prob=gray_prob, seed=1, use_native=use_native)
    port, ref = RestoreTrainDataset(root, **kw), jds.RestoreTrainDataset(
        root, **kw)
    for idx in range(2):
        got, want = port.sample(idx, epoch=idx), ref.sample(idx, epoch=idx)
        assert len(got) == 3
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == (SIZE, SIZE, 3)
            _levels_agree(a, b)
        if quantize_gt:
            levels = (got[-1] + 1.0) * 127.5
            np.testing.assert_allclose(levels, np.round(levels), atol=1e-4)
        if gray_prob == 1.0:
            for x in got:
                assert np.array_equal(x[..., 0], x[..., 2])


def test_degrade_batch_matches_jax():
    """stage_a -> host JPEG -> stage_b on injected parameters, sigma 0."""
    rng = np.random.default_rng(8)
    gt = np.stack([_smooth(rng, SIZE, SIZE) for _ in range(3)])
    dd = tdd.DeviceDegrader(SIZE)
    p = tdd.sample_params(rng, 3, SIZE, dd.cfg, gray_prob=0.5)
    p.sigma[:] = 0.0
    p.alpha[0] = 0.8
    jp = jdd.DegradeParams(*[getattr(p, f) for f in (
        "kernels", "alpha", "dh", "dw", "sigma", "quality", "gray")])
    got = dd.degrade_batch(torch.tensor(gt), p).numpy()
    ref = np.asarray(jdd.DeviceDegrader(SIZE).degrade_batch(gt, jp))
    assert got.shape == gt.shape
    d = np.abs(np.rint(got * 255) - np.rint(ref * 255))
    assert d.mean() <= 0.05 and d.max() <= 1, (d.mean(), d.max())


def test_split_loader_matches_jax(tmp_path):
    root = _faces(tmp_path, n=4)
    cfg = dict(noise_range=(0.0, 0.0))
    port = RestoreTrainDataset(root, im_size=(SIZE, SIZE), gray_prob=0.5,
                               config=deg.DegradationConfig(**cfg), seed=2)
    ref = jds.RestoreTrainDataset(root, im_size=(SIZE, SIZE), gray_prob=0.5,
                                  config=jdeg.DegradationConfig(**cfg), seed=2)
    got = tdd.DeviceDegradeLoader(port, 2, device="cpu", num_workers=2,
                                  seed=2, jpeg="host").forever()
    want = jdd.DeviceDegradeLoader(ref, 2, num_workers=2, seed=2,
                                   jpeg="host").forever()
    for _ in range(2):
        (lq, gt), (lq_r, gt_r) = next(got), next(want)
        assert lq.shape == gt.shape == (2, SIZE, SIZE, 3)
        d = np.abs(np.rint(lq.numpy() * 127.5) - np.rint(np.asarray(lq_r)
                                                         * 127.5))
        assert (d == 0).mean() >= 0.99 and d.mean() <= 0.05, (
            (d == 0).mean(), d.mean())
        dg = np.abs(gt.numpy() - np.asarray(gt_r))
        assert dg.max() <= 1 / 127.5 + 1e-6 and (dg > 1e-6).mean() < 1e-3


def _argv(path, out):
    return ["--path", path, "--device", "cpu", "--tiny", "--size", "32",
            "--decoder_size", "64", "--batch", "2", "--iter", "1",
            "--id_loss_weight", "0", "--save_inter", "100",
            "--show_inter", "100", "--out", out]


def test_clis_train_on_the_host_chains(tmp_path):
    from vspbfr_tpu_torch.cli import train_diffuser, train_restore

    # one intra-op thread: the lane runs six test files at once, and eight
    # threads a process spin in their barriers (measured under the lane:
    # this test 214 s with eight threads, 38 s with one; 11 s alone)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_both_clis(tmp_path, train_diffuser, train_restore)
    finally:
        torch.set_num_threads(threads)


def _train_both_clis(tmp_path, train_diffuser, train_restore):
    path = _faces(tmp_path, n=4, size=32, png=False)
    out = str(tmp_path / "r")
    rep = train_restore.main(_argv(path, out) + ["--loader", "host",
                                                 "--n_degraded", "2"])
    step = rep["steps"][0]
    assert rep["iter"] == 1 and step["r1"] > 0
    assert all(np.isfinite(v) for v in step.values())
    shutil.rmtree(out)
    out = str(tmp_path / "d")
    rep = train_diffuser.main(_argv(path, out) + ["--loader", "device",
                                                  "--jpeg", "host"])
    assert rep["iter"] == 1
    assert all(np.isfinite(v) for v in rep["steps"][0].values())
    shutil.rmtree(out)


def test_port_imports_no_opencv_jax_or_module_level_pil():
    banned = re.compile(r"^\s*(import|from)\s+(cv2|jax|vspbfr_tpu)\b")
    top_pil = re.compile(r"^(import|from)\s+PIL\b")
    files = sorted((ROOT / "vspbfr_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not banned.match(line), f"{f}:{n}: {line}"
            assert not top_pil.match(line), f"{f}:{n}: {line}"
