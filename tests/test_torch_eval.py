"""FID / LPIPS scoring in the port against `vspbfr_tpu/evaluation.py` and
`vspbfr_tpu/losses/inception.py`, on the CPU.

- `InceptionV3Features` on seeded flax parameters carried over by
  `state_dict_from_jax`, b2 at 299 px: <= 1e-4 of max |jax|; the feature
  function (resize to 299, antialiased) at 64 px input, the same bound.
- `FeatureStats`: mean and covariance <= 1e-12 of JAX's.
- `frechet_distance` against JAX's on well-conditioned statistics (n =
  4096 samples, dim 64): 1e-6 rel; on rank-deficient ones (n = 16 < dim =
  64) against the trace of scipy's `sqrtm` of the product: 1e-6 rel. The
  JAX package's eigenvalues-of-the-product shortcut is held to scipy
  beside it on the same statistics, at the same bound: it agrees to
  ~1e-8, so the deviation the symmetric form was chosen against does not
  show on this data.
- `evaluate_pairs` with LPIPS and the VGG feature function: psnr, ssim,
  lpips against JAX's evaluate_pairs (1e-4 rel), fid against the standard
  FID of JAX's own VGG features (1e-4 rel: 3 pairs of 512-d features, a
  rank-2 covariance).
- The infer CLI with `--lpips_ckpt` / `--inception_ckpt` from temp files:
  finite lpips and fid beside psnr / ssim, the scoring timed per batch.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
scipy_linalg = pytest.importorskip("scipy.linalg")

import jax.numpy as jnp  # noqa: E402

from test_torch_losses import _random_params  # noqa: E402
from vspbfr_tpu import evaluation as jev  # noqa: E402
from vspbfr_tpu.losses import inception as jinc  # noqa: E402
from vspbfr_tpu.losses import lpips as jlp  # noqa: E402
from vspbfr_tpu_torch import evaluation as tev  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.losses import (  # noqa: E402
    LPIPS,
    InceptionV3Features,
    make_inception_feature_fn,
)

T = torch.tensor


def rel(port, ref) -> float:
    port = np.asarray(port.detach() if hasattr(port, "detach") else port,
                      np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def inception():
    params = _random_params(jinc.InceptionV3Features().init,
                            jnp.zeros((1, 299, 299, 3)), seed=3)
    net = InceptionV3Features()
    net.load_state_dict(state_dict_from_jax(params, net))
    return params, net.eval()


def test_inception_features_match_jax(inception):
    params, net = inception
    x = np.random.default_rng(4).uniform(-1, 1, (2, 299, 299, 3)).astype(
        np.float32)
    ref = jax.jit(jinc.InceptionV3Features().apply)({"params": params},
                                                    jnp.asarray(x))
    with torch.no_grad():
        got = net(T(x))
    assert got.shape == (2, 2048)
    assert rel(got, ref) <= 1e-4


def test_inception_feature_fn_matches_jax(inception):
    params, net = inception
    x = np.random.default_rng(5).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jinc.make_inception_feature_fn(params)(jnp.asarray(x))
    got = make_inception_feature_fn(net)(T(x))
    assert not got.requires_grad
    assert rel(got, ref) <= 1e-4


def _stats(feats_a, feats_b, chunks=3):
    """JAX's and the port's FeatureStats over the same features, fed in
    chunks."""
    out = []
    for mod in (jev, tev):
        sa, sb = mod.FeatureStats(feats_a.shape[1]), \
            mod.FeatureStats(feats_b.shape[1])
        for ca, cb in zip(np.array_split(feats_a, chunks),
                          np.array_split(feats_b, chunks)):
            sa.update(ca)
            sb.update(T(cb) if mod is tev else cb)
        out.append((*sa.finalize(), *sb.finalize()))
    return out


def test_feature_stats_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((500, 32)).astype(np.float32)
    b = rng.standard_normal((500, 32)).astype(np.float32) * 2 + 1
    ref, got = _stats(a, b)
    for g, r in zip(got, ref):
        assert g.dtype == np.float64
        assert rel(g, r) <= 1e-12


def _scipy_fid(mu1, c1, mu2, c2) -> float:
    tr = np.trace(scipy_linalg.sqrtm(c1 @ c2)).real
    d = mu1 - mu2
    return float(d @ d + np.trace(c1) + np.trace(c2) - 2 * tr)


def test_frechet_distance_well_conditioned_matches_jax():
    rng = np.random.default_rng(7)
    mix = rng.standard_normal((64, 64)) * 0.3
    a = rng.standard_normal((4096, 64)) @ mix
    b = rng.standard_normal((4096, 64)) @ mix * 1.2 + 0.1
    stats = _stats(a, b)[1]
    got = tev.frechet_distance(*stats)
    assert abs(got - jev.frechet_distance(*stats)) <= 1e-6 * abs(got)
    assert abs(got - _scipy_fid(*stats)) <= 1e-6 * abs(got)


def test_frechet_distance_rank_deficient_against_scipy():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((16, 64))
    b = rng.standard_normal((16, 64)) * 1.5 + 0.2
    stats = _stats(a, b)[1]
    assert np.linalg.matrix_rank(stats[1]) == 15
    ref = _scipy_fid(*stats)
    got = tev.frechet_distance(*stats)
    assert abs(got - ref) <= 1e-6 * abs(ref)
    # the JAX package's shortcut on the same statistics, recorded: within
    # 1e-6 of scipy here too
    assert abs(jev.frechet_distance(*stats) - ref) <= 1e-6 * abs(ref)


@pytest.fixture(scope="module")
def lpips():
    z = jnp.zeros((1, 32, 32, 3))
    params = _random_params(jlp.LPIPS().init, z, z, seed=9)
    net = LPIPS()
    net.load_state_dict(state_dict_from_jax(params, net))
    return params, net.eval()


def test_evaluate_pairs_matches_jax(lpips):
    params, net = lpips
    rng = np.random.default_rng(10)
    pairs = [tuple(rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
                   for _ in range(2)) for b in (2, 1)]
    jnet = jlp.LPIPS()
    jfeat = jev.make_vgg_feature_fn(params)
    ref = jev.evaluate_pairs(
        [(jnp.asarray(r), jnp.asarray(g)) for r, g in pairs],
        lpips_apply=jax.jit(lambda a, b: jnet.apply({"params": params}, a,
                                                    b)),
        feature_fn=jfeat)
    got = tev.evaluate_pairs([(T(r), T(g)) for r, g in pairs],
                             lpips_apply=net,
                             feature_fn=tev.make_vgg_feature_fn(net))
    assert set(got) == {"psnr", "ssim", "lpips", "fid"}
    for k in ("psnr", "ssim", "lpips"):
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), k
    # fid: the standard FID of JAX's own features
    feats = [np.concatenate([np.asarray(jfeat(jnp.asarray(p[i])))
                             for p in pairs]) for i in (0, 1)]
    stats = _stats(*feats, chunks=1)[0]
    assert abs(got["fid"] - _scipy_fid(*stats)) <= 1e-4 * abs(got["fid"])


def test_infer_cli_scores_lpips_and_fid(tmp_path, lpips):
    from vspbfr_tpu_torch.cli import infer
    from vspbfr_tpu_torch.models.layers import init_module

    rng = np.random.default_rng(11)
    lq, hq = tmp_path / "lq", tmp_path / "hq"
    lq.mkdir()
    hq.mkdir()
    for i in range(3):
        np.save(lq / f"f{i}.npy", rng.uniform(-1, 1, (32, 32, 3)).astype(
            np.float32))
        np.save(hq / f"f{i}.npy", rng.uniform(-1, 1, (32, 32, 3)).astype(
            np.float32))
    torch.save(lpips[1].state_dict(), tmp_path / "lpips.pt")
    inc = init_module(InceptionV3Features(), torch.Generator().manual_seed(1))
    torch.save(inc.state_dict(), tmp_path / "inception.pt")
    rep = infer.main(["--lq_dirs", str(lq), "--hq_dirs", str(hq), "--tiny",
                      "--size", "32", "--decoder_size", "64", "--batch", "3",
                      "--device", "cpu", "--out", str(tmp_path / "out"),
                      "--no-save_images",
                      "--lpips_ckpt", str(tmp_path / "lpips.pt"),
                      "--inception_ckpt", str(tmp_path / "inception.pt")])
    entry = rep["datasets"]["data0"]
    assert entry["n"] == 3
    assert len(entry["score_seconds"]) == len(entry["batch_seconds"]) == 1
    for k in ("psnr", "ssim", "lpips", "fid"):
        assert np.isfinite(entry[k]), k
    assert entry["lpips"] > 0 and entry["fid"] > 0
