"""The PyTorch port's whole serving path against the JAX pipeline, on the CPU.

Both pipelines run the small config (size 32, decoder 64, encode 64, tiny
IR-SE body, channel_div 8, unpacked layout) with the same parameters (the
flax tree through `state_dict_from_jax`) and the same random draws: the
test reproduces the JAX key splits of `RestorationPipeline.restore` and
hands the DDPM noise and mixing draws to the port. Noise-injection gains
are zero (their init), so the per-layer noise streams, which the two
frameworks cannot share, do not enter.

Bound on every stage's output: mean |err| <= 1e-3 * range and max |err| <=
1e-2 * range, range = max - min of the JAX output (f32).

The random-init diffuser is tamed first: its spatial-attention softmax over
512 features is almost uniform at init, so every output feature is nearly
the same and the LayerNorm after it amplifies f32 rounding by about four
orders of magnitude (a 1e-6 relative input change moves JAX's own 4-step
chain by 4e-3). Scaling that branch's q/k kernels by 4 makes the softmax
selective and the chain well conditioned (the same change then moves it by
2e-4); the JAX and port sides get the same tamed weights.
"""

import functools
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.models.e4e import TINY_STAGES  # noqa: E402
from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.evaluation import psnr  # noqa: E402
from vspbfr_tpu_torch.pipeline import RestorationPipeline  # noqa: E402

CFG = dict(size=32, decoder_size=64, encode_size=64,
           encoder_stages=TINY_STAGES, channel_div=8)
B = 2


def assert_bounded(port, ref):
    port = np.asarray(port.detach().float(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    rng_ = ref.max() - ref.min()
    err = np.abs(port - ref)
    assert err.mean() <= 1e-3 * rng_, (err.mean(), rng_)
    assert err.max() <= 1e-2 * rng_, (err.max(), rng_)


def jax_draws(jpipe, key, batch):
    """The draws `restore` makes from `key`, in the port's `draws` form."""
    k_diff, k_mix, _, _ = jax.random.split(key, 4)
    n_lat = jpipe.psp.n_latent
    init_noise = jax.random.normal(k_diff, (batch, n_lat, 512))
    k_z, k_flip, k_idx = jax.random.split(k_mix, 3)
    z = jax.random.normal(k_z, (2, batch, jpipe.style_dim))
    mix = jax.random.bernoulli(k_flip, jpipe.mixing_prob)
    idx = jnp.where(mix, jax.random.randint(k_idx, (), 1,
                                            jpipe.generator.n_latent),
                    jpipe.generator.n_latent)
    return {"init_noise": torch.tensor(np.asarray(init_noise)),
            "z": torch.tensor(np.asarray(z)), "inject_index": int(idx)}


@pytest.fixture(scope="module")
def pipes():
    jpipe = JaxPipeline(packed_min_res=0, **CFG)
    params = jax.jit(jpipe.init_params)(jax.random.key(0))
    params = jax.tree.map(np.asarray, params)
    for blk in params["diffuser"].values():
        for name in ("q", "k"):
            blk["attention_layer"][name]["kernel"] = (
                blk["attention_layer"][name]["kernel"] * 4.0)
    tpipe = RestorationPipeline(**CFG)
    tpipe.load_state_dict(state_dict_from_jax(params, tpipe))
    return jpipe, params, tpipe.eval()


@pytest.fixture(scope="module")
def low():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("upto", ["encode", "ddpm", "decode", "full"])
def test_restore_prefixes_match_jax(pipes, low, upto):
    jpipe, params, tpipe = pipes
    key = jax.random.key(1)
    fn = jax.jit(functools.partial(jpipe.restore, upto=upto,
                                   return_sample=upto == "full"))
    ref = fn(params, jnp.asarray(low), key)
    got = tpipe.restore(torch.tensor(low), torch.Generator().manual_seed(0),
                        upto=upto, return_sample=upto == "full",
                        draws=jax_draws(jpipe, key, B))
    if upto == "decode":
        assert len(got) == len(ref)
        pairs = zip(got, ref)
    elif upto == "full":
        pairs = zip(got, ref)   # (restored, sample)
    else:
        pairs = [(got, ref)]
    for g, r in pairs:
        assert_bounded(g, r)


def test_psp_decode_matches_jax(pipes):
    """The facade's image-only decode (pooled to out_size)."""
    jpipe, params, tpipe = pipes
    lat = np.random.default_rng(1).standard_normal((1, 10, 512)).astype(
        np.float32)
    ref = jax.jit(jpipe.psp.decode)(params["psp"], jnp.asarray(lat),
                                    noise_rng=jax.random.key(2))
    with torch.no_grad():
        got = tpipe.psp.decode(torch.tensor(lat),
                               generator=torch.Generator().manual_seed(0))
    assert_bounded(got, ref)


def test_restore_draws_from_generator(pipes, low):
    """Without draws=, the same seed gives the same output, another seed
    another one (mixing and noise come from the torch.Generator)."""
    _, _, tpipe = pipes
    x = torch.tensor(low)
    a = tpipe.restore(x, torch.Generator().manual_seed(3))
    b = tpipe.restore(x, torch.Generator().manual_seed(3))
    c = tpipe.restore(x, torch.Generator().manual_seed(4))
    assert a.shape == (B, 32, 32, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bf16_pipeline_psnr(pipes, low):
    """bf16 decoder + RestoreNet stays >= 25 dB from the f32 port on the
    same params and draws (the bound the JAX package's own test uses)."""
    jpipe, params, tpipe = pipes
    p16 = RestorationPipeline(compute_dtype=torch.bfloat16, **CFG)
    p16.load_state_dict(tpipe.state_dict())
    draws = jax_draws(jpipe, jax.random.key(1), B)
    x = torch.tensor(low)
    out32 = tpipe.restore(x, torch.Generator().manual_seed(0), draws=draws)
    out16 = p16.eval().restore(x, torch.Generator().manual_seed(0),
                               draws=draws)
    assert out16.dtype == torch.float32
    assert p16.generator.conv1.modulation.weight.dtype == torch.bfloat16
    assert p16.psp.encoder.input_conv.kernel.dtype == torch.float32
    data_range = max(2 * float(out32.abs().max()), 2.0)
    p = float(psnr(out16, out32, data_range=data_range).mean())
    assert p >= 25.0, f"bf16 pipeline deviates: psnr={p:.2f} dB"


def test_ema_generator_override(pipes, low):
    jpipe, _, tpipe = pipes
    draws = jax_draws(jpipe, jax.random.key(1), 1)
    draws["init_noise"] = draws["init_noise"][:1]
    x = torch.tensor(low[:1])
    from vspbfr_tpu_torch.models.restorenet import RestorationNet
    other = RestorationNet(size=32, channel_div=8)
    other.load_state_dict({k: torch.zeros_like(v) for k, v in
                           tpipe.generator.state_dict().items()})
    a = tpipe.restore(x, torch.Generator().manual_seed(0), draws=draws)
    b = tpipe.restore(x, torch.Generator().manual_seed(0), gen=other,
                      draws=draws)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_infer_cli_on_npy(tmp_path, monkeypatch, pipes, low, with_ckpt):
    from vspbfr_tpu_torch.cli import infer

    monkeypatch.setattr(infer, "RestorationPipeline", functools.partial(
        RestorationPipeline, encode_size=64, encoder_stages=TINY_STAGES,
        channel_div=8))
    lq = tmp_path / "lq"
    lq.mkdir()
    for i in range(2):
        np.save(lq / f"face{i}.npy", low[i])
    argv = ["--lq_dirs", str(lq), "--hq_dirs", str(lq), "--size", "32",
            "--decoder_size", "64", "--batch", "2", "--device", "cpu",
            "--out", str(tmp_path / "out")]
    if with_ckpt:
        torch.save(pipes[2].state_dict(), tmp_path / "pipe.pt")
        argv += ["--ckpt", str(tmp_path / "pipe.pt")]
    report = infer.main(argv)
    entry = report["datasets"]["data0"]
    assert entry["n"] == 2 and len(entry["batch_seconds"]) == 1
    assert np.isfinite(entry["psnr"])
    written = sorted(p.name for p in (tmp_path / "out" / "data0").iterdir())
    # restore, low, sample, gt for each input, and the score log
    assert len(written) == 9 and "data0.log" in written
    assert any(n.startswith("face0_restore") for n in written)
    # pytest keeps every test's directory to the end of the session
    # (and three sessions): its outputs go once checked
    shutil.rmtree(tmp_path)


def test_port_imports_no_jax():
    import vspbfr_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(vspbfr_tpu_torch.__path__,
                                                  "vspbfr_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'flax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 41
    for m in ("cli.train_diffuser", "data.device_degrade", "losses.lpips",
              "train.diffuser_train", "utils.checkpoint"):
        assert f"vspbfr_tpu_torch.{m}" in mods
