"""The StyleGAN2 library surface of the port against the JAX package, on
the CPU: `Generator.map_latent`, `PSPFacade.mean_latent` (given JAX's z
draws), `PSPFacade.noise_mapping` (with and without an inject index),
`truncate_styles` and the pSp `GradualStyleEncoder`.

The same numpy inputs and weights go through both packages (the weights
through `state_dict_from_jax`); the weights are random numpy trees in the
JAX modules' shapes (`jax.eval_shape`, so no init compiles), drawn at the
scales of the modules' inits. Bound: max |port - JAX| <= 1e-4 * max |JAX|
in f32, JAX at `highest` matmul precision (`tests/conftest.py`).
`GradualStyleEncoder` runs at 64 px with `stylegan_size=32` (8 styles:
every level of the pyramid), since its IR-50 depth is fixed by its taps.

Also: every module of the port imports with `jax` and `vspbfr_tpu` made
unimportable.
"""

import pkgutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.models import layers as jlayers  # noqa: E402
from vspbfr_tpu.models.psp import PSPFacade as JaxPSP  # noqa: E402
from vspbfr_tpu.models.stylegan2 import Generator as JaxGenerator  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.models import (  # noqa: E402
    GradualStyleEncoder,
    PSPFacade,
)
from vspbfr_tpu_torch.models.layers import truncate_styles  # noqa: E402

TINY = ((16, 1), (32, 1), (64, 1), (128, 1))
PSP_CFG = dict(out_size=16, size=32, encode_size=32, encoder_stages=TINY,
               channel_div=8)


def assert_close(port, ref):
    port = np.asarray(port.detach(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), (err, np.abs(ref).max())


def random_params(shapes, seed: int, lr_mul_paths=("style",)):
    """Numpy leaves at their init's scale: conv / dense kernels N(0,
    1/fan_in), equalized-lr weights N(0, 1) (N(0, 1/lr_mul^2) in the
    mapping MLP), biases and BN statistics near their init."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        names = [p.key for p in path]
        leaf, shape = names[-1], s.shape
        n = rng.standard_normal(shape)
        if leaf == "kernel":
            out = n / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "weight":
            out = n * (100.0 if names[0] in lr_mul_paths else 1.0)
        elif leaf in ("scale", "var"):
            out = 1.0 + 0.2 * rng.random(shape)
        elif leaf == "alpha":
            out = np.full(shape, 0.25)
        else:
            out = 0.1 * n
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def psp_pair():
    """The JAX PSPFacade (decoder with its mapping MLP) and the port's
    `PSPFacade(mapping=True)` with the same random weights."""
    jpsp = JaxPSP.create(packed_min_res=0, **PSP_CFG)
    shapes = jax.eval_shape(jpsp.init_params, jax.random.key(0))
    shapes["decoder"] = {**shapes["decoder"], **jax.eval_shape(
        lambda k: jpsp.decoder.init(k, jnp.zeros((1, 512)),
                                    method=JaxGenerator.map_latent)
        ["params"], jax.random.key(0))}
    params = random_params(shapes, seed=0)
    psp = PSPFacade(mapping=True, **PSP_CFG).eval()
    psp.load_state_dict(state_dict_from_jax(params, psp))
    return jpsp, params, psp


def test_map_latent_matches_jax(psp_pair):
    jpsp, params, psp = psp_pair
    z = np.random.default_rng(1).standard_normal((8, 512)).astype(
        np.float32)
    ref = jpsp.decoder.apply({"params": params["decoder"]}, jnp.asarray(z),
                             method=JaxGenerator.map_latent)
    assert_close(psp.decoder.map_latent(torch.tensor(z)), ref)


def test_map_latent_needs_the_mapping():
    from vspbfr_tpu_torch.models import Generator

    with pytest.raises(ValueError, match="mapping=True"):
        Generator(size=8).map_latent(torch.zeros(1, 512))


def test_mean_latent_matches_jax(psp_pair):
    """JAX draws z from its key; the port is handed the same z."""
    jpsp, params, psp = psp_pair
    key = jax.random.key(3)
    ref = jpsp.mean_latent(params, key, n_samples=256)
    z = torch.tensor(np.asarray(jax.random.normal(key, (256, 512))))
    got = psp.mean_latent(z=z)
    assert got.shape == (1, 512)
    assert_close(got, ref)
    # drawn from a torch.Generator: 256 draws of (512,), mapped, averaged
    gen = torch.Generator().manual_seed(4)
    drawn = psp.mean_latent(256, generator=gen)
    z = torch.randn((256, 512), generator=torch.Generator().manual_seed(4))
    assert torch.equal(drawn, psp.decoder.map_latent(z).mean(0, keepdim=True))
    with pytest.raises(ValueError):
        psp.mean_latent(16)


@pytest.mark.parametrize("inject_index", [None, 3])
def test_noise_mapping_matches_jax(psp_pair, inject_index):
    jpsp, params, psp = psp_pair
    styles = np.random.default_rng(5).standard_normal((2, 3, 512)).astype(
        np.float32)
    ref = jpsp.noise_mapping(params, jnp.asarray(styles), inject_index)
    got = psp.noise_mapping(torch.tensor(styles), inject_index)
    assert got.shape == (3, psp.n_latent, 512)
    assert_close(got, ref)
    one = psp.noise_mapping(torch.tensor(styles[:1]))
    assert_close(one, jpsp.noise_mapping(params, jnp.asarray(styles[:1])))


def test_truncate_styles_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 8, 512)).astype(np.float32)
    mean = rng.standard_normal((1, 1, 512)).astype(np.float32)
    for trunc in (0.0, 0.7, 1.0):
        ref = jlayers.truncate_styles(jnp.asarray(w), trunc,
                                      jnp.asarray(mean))
        assert_close(truncate_styles(torch.tensor(w), trunc,
                                     torch.tensor(mean)), ref)


def test_gradual_style_encoder_matches_jax():
    from vspbfr_tpu.models.e4e import GradualStyleEncoder as JaxGSE

    jenc = JaxGSE(stylegan_size=32)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda k: jenc.init(k, jnp.asarray(x))["params"],
                            jax.random.key(0))
    params = random_params(shapes, seed=8)
    ref = jax.jit(lambda p, v: jenc.apply({"params": p}, v))(
        params, jnp.asarray(x))
    enc = GradualStyleEncoder(stylegan_size=32).eval()
    enc.load_state_dict(state_dict_from_jax(params, enc))
    del params
    with torch.no_grad():
        got = enc(torch.tensor(x))
    assert got.shape == (2, 8, 512)
    assert_close(got, ref)


def test_port_imports_without_jax():
    """Every module of the port (`cli.convert_ckpt` too) imports in a
    process where any import of `jax` or `vspbfr_tpu` fails."""
    import vspbfr_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(vspbfr_tpu_torch.__path__,
                                                  "vspbfr_tpu_torch.")]
    assert "vspbfr_tpu_torch.cli.convert_ckpt" in mods
    assert "vspbfr_tpu_torch.convert.torch_import" in mods
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['vspbfr_tpu'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import jax\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    # every module imported; only the final `import jax` failed
    assert proc.returncode != 0
    assert proc.stderr.strip().splitlines()[-1].startswith(
        "ModuleNotFoundError: import of jax halted"), proc.stderr
