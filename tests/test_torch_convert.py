"""The port's converters of the reference's torch checkpoints against the
JAX package's, on the CPU.

For each of the nine converters of `vspbfr_tpu_torch.convert`: the leaf
shapes come from `jax.eval_shape` of the JAX module's init (nothing
compiles), a reference-keyed random dict is built from them with the JAX
package's key functions in the reference's layouts (linear (out, in), conv
OIHW, modulated conv (1, O, I, k, k), NCHW buffers, with entries the
converters must ignore), and the port's result is held against the JAX
composition `torch_import.convert_* -> state_dict_from_jax(tree, port
module)` with `torch.equal` on every key: the tolerance is exact. A
missing reference key raises `KeyError` in both.

Configs are the tiny ones (`channel_div`, `TINY_STAGES`, small encode
sizes); LPIPS, ResNet-101 and InceptionV3 have their full shapes, which
cost no compute here.
"""

import re
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from vspbfr_tpu.convert import torch_import as jti  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.convert import torch_import as pti  # noqa: E402
from vspbfr_tpu_torch.models.layers import init_module  # noqa: E402

KEY = jax.random.key(0)
TINY = ((16, 1), (32, 1), (64, 1), (128, 1))

# reference keys of modulated-conv weights, stored (1, O, I, k, k)
_MOD = re.compile(r"((^|\.)(conv1|convs\.\d+|to_rgb1|to_rgbs\.\d+|"
                  r"encoder_convs\.\d+)\.conv\.weight|"
                  r"ModulatedConv2ds\.\d+\.weight)$")
# (C,) or (C, 1) port leaves stored (1, C, 1, 1): ToRGB bias, LPIPS lin
_BIAS4 = re.compile(r"((^|\.)to_rgb(1|s\.\d+)\.bias|lin\d\.model\.1\.weight)$")


def ref_shape(tk: str, shape) -> tuple:
    """The reference's layout of a flax leaf of `shape` under key tk."""
    shape = tuple(shape)
    if _BIAS4.search(tk):
        return (1, shape[0], 1, 1)
    if len(shape) == 2:
        return shape[::-1]
    if len(shape) == 4:
        kh, kw, ci, co = shape
        if tk == "input.input":                      # NCHW const input
            return (kh, co, kw, ci)
        if _MOD.search(tk):
            return (1, co, ci, kh, kw)
        return (co, ci, kh, kw)
    return shape


def reference_dict(shapes, key_fn, seed: int) -> dict:
    """A random reference-keyed dict for the flax shape tree `shapes`."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        tk = key_fn(tuple(p.key for p in path))
        out[tk] = rng.standard_normal(ref_shape(tk, leaf.shape)).astype(
            np.float32)
    return out


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]


def _eval_shape(module, *args, **kw):
    return jax.eval_shape(lambda k: module.init(k, *args, **kw)["params"],
                          KEY)


# --- the cases: (JAX shape tree, port module, JAX key fn, converters) ------

def _generator(mapping):
    from vspbfr_tpu.models.stylegan2 import Generator as JG
    from vspbfr_tpu_torch.models import Generator

    jg = JG(size=64, channel_div=8, packed_min_res=0)
    shapes = jax.eval_shape(lambda k: jg.init(
        {"params": k, "noise": k}, jnp.zeros((1, jg.n_latent, 512)))
        ["params"], KEY)
    if mapping:
        shapes = {**shapes, **_eval_shape(jg, jnp.zeros((1, 512)),
                                          method=JG.map_latent)}
    return (shapes, Generator(size=64, channel_div=8, mapping=mapping),
            jti._generator_key, {"noises.noise_0": np.zeros((1, 1, 4, 4)),
                                 "convs.0.conv.blur.kernel": np.ones((4, 4))},
            jti.convert_stylegan2_generator, pti.convert_stylegan2_generator)


def _restorenet():
    from vspbfr_tpu.pipeline import RestorationPipeline as JP
    from vspbfr_tpu_torch.models import RestorationNet

    jp = JP(size=32, decoder_size=64, encode_size=32, encoder_stages=TINY,
            channel_div=8, packed_min_res=0)
    shapes = jax.eval_shape(jp.init_params, KEY)["generator"]
    return (shapes, RestorationNet(size=32, channel_div=8),
            jti._restorenet_key, {"style.0.dummy": np.zeros(1)},
            jti.convert_restoration_net, pti.convert_restoration_net)


def _discriminator():
    from vspbfr_tpu.models.restorenet import Discriminator as JD
    from vspbfr_tpu_torch.models import Discriminator

    shapes = _eval_shape(JD(size=32, channel_div=8),
                         jnp.zeros((1, 32, 32, 3)))
    return (shapes, Discriminator(size=32, channel_div=8),
            lambda n: jti._discriminator_key(n, 5), {},
            lambda t, sd: jti.convert_discriminator(t, sd, size=32),
            lambda m, sd: pti.convert_discriminator(m, sd, size=32))


def _e4e():
    from vspbfr_tpu.models.e4e import Encoder4Editing as JE
    from vspbfr_tpu_torch.models import Encoder4Editing

    shapes = _eval_shape(JE(stylegan_size=32, stages=TINY, encode_size=32),
                         jnp.zeros((1, 32, 32, 3)))
    return (shapes, Encoder4Editing(stylegan_size=32, stages=TINY,
                                    encode_size=32),
            jti._e4e_key, {"input_layer.1.num_batches_tracked": np.zeros(())},
            jti.convert_e4e_encoder, pti.convert_e4e_encoder)


def _gradual():
    from vspbfr_tpu.models.e4e import GradualStyleEncoder as JGS
    from vspbfr_tpu_torch.models import GradualStyleEncoder

    shapes = _eval_shape(JGS(stylegan_size=8), jnp.zeros((1, 64, 64, 3)))
    return (shapes, GradualStyleEncoder(stylegan_size=8), jti._e4e_key, {},
            jti.convert_e4e_encoder, pti.convert_e4e_encoder)


def _diffuser():
    from vspbfr_tpu.models.code_diffuser import CodeDiffuser as JC
    from vspbfr_tpu_torch.models import CodeDiffuser

    lat = jnp.zeros((1, 18, 512))
    shapes = _eval_shape(JC(timesteps=4), lat, lat,
                         jnp.zeros((1,), jnp.int32))
    return (shapes, CodeDiffuser(), jti._code_diffuser_key, {},
            jti.convert_code_diffuser, pti.convert_code_diffuser)


def _resnet101():
    from vspbfr_tpu.losses.id_loss import ResNet101Embedder as JR
    from vspbfr_tpu_torch.losses import ResNet101Embedder

    shapes = _eval_shape(JR(), jnp.zeros((1, 112, 112, 3)))
    return (shapes, ResNet101Embedder(), jti._resnet101_key,
            {"bn1.num_batches_tracked": np.zeros(())},
            jti.convert_resnet101, pti.convert_resnet101)


def _lpips():
    from vspbfr_tpu.losses.lpips import LPIPS as JL
    from vspbfr_tpu_torch.losses import LPIPS

    z = jnp.zeros((1, 64, 64, 3))

    def split(conv):
        # the VGG16 file and the lin file, as the CLI reads them
        return lambda m, sd: conv(
            m, {k: v for k, v in sd.items() if not k.startswith("lin")},
            {k: v for k, v in sd.items() if k.startswith("lin")})

    return (_eval_shape(JL(), z, z), LPIPS(), jti._lpips_key,
            {"classifier.0.weight": np.zeros((2, 2))},
            split(jti.convert_lpips), split(pti.convert_lpips))


def _inception():
    from vspbfr_tpu.losses.inception import InceptionV3Features as JI
    from vspbfr_tpu_torch.losses import InceptionV3Features

    shapes = _eval_shape(JI(), jnp.zeros((1, 299, 299, 3)))
    return (shapes, InceptionV3Features(), jti._inception_key,
            {"fc.weight": np.zeros((2, 2)),
             "AuxLogits.conv0.conv.weight": np.zeros((1, 1, 1, 1))},
            jti.convert_inception_v3, pti.convert_inception_v3)


CASES = {"generator": lambda: _generator(False),
         "generator_mapping": lambda: _generator(True),
         "restorenet": _restorenet, "discriminator": _discriminator,
         "e4e": _e4e, "gradual_style_encoder": _gradual,
         "code_diffuser": _diffuser, "resnet101": _resnet101,
         "lpips": _lpips, "inception_v3": _inception}


@pytest.fixture(scope="module")
def restorenet_case():
    shapes, module, key_fn, extra, jconv, pconv = _restorenet()
    return module, reference_dict(shapes, key_fn, seed=1), pconv


@pytest.mark.parametrize("name", list(CASES))
def test_converter_matches_jax(name):
    """Port converter == JAX converter + state_dict_from_jax, exactly;
    extra reference entries are ignored and a missing one raises in both."""
    shapes, module, key_fn, extra, jconv, pconv = CASES[name]()
    sd = reference_dict(shapes, key_fn, seed=len(name))
    sd.update(extra)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jconv(shapes, sd)),
                               module)
    got = pconv(module, sd)
    assert_same(got, want)
    module.load_state_dict(got)             # strict
    gone = sorted(sd)[len(sd) // 2]
    assert gone not in extra
    del sd[gone]
    with pytest.raises(KeyError, match=re.escape(gone)):
        pconv(module, sd)
    with pytest.raises(KeyError):
        jconv(shapes, sd)


def _psp(encode_size=32):
    from vspbfr_tpu.models.psp import PSPFacade as JPSP
    from vspbfr_tpu_torch.models import PSPFacade

    kw = dict(out_size=16, size=32, encode_size=encode_size,
              encoder_stages=TINY, channel_div=8)
    jpsp = JPSP.create(packed_min_res=0, **kw)
    return jpsp, jax.eval_shape(jpsp.init_params, KEY), PSPFacade(**kw)


def test_psp_checkpoint_matches_jax_and_tiles_latent_avg(tmp_path):
    """`style_encoder_decoder.pt` (encoder.*, decoder.* with the reference
    decoder's mapping MLP and noise buffers, a 1-D latent_avg) through both
    converters; the 1-D latent_avg is tiled to n_latent rows."""
    jpsp, shapes, psp = _psp()
    sd = {f"encoder.{k}": v for k, v in reference_dict(
        shapes["encoder"], jti._e4e_key, seed=3).items()}
    sd.update({f"decoder.{k}": v for k, v in reference_dict(
        shapes["decoder"], jti._generator_key, seed=4).items()})
    row = np.random.default_rng(5).standard_normal(512).astype(np.float32)
    sd.update({"latent_avg": row, "decoder.style.1.weight": np.zeros((2, 2)),
               "decoder.noises.noise_0": np.zeros((1, 1, 4, 4))})
    path = str(tmp_path / "style_encoder_decoder.pt")
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    want = state_dict_from_jax(jax.tree.map(
        np.asarray, jti.convert_psp_checkpoint(jpsp, shapes, path)), psp)
    got = pti.convert_psp_checkpoint(psp, path)
    assert_same(got, want)
    assert got["latent_avg"].shape == (psp.n_latent, 512)
    assert torch.equal(got["latent_avg"],
                       torch.as_tensor(row)[None].repeat(psp.n_latent, 1))
    # e4e's trainer saves latent_avg beside a state_dict entry: the port
    # reads it there too
    wrapped = {"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()
                              if k != "latent_avg"},
               "latent_avg": torch.as_tensor(row), "opts": {"size": 32}}
    assert_same(pti.convert_psp_checkpoint(psp, wrapped), want)
    del wrapped["latent_avg"]
    with pytest.raises(KeyError, match="latent_avg"):
        pti.convert_psp_checkpoint(psp, wrapped)
    # pytest keeps every test's directory to the end of the session
    # (and three sessions): its outputs go once checked
    shutil.rmtree(tmp_path)


def test_square_linear_is_transposed():
    """A 2-D weight is always transposed, a square one too (the code
    diffuser's 512 x 512 projections), in both packages."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    sq = np.arange(9, dtype=np.float32).reshape(3, 3)
    assert torch.equal(pti.fit_tensor(sq, (3, 3), "k"),
                       torch.as_tensor(sq.T))
    np.testing.assert_array_equal(jti.fit_tensor(sq, (3, 3), "k"), sq.T)
    assert torch.equal(pti.fit_tensor(w, (4, 3), "k"), torch.as_tensor(w.T))
    for fit in (pti.fit_tensor, jti.fit_tensor):
        with pytest.raises(ValueError):
            fit(w, (3, 4), "k")


def test_layout_tries_follow_jax():
    """4-D: identity, OIHW -> HWIO, NCHW -> NHWC; 5-D modulated; reshape
    on an equal size, as the JAX package tries them."""
    rng = np.random.default_rng(0)
    for arr, shape in ((rng.standard_normal((8, 3, 3, 5)), (3, 5, 3, 8)),
                       (rng.standard_normal((8, 3, 3, 5)), (8, 3, 3, 5)),
                       (rng.standard_normal((1, 6, 4, 4)), (1, 4, 4, 6)),
                       (rng.standard_normal((1, 6, 5, 3, 3)), (3, 3, 5, 6)),
                       (rng.standard_normal((1, 3, 1, 1)), (3,))):
        got = pti.fit_tensor(arr, shape, "k")
        np.testing.assert_array_equal(got.numpy(),
                                      jti.fit_tensor(arr, shape, "k"))
    for fit in (pti.fit_tensor, jti.fit_tensor):
        with pytest.raises(ValueError):
            fit(np.zeros((2, 3, 4)), (5, 5), "k")


def test_flatten_heads_match_torch_nchw(restorenet_case):
    """RestoreNet's final_linear / final_transfer and D's final_linear.0
    cross a flatten boundary: with the converted weights, the port's NHWC
    flatten gives what torch's NCHW flatten gives (in float64, so only the
    order of the sums differs)."""
    from vspbfr_tpu_torch.models import Discriminator

    def f64(v):
        return torch.as_tensor(v).double()

    module, sd, pconv = restorenet_case
    got = {k: f64(v) for k, v in pconv(module, sd).items()}
    ch4 = got["final_transfer.bias"].shape[0] // 16
    rng = np.random.default_rng(7)
    x = f64(rng.standard_normal((2, ch4, 4, 4)))
    ref = x.flatten(1) @ f64(sd["final_linear.0.weight"]).T
    port = x.permute(0, 2, 3, 1).reshape(2, -1) @ got["final_linear.weight"]
    torch.testing.assert_close(port, ref, rtol=1e-12, atol=1e-12)
    z = f64(rng.standard_normal((2, 2 * ch4)))
    ref = (z @ f64(sd["final_transfer.weight"]).T
           + f64(sd["final_transfer.bias"])).view(2, ch4, 4, 4)
    port = (z @ got["final_transfer.weight"]
            + got["final_transfer.bias"]).reshape(2, 4, 4, ch4)
    torch.testing.assert_close(port, ref.permute(0, 2, 3, 1), rtol=1e-12,
                               atol=1e-12)
    d = Discriminator(size=32, channel_div=8)
    dsd = chip_smoke.reference_state_dict(init_module(
        d, torch.Generator().manual_seed(8)))
    w = f64(pti.convert_discriminator(Discriminator(size=32, channel_div=8),
                                      dsd, size=32)["final_linear0.weight"])
    x = f64(rng.standard_normal((2, w.shape[0] // 16, 4, 4)))
    torch.testing.assert_close(
        x.permute(0, 2, 3, 1).reshape(2, -1) @ w,
        x.flatten(1) @ f64(dsd["final_linear.0.weight"]).T, rtol=1e-12,
        atol=1e-12)


def _seeded(module, seed):
    return init_module(module, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", ["restorenet", "discriminator",
                                  "code_diffuser", "generator_mapping",
                                  "lpips", "inception_v3"])
def test_chip_smoke_writer_round_trips(name):
    """`chip_smoke.reference_state_dict` (the reference layouts phase 11
    writes) of a seeded port module converts back to it exactly through
    the port's converter and through the JAX composition."""
    shapes, module, _, _, jconv, pconv = CASES[name]()
    _seeded(module, 9)
    with torch.no_grad():                   # no zero-initialised entries
        for p in module.parameters():
            p.add_(torch.rand(p.shape, generator=torch.Generator()
                              .manual_seed(p.numel())))
    want = module.state_dict()
    ref = chip_smoke.reference_state_dict(module)
    assert_same(pconv(module, ref), want)
    tree = jconv(shapes, {k: v.numpy() for k, v in ref.items()})
    assert_same(state_dict_from_jax(jax.tree.map(np.asarray, tree), module),
                want)


def test_chip_smoke_writer_round_trips_psp(tmp_path):
    """The psp file as phase 11 writes it (1-D latent_avg, ignored
    entries) through both packages' `convert_psp_checkpoint`."""
    jpsp, shapes, psp = _psp()
    _seeded(psp, 10)
    row = torch.randn(512, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        psp.latent_avg.copy_(row[None].expand(psp.n_latent, -1))
    ref = chip_smoke.reference_state_dict(psp)
    assert ref["latent_avg"].shape == (512,)
    path = str(tmp_path / "psp.pt")
    torch.save(ref, path)
    want = psp.state_dict()
    assert_same(pti.convert_psp_checkpoint(psp, path), want)
    assert_same(state_dict_from_jax(jax.tree.map(
        np.asarray, jti.convert_psp_checkpoint(jpsp, shapes, path)), psp),
        want)
    # pytest keeps every test's directory to the end of the session
    # (and three sessions): its outputs go once checked
    shutil.rmtree(tmp_path)
