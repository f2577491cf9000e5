"""Parity of the PyTorch port's modules with the flax modules, on the CPU.

Each module is built in both packages at small widths; the flax parameters
(jittered away from their init so that biases, noise gains and BN stats
are exercised) go through `state_dict_from_jax` into the port, and both
run on the same numpy inputs with explicit noise.

Tolerance: max |port - jax| <= 1e-3 * max |jax| (f32; deeper stacks than
the op tests, so summation-order differences compound).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.models import code_diffuser as jcd  # noqa: E402
from vspbfr_tpu.models import e4e as je4e  # noqa: E402
from vspbfr_tpu.models import layers as jl  # noqa: E402
from vspbfr_tpu.models import restorenet as jrn  # noqa: E402
from vspbfr_tpu.models import stylegan2 as jsg  # noqa: E402
from vspbfr_tpu_torch.convert import port_key, state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.models import code_diffuser as tcd  # noqa: E402
from vspbfr_tpu_torch.models import e4e as te4e  # noqa: E402
from vspbfr_tpu_torch.models import layers as tl  # noqa: E402
from vspbfr_tpu_torch.models import restorenet as trn  # noqa: E402
from vspbfr_tpu_torch.models import stylegan2 as tsg  # noqa: E402

REL = 1e-3


def assert_rel(port, ref, rel=REL):
    port = np.asarray(port.detach().float(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


def _rand(rng, *shape, scale=1.0, offset=0.0):
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def jitter(params, rng, keep_noise_zero=False):
    """Move every leaf off its init (positive where it must stay so)."""
    flat = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, v in flat[0]:
        name = str(path[-1])
        v = np.asarray(v, np.float32)
        if keep_noise_zero and "noise" in str(path):
            leaves.append(v)
            continue
        d = rng.standard_normal(v.shape).astype(np.float32) * 0.1
        leaves.append(np.abs(v + d) if "var" in name else v + d)
    return jax.tree_util.tree_unflatten(flat[1], leaves)


def port_of(module, flax_params):
    module.load_state_dict(state_dict_from_jax(flax_params, module))
    return module.eval()


def jnp_(a):
    return jnp.asarray(a)


T = torch.tensor
KEY = jax.random.key(0)


def finit(fm, *args, rngs=None, **kw):
    """flax init under jit (eager init of the wide e4e heads takes ~20 s)."""
    fn = jax.jit(functools.partial(fm.init, **kw))
    return fn(rngs or KEY, *args)["params"]


def _styled(rng, up, down, post):
    b, h, cin, cout, sd = 2, 8, 16, 8, 32
    x, s = _rand(rng, b, h, h, cin), _rand(rng, b, sd)
    res = h * 2 if up else (h // 2 if down else h)
    nz = _rand(rng, b, res, res, 1)
    pa = tuple(_rand(rng, b, res, res, cout) for _ in range(2 if post else 0))
    fm = jl.StyledConv(cout, 3, upsample=up, downsample=down)
    params = jitter(finit(fm, jnp_(x), jnp_(s), noise=jnp_(nz),
                          post_add=tuple(map(jnp_, pa))), rng)
    ref = fm.apply({"params": params}, jnp_(x), jnp_(s), noise=jnp_(nz),
                   post_add=tuple(map(jnp_, pa)))
    tm = port_of(tl.StyledConv(cin, cout, sd, upsample=up, downsample=down),
                 params)
    with torch.no_grad():
        got = tm(T(x), T(s), noise=T(nz), post_add=tuple(map(T, pa)))
    assert_rel(got, ref)


@pytest.mark.parametrize("up,down,post", [(True, False, True),
                                          (False, False, False),
                                          (False, True, False)])
def test_styled_conv(rng, up, down, post):
    _styled(rng, up, down, post)


@pytest.mark.parametrize("inter", [False, True])
def test_smart_layer(rng, inter):
    b, h, c, sd = 2, 8, 16, 24
    x, s, nz = _rand(rng, b, h, h, c), _rand(rng, b, sd), _rand(rng, b, h, h, 1)
    fm = jl.SMARTLayer(c)
    params = jitter(finit(fm, jnp_(x), jnp_(s), noise=jnp_(nz)), rng)
    ref = fm.apply({"params": params}, jnp_(x), jnp_(s), noise=jnp_(nz),
                   return_intermediates=inter)
    tm = port_of(tl.SMARTLayer(c, c, sd), params)
    with torch.no_grad():
        got = tm(T(x), T(s), noise=T(nz), return_intermediates=inter)
    if inter:
        assert len(got[1]) == len(ref[1]) == 5
        for g, r in zip(got[1], ref[1]):
            assert_rel(g, r)
        got, ref = got[0], ref[0]
    assert_rel(got, ref)


@pytest.mark.parametrize("kind,k", [("conv", 3), ("conv", 1), ("large", 1),
                                    ("large", 3)])
def test_conv_and_large_conv_layer(rng, kind, k):
    x = _rand(rng, 2, 8, 8, 12)
    if kind == "conv":
        fm, tm = jl.ConvLayer(16, k), tl.ConvLayer(12, 16, k)
    else:
        fm, tm = jl.LargeConvLayer(16, k), tl.LargeConvLayer(12, 16, k)
    params = jitter(finit(fm, jnp_(x)), rng)
    ref = fm.apply({"params": params}, jnp_(x))
    with torch.no_grad():
        got = port_of(tm, params)(T(x))
    assert_rel(got, ref)


def test_to_rgb(rng):
    x, s, skip = (_rand(rng, 2, 8, 8, 16), _rand(rng, 2, 20),
                  _rand(rng, 2, 4, 4, 3))
    fm = jl.ToRGB()
    params = jitter(finit(fm, jnp_(x), jnp_(s), jnp_(skip)), rng)
    ref = fm.apply({"params": params}, jnp_(x), jnp_(s), jnp_(skip))
    with torch.no_grad():
        got = port_of(tl.ToRGB(16, 20), params)(T(x), T(s), T(skip))
    assert_rel(got, ref)


def test_generator(rng):
    size, b = 16, 2
    fm = jsg.Generator(size=size, channel_div=8, packed_min_res=0)
    tm = tsg.Generator(size=size, channel_div=8)
    lat = _rand(rng, b, fm.n_latent, 512)
    noise = [_rand(rng, b, 2 ** (2 + (i + 1) // 2), 2 ** (2 + (i + 1) // 2), 1)
             for i in range(tm.num_layers)]
    params = jitter(finit(fm, jnp_(lat), noise=list(map(jnp_, noise))), rng)
    img, feats = fm.apply({"params": params}, jnp_(lat),
                          noise=list(map(jnp_, noise)), return_features=True)
    port_of(tm, params)
    with torch.no_grad():
        gimg, gfeats = tm(T(lat), noise=list(map(T, noise)),
                          return_features=True)
        _, cut = tm(T(lat), noise=list(map(T, noise)), return_features=True,
                    return_image=False, max_feature_res=8)
    assert_rel(gimg, img)
    assert len(gfeats) == len(feats) and len(cut) == 2
    for g, r in zip(gfeats, feats):
        assert_rel(g, r)
    for g, r in zip(cut, gfeats):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_encoder4editing(rng):
    fm = je4e.Encoder4Editing(stylegan_size=64, stages=je4e.TINY_STAGES,
                              encode_size=64)
    tm = te4e.Encoder4Editing(stylegan_size=64, stages=te4e.TINY_STAGES,
                              encode_size=64)
    x = _rand(rng, 1, 64, 64, 3)
    params = jitter(finit(fm, jnp_(x)), rng)
    ref = fm.apply({"params": params}, jnp_(x))
    with torch.no_grad():
        got = port_of(tm, params)(T(x))
    assert_rel(got, ref)
    a = _rand(rng, 1, 5, 7, 4)
    assert_rel(te4e.resize_bilinear_align_corners(T(a), (9, 3)),
               je4e.resize_bilinear_align_corners(jnp_(a), (9, 3)))


def test_code_diffuser(rng):
    fm, tm = jcd.CodeDiffuser(), tcd.CodeDiffuser()
    x, c = _rand(rng, 2, 18, 512), _rand(rng, 2, 18, 512)
    t = np.array([3, 1], np.int32)
    params = jitter(finit(fm, jnp_(x), jnp_(c), jnp_(t)), rng)
    ref = fm.apply({"params": params}, jnp_(x), jnp_(c), jnp_(t))
    with torch.no_grad():
        got = port_of(tm, params)(T(x), T(c), T(t))
    assert_rel(got, ref)


def test_restoration_net(rng):
    size, b = 16, 1
    fm = jrn.RestorationNet(size=size, channel_div=8, packed_min_res=0)
    tm = trn.RestorationNet(size=size, channel_div=8)
    ch = tsg.channel_dict(2, 8)
    img = _rand(rng, b, size, size, 3)
    feats = [_rand(rng, b, 2 ** (r + 2), 2 ** (r + 2), ch[2 ** (r + 2)])
             for r in range(tm.log_size - 1)]
    pre, z = _rand(rng, b, 18, 512), _rand(rng, 2, b, 512)
    args = (jnp_(img), list(map(jnp_, feats)), jnp_(pre), jnp_(z))
    params = jitter(finit(fm, *args, rngs={"params": KEY, "noise": KEY},
                          inject_index=3), rng, keep_noise_zero=True)
    ref = fm.apply({"params": params}, *args, inject_index=3,
                   rngs={"noise": KEY})
    port_of(tm, params)
    with torch.no_grad():
        got = tm(T(img), list(map(T, feats)), T(pre), T(z), inject_index=3,
                 generator=torch.Generator().manual_seed(0))
    assert_rel(got, ref)


def test_converter_names_and_completeness():
    assert port_key(("convs_3", "conv", "weight")) == "convs.3.conv.weight"
    assert port_key(("block_0", "gamma_fc0", "kernel")) == \
        "block.0.gamma_fc0.kernel"
    tm = tl.ToRGB(16, 20)
    tree = {"conv": {"modulation": {"weight": np.zeros((20, 16)),
                                    "bias": np.zeros(16)},
                     "weight": np.zeros((1, 1, 16, 3))},
            "bias": np.zeros(3)}
    assert set(state_dict_from_jax(tree, tm)) == set(tm.state_dict())
    with pytest.raises(KeyError):
        state_dict_from_jax({**tree, "extra": np.zeros(1)}, tm)
    with pytest.raises(KeyError):
        state_dict_from_jax({"conv": tree["conv"]}, tm)
    with pytest.raises(ValueError):
        state_dict_from_jax({**tree, "bias": np.zeros(4)}, tm)
