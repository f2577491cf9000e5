"""ADA in the port against `vspbfr_tpu/losses/ada.py`, on the CPU.

The port draws its raw numbers from a `torch.Generator`; here they are
JAX's own, reproduced from the key the JAX sampler splits (the same
`randint` / `uniform` / `normal` calls, and `uniform` where JAX calls
`bernoulli`, which is `uniform < p`), so `affine_from_draws` and
`color_from_draws` must give JAX's matrices. JAX runs at `highest`
matmul precision (tests/conftest.py).

Tolerances: the matrices and `_inv3` 1e-6; the FIR passes (the port's
sums of shifted slices against JAX's banded-matmul form) 1e-5; the warp,
`apply_affine`, `apply_color` and `augment` 1e-5 of max |jax|; the input
gradient of D(augment(x)) and R1's parameter gradient 1e-4 of max; the
controller's p over 600 steps 1e-7.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.losses import ada as jada  # noqa: E402
from vspbfr_tpu_torch.losses import ada  # noqa: E402

T = torch.tensor
B = 2


def np_(x):
    return np.asarray(x.detach() if hasattr(x, "detach") else x, np.float64)


def rel(port, ref) -> float:
    port, ref = np_(port), np_(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12))


def jax_affine_draws(key, batch):
    """`draw_affine`'s entries from the sub-keys `sample_affine` splits."""
    ks = jax.random.split(key, 16)
    u = jax.random.uniform
    vals = {"flip": jax.random.randint(ks[0], (batch,), 0, 2),
            "r90": jax.random.randint(ks[2], (batch,), 0, 4),
            "t_int": u(ks[4], (2, batch), minval=-0.125, maxval=0.125),
            "iso": jax.random.normal(ks[6], (batch,)),
            "th_pre": u(ks[8], (batch,), minval=-math.pi, maxval=math.pi),
            "aniso": jax.random.normal(ks[10], (batch,)),
            "th_post": u(ks[12], (batch,), minval=-math.pi, maxval=math.pi),
            "t_frac": jax.random.normal(ks[14], (2, batch)),
            "gates": jnp.stack([u(ks[i], (batch,)) for i in range(1, 16, 2)])}
    return {k: T(np.asarray(v, np.float32)) for k, v in vals.items()}


def jax_color_draws(key, batch):
    """`draw_color`'s entries from the sub-keys `sample_color` splits."""
    ks = jax.random.split(key, 10)
    vals = {"bright": jax.random.normal(ks[0], (batch,)),
            "contrast": jax.random.normal(ks[2], (batch,)),
            "luma": jax.random.randint(ks[4], (batch,), 0, 2),
            "hue": jax.random.uniform(ks[6], (batch,), minval=-math.pi,
                                      maxval=math.pi),
            "sat": jax.random.normal(ks[8], (batch,)),
            "gates": jnp.stack([jax.random.uniform(ks[i], (batch,))
                                for i in range(1, 10, 2)])}
    return {k: T(np.asarray(v, np.float32)) for k, v in vals.items()}


def jax_augment_draws(key, batch):
    """The draws of `augment(key, ...)` in JAX: the affine from the first
    half of its split, the color from the second."""
    k1, k2 = jax.random.split(key)
    return {"affine": jax_affine_draws(k1, batch),
            "color": jax_color_draws(k2, batch)}


def smooth_images(seed, b, h, w):
    """Random images in [-1, 1] with some smooth structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(6 * xx + i) * np.cos(4 * yy - i)
                     for i in range(3)], -1)
    return (0.6 * base[None] + 0.4 * rng.uniform(-1, 1, (b, h, w, 3))
            ).astype(np.float32)


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_matrices_from_draws_match_jax(p):
    key = jax.random.key(7)
    b, h, w = 6, 64, 48
    k1, k2 = jax.random.split(key)
    g_ref = jada.sample_affine(k1, jnp.float32(p), b, h, w)
    c_ref = jada.sample_color(k2, jnp.float32(p), b)
    d = jax_augment_draws(key, b)
    g = ada.affine_from_draws(d["affine"], T(p), h, w)
    c = ada.color_from_draws(d["color"], T(p))
    assert np.abs(np_(g) - np_(g_ref)).max() <= 1e-6
    assert np.abs(np_(c) - np_(c_ref)).max() <= 1e-6
    if p == 0.0:
        assert torch.equal(g, torch.eye(3).expand(b, 3, 3))
        assert torch.equal(c, torch.eye(4).expand(b, 4, 4))


def test_draws_have_the_jax_layout():
    d = ada.draw_augment(5, torch.Generator().manual_seed(0), "cpu")
    ref = jax_augment_draws(jax.random.key(0), 5)
    for part in ("affine", "color"):
        assert d[part].keys() == ref[part].keys()
        for k, v in d[part].items():
            assert v.shape == ref[part][k].shape and v.dtype == torch.float32
    a = d["affine"]
    assert set(a["flip"].tolist()) <= {0.0, 1.0}
    assert set(a["r90"].tolist()) <= {0.0, 1.0, 2.0, 3.0}
    assert float(a["t_int"].abs().max()) <= 0.125
    assert float(a["gates"].min()) >= 0 and float(a["gates"].max()) < 1


def test_inv3_matches_jax():
    key = jax.random.key(3)
    g = jada.sample_affine(key, jnp.float32(1.0), 8, 64, 64)
    got = ada._inv3(T(np.asarray(g)))
    assert rel(got, jada._inv3(g)) <= 1e-6
    assert rel(got @ T(np.asarray(g)), np.broadcast_to(np.eye(3),
                                                      (8, 3, 3))) <= 1e-5


@pytest.mark.parametrize("up,down,pad", [(2, 1, (6, 5)), (1, 2, (1, 4)),
                                         (1, 1, (3, 3)), (1, 2, (-1, -1))])
def test_fir_passes_match_the_matmul_form(up, down, pad):
    x = np.random.default_rng(1).standard_normal((2, 21, 26, 3)).astype(
        np.float32)
    kern = jnp.asarray(jada.SYM6)
    xt = T(x).permute(0, 3, 1, 2)
    got_x = ada.upfir_x(xt, ada.SYM6, up, down, pad).permute(0, 2, 3, 1)
    got_y = ada.upfir_y(xt, ada.SYM6, up, down, pad).permute(0, 2, 3, 1)
    ref_x = jada._upfir_x_mm(jnp.asarray(x), kern, up, down, pad)
    ref_y = jada._upfir_y_mm(jnp.asarray(x), kern, up, down, pad)
    assert np.abs(np_(got_x) - np_(ref_x)).max() <= 1e-5
    assert np.abs(np_(got_y) - np_(ref_y)).max() <= 1e-5


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(2)
    img = smooth_images(3, B, 20, 24)
    grid = rng.uniform(-1.2, 1.2, (B, 13, 17, 2)).astype(np.float32)
    got = ada.grid_sample_bilinear(T(img), T(grid))
    assert rel(got, jada.grid_sample_bilinear(jnp.asarray(img),
                                              jnp.asarray(grid))) <= 1e-5


@pytest.mark.parametrize("size", [64, 32])
def test_apply_affine_matches_jax(size):
    img = smooth_images(4, B, size, size)
    g = jada.sample_affine(jax.random.key(size), jnp.float32(0.8), B, size,
                           size)
    got = ada.apply_affine(T(img), T(np.asarray(g)))
    assert got.shape == (B, size, size, 3)
    assert rel(got, jada.apply_affine(jnp.asarray(img), g)) <= 1e-5


def test_apply_color_and_augment_match_jax():
    img = smooth_images(5, B, 32, 32)
    key = jax.random.key(11)
    c = jada.sample_color(key, jnp.float32(1.0), B)
    assert rel(ada.apply_color(T(img), T(np.asarray(c))),
               jada.apply_color(jnp.asarray(img), c)) <= 1e-5
    for p in (0.3, 1.0):
        got = ada.augment(T(img), jax_augment_draws(key, B), T(p))
        assert rel(got, jada.augment(key, jnp.asarray(img),
                                     jnp.float32(p))) <= 1e-5


def _two_conv_d(params, x, conv):
    """D(x) = sum of a 3x3 conv, lrelu, a 3x3 stride-2 conv: (B,) logits."""
    h = conv(x, params[0], 1)
    h = h * 0.2 + h * (h > 0) * 0.8
    return conv(h, params[1], 2).mean(axis=(1, 2, 3))


def test_input_gradient_and_r1_match_jax():
    """d/dx sum(D(augment(x))) and the R1 penalty's gradient in D's
    parameters (a double backward through the augment)."""
    size, p = 32, 0.7
    rng = np.random.default_rng(6)
    img = smooth_images(7, B, size, size)
    ws = [rng.standard_normal((3, 3, 3, 8)).astype(np.float32) * 0.3,
          rng.standard_normal((3, 3, 8, 4)).astype(np.float32) * 0.3]
    key = jax.random.key(12)

    def jconv(x, w, s):
        return jax.lax.conv_general_dilated(
            x, w, (s, s), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def jd(params, x):
        return _two_conv_d(params, jada.augment(key, x, jnp.float32(p)), jconv)

    def jr1(params):
        gx = jax.grad(lambda x: jnp.sum(jd(params, x)))(jnp.asarray(img))
        return jnp.mean(jnp.sum(jnp.square(gx), axis=(1, 2, 3)))

    jparams = [jnp.asarray(w) for w in ws]
    ref_gx = jax.grad(lambda x: jnp.sum(jd(jparams, x)))(jnp.asarray(img))
    ref_gw = jax.grad(jr1)(jparams)

    def tconv(x, w, s):
        out = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=s,
            padding=1)
        return out.permute(0, 2, 3, 1)

    draws = jax_augment_draws(key, B)
    tparams = [T(w, requires_grad=True) for w in ws]
    x = T(img, requires_grad=True)

    def td(x):
        return _two_conv_d(tparams, ada.augment(x, draws, T(p)), tconv)

    (gx,) = torch.autograd.grad(td(x).sum(), x, create_graph=True)
    assert rel(gx, ref_gx) <= 1e-4
    gx.square().sum(dim=(1, 2, 3)).mean().backward()
    for w, ref in zip(tparams, ref_gw):
        assert torch.isfinite(w.grad).all()
        assert rel(w.grad, ref) <= 1e-4


def test_ada_update_matches_jax_over_600_steps():
    """Fixed logits whose sign mean (0.5, then 0.75) sits on either side of
    the 0.6 target: p falls at the first adjust (step 256) and rises at the
    second (step 512)."""
    rng = np.random.default_rng(8)
    low = np.concatenate([np.full(4, 1.0), np.full(4, -1.0)])   # rt 0
    high = np.concatenate([np.full(7, 1.0), np.full(1, -1.0)])  # rt 0.75
    preds = [((low if i < 256 else high) * rng.uniform(0.5, 2, 8))
             .astype(np.float32)[:, None] for i in range(600)]
    kw = dict(target=0.6, ada_length=20_000)
    js = jada.ADAState.create()._replace(p=jnp.float32(0.5))
    ts = ada.ADAState.create()._replace(p=T(0.5))
    step = jax.jit(lambda s, r: jada.ada_update(s, r, **kw))
    ps = []
    for r in preds:
        js = step(js, jnp.asarray(r))
        ts = ada.ada_update(ts, T(r), **kw)
        ps.append(float(ts.p))
        assert abs(float(ts.p) - float(js.p)) <= 1e-7
        assert int(ts.steps) == int(js.steps)
        assert float(ts.count) == float(js.count)
    assert ps[254] == 0.5 and ps[255] < 0.5 and ps[511] > ps[255]
    assert ts.steps.dtype == torch.int32
