"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The plain versions of the port's kernels (K1 dense conv, K1e its fused
styled epilogue, K2 multi-dilation conv, K3 phase interleave, K4 phase
gather) are held against the JAX Pallas kernels run in interpret mode; the
gradient Functions of K1, K1e and K2 against `jax.vjp` of the
interpret-mode kernels with their custom VJPs; the port's other ops against
their JAX counterparts. Inputs come from numpy with a seed.

Tolerance: max |port - jax| <= 1e-4 * max |jax| (f32; the two frameworks
sum the same products in another order); the K1, K1e and K2 Functions,
forward and gradients, <= 1e-5; K3 and K4 exact. gradcheck and
gradgradcheck run in float64 at their default tolerances.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.ops.fused_act import fused_leaky_relu as j_flr  # noqa: E402
from vspbfr_tpu.ops.pallas_conv import (  # noqa: E402
    _conv_pallas,
    conv2d_dense,
    conv2d_dense_epilogue,
)
from vspbfr_tpu.ops.pallas_d2s import _d2s_pallas, _s2d_pallas  # noqa: E402
from vspbfr_tpu.ops.pallas_dilated import (  # noqa: E402
    _multi_pallas,
    dilated_multi_conv,
)
from vspbfr_tpu_torch import ops  # noqa: E402

# the packages' ops/__init__ re-export functions under these module names
jmc = importlib.import_module("vspbfr_tpu.ops.modulated_conv")
jup = importlib.import_module("vspbfr_tpu.ops.upfirdn2d")
tmc = importlib.import_module("vspbfr_tpu_torch.ops.modulated_conv")
tup = importlib.import_module("vspbfr_tpu_torch.ops.upfirdn2d")

REL = 1e-4


def assert_rel(port, ref, rel=REL):
    port = np.asarray(port.detach().cpu().float() if hasattr(port, "detach")
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(port - ref).max() / scale
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


def _rand(rng, *shape, scale=1.0, offset=0.0):
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


T = torch.tensor


# --- K1 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,k,pads,isc", [
    ((2, 7, 9, 5), 3, ((1, 1), (1, 1)), True),    # odd widths, in_scale
    ((1, 6, 5, 8), 3, ((0, 2), (2, 0)), False),   # asymmetric pads
    ((2, 5, 7, 3), 1, ((0, 0), (0, 0)), True),    # 1x1, Ci = 3
    ((1, 8, 8, 16), 2, ((0, 1), (1, 0)), True),   # 2x2 (assembled up-conv)
])
def test_dense_conv_plain_matches_pallas(rng, shape, k, pads, isc):
    x = _rand(rng, *shape)
    w = _rand(rng, k, k, shape[3], 12, scale=0.2)
    s = _rand(rng, shape[0], shape[3], scale=0.2, offset=1.0) if isc else None
    ref = _conv_pallas(jnp.asarray(x), jnp.asarray(w), pads,
                       None if s is None else jnp.asarray(s), interpret=True)
    got = ops.dense_conv(T(x), T(w), pads, None if s is None else T(s))
    assert_rel(got, ref)


@pytest.mark.parametrize("shape,k,co,pads,isc", [
    ((2, 7, 9, 5), 3, 12, ((1, 1), (1, 1)), True),
    ((1, 6, 5, 8), 3, 7, ((0, 2), (2, 0)), True),     # asymmetric pads
    ((2, 5, 7, 3), 1, 4, ((0, 0), (0, 0)), True),     # 1x1
    ((1, 8, 8, 16), 2, 6, ((0, 1), (1, 0)), False),   # 2x2
])
def test_dense_conv_grads_match_jax_vjp(rng, shape, k, co, pads, isc):
    """dx, dw and d_in_scale of the port's Function (the backward math the
    card runs, on its plain primitive) vs `jax.vjp` of the interpret-mode
    K1 with its custom VJP; <= 1e-5 of max |jax|."""
    x = _rand(rng, *shape)
    w = _rand(rng, k, k, shape[3], co, scale=0.2)
    s = _rand(rng, shape[0], shape[3], scale=0.2, offset=1.0) if isc else None
    out, vjp = jax.vjp(
        lambda x_, w_, s_: conv2d_dense(x_, w_, pads, s_, interpret=True),
        jnp.asarray(x), jnp.asarray(w), None if s is None else jnp.asarray(s))
    g = _rand(rng, *out.shape)
    refs = vjp(jnp.asarray(g))
    leaves = [T(a).requires_grad_() for a in (x, w, s) if a is not None]
    got_out = ops.dense_conv(leaves[0], leaves[1], pads,
                             leaves[2] if isc else None)
    assert_rel(got_out, out)
    got = torch.autograd.grad(got_out, leaves, T(g))
    for a, b in zip(got, [r for r in refs if r is not None]):
        assert_rel(a, b, rel=1e-5)


@pytest.mark.parametrize("check", [torch.autograd.gradcheck,
                                   torch.autograd.gradgradcheck])
def test_dense_conv_function_is_twice_differentiable(rng, check):
    """The backward is built of differentiable calls, so the double
    backward that R1 needs runs through it (float64, finite differences)."""
    x, w, s = (T(a).double().requires_grad_() for a in (
        _rand(rng, 1, 4, 5, 3), _rand(rng, 3, 3, 3, 2, scale=0.3),
        _rand(rng, 1, 3, scale=0.2, offset=1.0)))
    assert check(lambda x_, w_, s_: ops.dense_conv(
        x_, w_, ((1, 2), (0, 1)), in_scale=s_), (x, w, s))


def test_dense_conv_grad_refuses_negative_backward_pads():
    x = torch.zeros(1, 4, 4, 2, requires_grad=True)
    y = ops.dense_conv(x, torch.zeros(3, 3, 2, 2), ((3, 0), (1, 1)))
    with pytest.raises(ValueError, match="negative pads"):
        y.sum().backward()


# --- K2 ---------------------------------------------------------------------

@pytest.mark.parametrize("hw,ci,cos,dils,isc,osc", [
    ((6, 10), 8, (2, 2, 2, 2), (1, 2, 4, 8), True, True),
    ((4, 4), 16, (4, 4, 4, 4), (1, 2, 4, 8), True, True),  # halo > image
    ((8, 8), 8, (4, 8), (4, 8), False, False),             # uneven widths
])
def test_dilated_multi_plain_matches_pallas(rng, hw, ci, cos, dils, isc, osc):
    b = 2
    x = _rand(rng, b, *hw, ci)
    ws = [_rand(rng, 3, 3, ci, co, scale=0.3) for co in cos]
    s = _rand(rng, b, ci, scale=0.2, offset=1.0) if isc else None
    o = _rand(rng, b, sum(cos), scale=0.2, offset=1.0) if osc else None
    ref = _multi_pallas(jnp.asarray(x), tuple(jnp.asarray(w) for w in ws),
                        None if s is None else jnp.asarray(s),
                        None if o is None else jnp.asarray(o), dils, 1,
                        interpret=True)
    got = ops.dilated_multi_conv(T(x), [T(w) for w in ws], dils,
                                 in_scale=None if s is None else T(s),
                                 out_scale=None if o is None else T(o))
    assert_rel(got, ref)


def _leaves(*arrays):
    return [None if a is None else T(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("isc,osc", [(True, True), (False, True),
                                     (True, False)])
def test_dilated_multi_grads_match_jax_vjp(rng, isc, osc):
    """dx, dws, d_in_scale and d_out_scale of the port's K2 Function (the
    backward math the card runs) vs `jax.vjp` of the interpret-mode K2
    with its custom VJP (`_multi_vjp`); <= 1e-5 of max |jax|."""
    b, ci, cos, dils = 2, 6, (2, 3, 2, 2), (1, 2, 4, 8)
    x = _rand(rng, b, 7, 9, ci)
    ws = [_rand(rng, 3, 3, ci, co, scale=0.3) for co in cos]
    s = _rand(rng, b, ci, scale=0.2, offset=1.0) if isc else None
    o = _rand(rng, b, sum(cos), scale=0.2, offset=1.0) if osc else None
    args = [a for a in (x, *ws, s, o) if a is not None]

    def jfn(*a):
        it = iter(a)
        x_, ws_ = next(it), [next(it) for _ in cos]
        return dilated_multi_conv(x_, ws_, dils,
                                  in_scale=next(it) if isc else None,
                                  out_scale=next(it) if osc else None,
                                  interpret=True)

    out, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    g = _rand(rng, *out.shape)
    refs = vjp(jnp.asarray(g))
    xt, *wt = _leaves(x, *ws)
    st, ot = _leaves(s, o)
    got_out = ops.dilated_multi_conv(xt, wt, dils, in_scale=st, out_scale=ot)
    assert_rel(got_out, out, rel=1e-5)
    leaves = [t for t in (xt, *wt, st, ot) if t is not None]
    got = torch.autograd.grad(got_out, leaves, T(g))
    assert len(got) == len(refs)
    for a, r in zip(got, refs):
        assert_rel(a, r, rel=1e-5)


def test_dilated_multi_refuses_groups():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(NotImplementedError):
        ops.dilated_multi_conv(x, [torch.zeros(3, 3, 2, 4)], (2,), groups=4)


def test_every_c_entry_point_has_its_signature():
    """The C entry points in csrc/ and the ctypes signatures the loader
    sets are the same set, each with as many arguments as its C
    declaration."""
    import re

    from vspbfr_tpu_torch.ops import _build

    declared = {}
    for src in _build.CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                             src.read_text(), re.S):
            declared[m.group(1)] = len(m.group(2).split(","))
    assert declared == {k: len(v) for k, v in _build._SIGNATURES.items()}


@pytest.mark.parametrize("module,struct_name,src", [
    ("epilogue", "K6Launch", "epilogue.cu"),
    ("fused_act", "K7Launch", "fused_act.cu"),
])
def test_launch_fields_are_the_kernels_struct(module, struct_name, src):
    """A packed launch's LAUNCH_FIELDS are the C struct its entry point
    reads, in order and in type (long long: int64, double)."""
    import re

    from vspbfr_tpu_torch.ops import _build

    mod = importlib.import_module(f"vspbfr_tpu_torch.ops.{module}")
    text = (_build.CSRC / src).read_text()
    body = re.search(rf"struct {struct_name} \{{(.*?)\}};", text,
                     re.S).group(1)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind, names = re.fullmatch(r"(long long|double)\s+(.*)", decl,
                                   re.S).groups()
        fields += [(n.strip(), {"long long": "q", "double": "d"}[kind])
                   for n in names.split(",")]
    assert tuple(fields) == mod.LAUNCH_FIELDS


@pytest.mark.parametrize("ws,dils,out_c", [
    ([(3, 3, 8, 4), (3, 3, 6, 4)], (1, 2), None),   # a branch's Ci differs
    ([(3, 3, 8, 4), (1, 1, 8, 4)], (1, 2), None),   # a branch is not 3x3
    ([(3, 3, 8, 4), (3, 3, 8, 2)], (1,), None),     # fewer dilations
    ([(3, 3, 8, 2)] * 9, (1,) * 9, None),           # more than 8 branches
    ([(3, 3, 8, 4), (3, 3, 8, 2)], (1, 0), None),   # dilation 0
    ([(3, 3, 8, 4), (3, 3, 8, 2)], (1, 2), 4),      # out_scale width
])
def test_dilated_multi_refuses_mismatched_branches(ws, dils, out_c):
    """The wrapper's checks, which now guard the kernel's per-branch
    weight pointers, refuse branches that do not fit x or each other."""
    x = torch.zeros(1, 4, 4, 8)
    osc = None if out_c is None else torch.ones(1, out_c)
    with pytest.raises(ValueError):
        ops.dilated_multi_conv(x, [torch.zeros(s) for s in ws], dils,
                               out_scale=osc)


# --- K1e --------------------------------------------------------------------

@pytest.mark.parametrize("ci,k,post,stage2", [
    (5, 3, 2, False),    # odd Ci, two post-activation adds (the up-conv)
    (9, 3, 0, True),     # second stage (the SMART fusion tail)
    (7, 1, 0, False),    # 1x1 (LargeConv fusion, D stem)
])
def test_dense_conv_epilogue_matches_jax(rng, ci, k, post, stage2):
    """K1e's Function forward and gradients (every operand) vs
    `conv2d_dense_epilogue(interpret=True)` (the fused Pallas store and its
    custom VJP `_convepi_bwd`); <= 1e-5 of max |jax|."""
    b, h, w_, co = 2, 6, 5, 8
    p = k // 2
    pads = ((p, p), (p, p))
    x = _rand(rng, b, h, w_, ci)
    w = _rand(rng, k, k, ci, co, scale=0.3)
    arrs = dict(in_scale=_rand(rng, b, ci, scale=0.2, offset=1.0),
                out_scale=_rand(rng, b, co, scale=0.2, offset=1.0),
                noise=_rand(rng, b, h, w_, 1, scale=0.3),
                bias=_rand(rng, co, scale=0.3))
    if stage2:
        arrs.update(noise2=_rand(rng, b, h, w_, 1, scale=0.3),
                    bias2=_rand(rng, co, scale=0.3))
    posts = [_rand(rng, b, h, w_, co) for _ in range(post)]
    names = list(arrs)

    def jfn(x_, w_, *a):
        kw = dict(zip(names, a[:len(names)]))
        return conv2d_dense_epilogue(x_, w_, pads, act=True,
                                     post_add=tuple(a[len(names):]),
                                     act2=stage2, interpret=True, **kw)

    vals = [x, w, *arrs.values(), *posts]
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, vals))
    g = _rand(rng, *out.shape)
    refs = jax.tree.leaves(vjp(jnp.asarray(g)))
    leaves = _leaves(*vals)
    kw = dict(zip(names, leaves[2:2 + len(names)]))
    got_out = ops.dense_conv_epilogue(leaves[0], leaves[1], pads, act=True,
                                      post_add=tuple(leaves[2 + len(names):]),
                                      act2=stage2, **kw)
    assert_rel(got_out, out, rel=1e-5)
    got = torch.autograd.grad(got_out, leaves, T(g))
    assert len(got) == len(refs)
    for a, r in zip(got, refs):
        assert_rel(a, r, rel=1e-5)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_conv2d_dense_epilogue_switch_keeps_the_math(rng, monkeypatch,
                                                     fused):
    """`VSPBFR_FUSED_EPI` picks K1e or K1 + the torch epilogue; both give
    the plain version's values."""
    monkeypatch.setenv("VSPBFR_FUSED_EPI", fused)
    assert ops.fused_epi_enabled() == (fused == "1")
    x, w = T(_rand(rng, 2, 5, 6, 3)), T(_rand(rng, 3, 3, 3, 4, scale=0.3))
    kw = dict(out_scale=T(_rand(rng, 2, 4, offset=1.0)),
              noise=T(_rand(rng, 2, 5, 6, 1)), bias=T(_rand(rng, 4)),
              post_add=(T(_rand(rng, 2, 5, 6, 4)),))
    pads = ((1, 1), (1, 1))
    ops.reset_launch_counts()
    got = ops.conv2d_dense_epilogue(x, w, pads, **kw)
    assert_rel(got, ops.dense_conv_epilogue_plain(x, w, pads, **kw).numpy(),
               rel=1e-6)
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


def test_dense_conv_epilogue_refuses_stage2_with_post_add_in_backward():
    x = torch.zeros(1, 4, 4, 2, requires_grad=True)
    y = ops.dense_conv_epilogue(x, torch.zeros(3, 3, 2, 2), ((1, 1), (1, 1)),
                                post_add=(torch.zeros(1, 4, 4, 2),),
                                act2=True)
    with pytest.raises(ValueError, match="second stage"):
        y.sum().backward()


# --- gradcheck of the Functions ----------------------------------------------

def _f64(rng, *shape, scale=1.0, offset=0.0):
    return T(_rand(rng, *shape, scale=scale, offset=offset)).double(
    ).requires_grad_()


@pytest.mark.parametrize("check", [torch.autograd.gradcheck,
                                   torch.autograd.gradgradcheck])
@pytest.mark.parametrize("fn", ["dilated_multi", "epilogue_post",
                                "epilogue_stage2"])
def test_functions_are_twice_differentiable(rng, check, fn):
    """K2's and K1e's backwards are built of differentiable calls, so the
    double backward R1 needs runs through them (float64, finite
    differences)."""
    x = _f64(rng, 1, 4, 5, 3)
    if fn == "dilated_multi":
        args = (x, _f64(rng, 3, 3, 3, 2, scale=0.3),
                _f64(rng, 3, 3, 3, 1, scale=0.3),
                _f64(rng, 1, 3, scale=0.2, offset=1.0),
                _f64(rng, 1, 3, scale=0.2, offset=1.0))

        def f(x_, w0, w1, s_, o_):
            return ops.dilated_multi_conv(x_, [w0, w1], (1, 2), in_scale=s_,
                                          out_scale=o_)
    else:
        stage2 = fn == "epilogue_stage2"
        args = (x, _f64(rng, 3, 3, 3, 2, scale=0.3),
                _f64(rng, 1, 3, scale=0.2, offset=1.0),
                _f64(rng, 1, 2, scale=0.2, offset=1.0),
                _f64(rng, 1, 4, 5, 1), _f64(rng, 2), _f64(rng, 1, 4, 5, 2))

        def f(x_, w_, s_, o_, n_, b_, e_):
            if stage2:
                return ops.dense_conv_epilogue(
                    x_, w_, ((1, 1), (1, 1)), s_, o_, n_, b_,
                    noise2=e_[..., :1], bias2=b_ * 0.5, act2=True)
            return ops.dense_conv_epilogue(x_, w_, ((1, 1), (1, 1)), s_, o_,
                                           n_, b_, post_add=(e_,))
    assert check(f, args)


# --- K3 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,inner", [((2, 3, 5, 64), 16),
                                         ((1, 4, 4, 12), 3)])
def test_d2s_plain_matches_pallas(rng, shape, inner):
    x = _rand(rng, *shape)
    ref = _d2s_pallas(jnp.asarray(x), inner, interpret=True)
    got = ops.d2s(T(x), inner)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,inner", [((2, 6, 10, 16), 16),
                                         ((1, 4, 8, 3), 3)])
def test_s2d_plain_matches_pallas(rng, shape, inner):
    y = _rand(rng, *shape)
    ref = _s2d_pallas(jnp.asarray(y), inner, interpret=True)
    got = ops.s2d(T(y), inner)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ops.d2s(got, inner).numpy(), y)


def test_d2s_and_s2d_are_each_others_gradient(rng):
    x = T(_rand(rng, 2, 3, 5, 8)).requires_grad_()
    g = T(_rand(rng, 2, 6, 10, 2))
    (dx,) = torch.autograd.grad(ops.d2s(x, 2), x, g)
    assert torch.equal(dx, ops.s2d_plain(g, 2))
    y = T(_rand(rng, 2, 6, 10, 2)).requires_grad_()
    h = T(_rand(rng, 2, 3, 5, 8))
    (dy,) = torch.autograd.grad(ops.s2d(y, 2), y, h)
    assert torch.equal(dy, ops.d2s_plain(h, 2))


# --- plain-torch ops --------------------------------------------------------

@pytest.mark.parametrize("fn,kw", [
    ("upsample2d", {}),
    ("downsample2d", {}),
    ("blur", {"pad": (2, 1)}),
    ("blur", {"pad": (1, 1), "upsample_factor": 2}),
])
def test_resample_matches_jax(rng, fn, kw):
    x = _rand(rng, 2, 8, 6, 5)
    taps = (1, 3, 3, 1)
    ref = getattr(jup, fn)(jnp.asarray(x), taps, **kw)
    got = getattr(tup, fn)(T(x), taps, **kw)
    assert_rel(got, ref)


def test_upfirdn2d_matches_jax(rng):
    x = _rand(rng, 1, 7, 9, 4)
    k = np.asarray(jup.make_resample_kernel((1, 2, 1)))
    np.testing.assert_allclose(tup.make_resample_kernel((1, 2, 1)).numpy(), k,
                               rtol=1e-6)
    for up, down, pad in [(2, 1, (1, 2, 0, 1)), (1, 2, (1, 1)),
                          (1, 1, (-1, 2, 1, -1))]:
        ref = jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down,
                            pad=pad)
        assert_rel(tup.upfirdn2d(T(x), T(k), up=up, down=down, pad=pad), ref)


def test_fused_leaky_relu_and_demod(rng):
    x = _rand(rng, 2, 4, 4, 6)
    b = _rand(rng, 6)
    assert_rel(ops.fused_leaky_relu(T(x), T(b)),
               j_flr(jnp.asarray(x), jnp.asarray(b)))
    w = _rand(rng, 3, 3, 6, 5)
    s = _rand(rng, 2, 6, offset=1.0)
    assert_rel(ops.demod_coeffs(T(w), T(s), 0.1),
               jmc.demod_coeffs(jnp.asarray(w), jnp.asarray(s), 0.1))


@pytest.mark.parametrize("kw,cin,cout,k", [
    (dict(up=True), 6, 5, 3),              # subpixel + d2s (c_out < 128)
    (dict(up=True), 4, 128, 3),            # transposed conv + blur
    (dict(down=True), 6, 7, 3),            # composed blur + stride-2 conv
    (dict(), 6, 7, 3),                     # stride-1 (K1 with in_scale)
    (dict(dilation=2), 6, 4, 3),           # dilated single branch
    (dict(demodulate=False), 6, 3, 1),     # ToRGB per-batch einsum
])
def test_modulated_conv2d_matches_jax(rng, kw, cin, cout, k):
    x = _rand(rng, 2, 8, 8, cin)
    w = _rand(rng, k, k, cin, cout)
    s = _rand(rng, 2, cin, scale=0.3, offset=1.0)
    taps = (1, 3, 3, 1)
    ref = jmc.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                               blur_kernel=taps, **kw)
    got = ops.modulated_conv2d(T(x), T(w), T(s), blur_kernel=taps, **kw)
    assert_rel(got, ref)


def test_modulated_conv2d_multi_matches_jax(rng):
    x = _rand(rng, 2, 8, 8, 8)
    ws = [_rand(rng, 3, 3, 8, 2) for _ in range(4)]
    s = _rand(rng, 2, 8, scale=0.3, offset=1.0)
    ref = jmc.modulated_conv2d_multi(jnp.asarray(x),
                                     [jnp.asarray(w) for w in ws],
                                     (1, 2, 4, 8), jnp.asarray(s))
    got = ops.modulated_conv2d_multi(T(x), [T(w) for w in ws], (1, 2, 4, 8),
                                     T(s))
    assert_rel(got, ref)


def test_compose_blur_and_assembly_match_jax(rng):
    from vspbfr_tpu.ops import packed as jpk

    w = _rand(rng, 3, 3, 4, 5)
    taps = (1, 3, 3, 1)
    d_ref = jmc.compose_blur_kernel(jnp.asarray(w), taps, gain=4.0)
    d_got = tmc.compose_blur_kernel(T(w), taps, gain=4.0)
    assert_rel(d_got, d_ref)
    m_ref, m_got = jpk._map_up(6, 1, False), tmc._map_up(6, 1)
    assert [m_ref(a, 0) for a in (0, 1)] == [m_got(a, 0) for a in (0, 1)]
    wp_ref, py_ref, px_ref = jpk._assemble2(d_ref, m_ref, m_ref, 1, 2)
    wp_got, py_got, px_got = tmc._assemble2(d_got, m_got, m_got, 1, 2)
    assert (py_ref, px_ref) == (py_got, px_got)
    assert_rel(wp_got, wp_ref)


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError):
        ops.d2s(x, 2)
    with pytest.raises(ValueError):
        ops.s2d(x, 8)
