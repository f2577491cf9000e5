"""Parity of the port's K5 (fused SMART core), K6 (styled epilogue) and K7
(bias + leaky ReLU) with the JAX package, on the CPU, and the routing that
keeps every plain version away from the kernels.

On the CPU each Function's forward is its plain version, so these tests pin
the plain versions and the Functions' backward math (what the card runs)
against the JAX package on the same seeded numpy inputs:

- K6 `conv_epilogue` against `conv_epilogue(..., interpret=True)` (the
  Pallas kernel with its custom VJP `_fused_bwd`) for the nc = 1 noise
  cases, forward and every operand's VJP, and the double backward against
  JAX's R1 pattern (tests/test_ops.py); the whole chain, one K6 pass, is
  `tests/test_torch_epilogue_chain.py`;
- K7 `fused_leaky_relu` against `fused_leaky_relu_pallas` (forward, in
  interpret mode at (2, 4, 4, 128), which takes the Pallas branch); its
  gradient against `jax.grad` of the XLA form `fused_leaky_relu`, since
  the Pallas call has no reverse-mode rule;
- K5 `smart_core` against `smart_core(mode="interpret")` and
  `mode="reference"` on the input packed with `space_to_depth` and the
  output unpacked with `depth_to_space`, demod on and off, and one
  gradient against `jax.grad` of the interpret-mode kernel (its custom VJP
  is the reference composition's).

Tolerance: max |port - jax| <= 1e-5 of max |jax| for K6 and K7 (the same
elementwise arithmetic), 1e-4 for K5 (convs summed in another order).
gradcheck / gradgradcheck run in float64 at their default tolerances.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.ops import fused_act as jfa  # noqa: E402
from vspbfr_tpu.ops.packed import depth_to_space, space_to_depth  # noqa: E402
from vspbfr_tpu.ops.pallas_epilogue import (  # noqa: E402
    conv_epilogue as j_conv_epilogue,
)
from vspbfr_tpu.ops.pallas_smart import (  # noqa: E402
    smart_core as j_smart_core,
)
from vspbfr_tpu_torch import ops  # noqa: E402

# the package's ops/__init__ re-exports functions under some module names
td2s, tdc, tdl, tep, tfa, tsm = (
    importlib.import_module(f"vspbfr_tpu_torch.ops.{m}") for m in
    ("d2s", "dense_conv", "dilated_conv", "epilogue", "fused_act", "smart"))


def assert_rel(port, ref, rel):
    port = np.asarray(port.detach().float().numpy() if hasattr(port, "detach")
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


def _rand(rng, *shape, scale=1.0, offset=0.0):
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def T(a, grad=False):
    return torch.tensor(a).requires_grad_(grad)


# --- K6 ---------------------------------------------------------------------

EPI_CASES = [   # (out_scale, noise, bias, act)
    (False, True, True, True),     # tests/test_ops.py:414-416, nc = 1
    (False, False, True, True),
    (False, False, False, True),
    (True, True, True, True),      # a styled conv's whole epilogue
    (True, True, False, False),
]


@pytest.mark.parametrize("osc,nz,bias,act", EPI_CASES)
def test_conv_epilogue_matches_jax(rng, osc, nz, bias, act):
    b, h, w, c = 2, 6, 8, 16
    arrs = {"x": _rand(rng, b, h, w, c)}
    if osc:
        arrs["out_scale"] = _rand(rng, b, c, scale=0.2, offset=1.0)
    if nz:
        arrs["noise"] = _rand(rng, b, h, w, 1, scale=0.5)
    if bias:
        arrs["bias"] = _rand(rng, c, scale=0.3)
    names = list(arrs)

    def jfn(*a):
        kw = dict(zip(names, a))
        return j_conv_epilogue(kw.pop("x"), act=act, interpret=True, **kw)

    out, vjp = jax.vjp(jfn, *map(jnp.asarray, arrs.values()))
    g = _rand(rng, *out.shape)
    refs = vjp(jnp.asarray(g))
    leaves = [T(a, True) for a in arrs.values()]
    kw = dict(zip(names, leaves))
    got = ops.conv_epilogue(kw.pop("x"), act=act, **kw)
    assert_rel(got, out, 1e-5)
    for a, r in zip(torch.autograd.grad(got, leaves, T(g)), refs):
        assert_rel(a, r, 1e-5)


def test_conv_epilogue_double_backward_matches_jax_r1(rng):
    """R1 through D's activations: the gradient of |dL/dx|^2 w.r.t. the
    bias (tests/test_ops.py's `r1`), through K6's backward."""
    x = _rand(rng, 2, 8, 8, 16)
    bias = _rand(rng, 16, scale=0.5)

    def r1(b_, x_):
        gx = jax.grad(lambda v: jnp.sum(j_conv_epilogue(
            v, None, None, b_, True, interpret=True) ** 2))(x_)
        return jnp.sum(gx ** 2)

    ref = jax.grad(r1)(jnp.asarray(bias), jnp.asarray(x))
    xt, bt = T(x, True), T(bias, True)
    (gx,) = torch.autograd.grad((ops.conv_epilogue(xt, bias=bt) ** 2).sum(),
                                xt, create_graph=True)
    (got,) = torch.autograd.grad((gx ** 2).sum(), bt)
    assert_rel(got, ref, 1e-5)


@pytest.mark.parametrize("check", [torch.autograd.gradcheck,
                                   torch.autograd.gradgradcheck])
def test_conv_epilogue_function_is_twice_differentiable(rng, check):
    args = tuple(T(a).double().requires_grad_() for a in (
        _rand(rng, 1, 3, 4, 5), _rand(rng, 1, 5, offset=1.0),
        _rand(rng, 1, 3, 4, 1), _rand(rng, 5)))
    assert check(lambda x, o, n, b: ops.conv_epilogue(x, o, n, b), args)


def test_conv_epilogue_refuses_packed_noise_and_other_devices():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(NotImplementedError, match="packed"):
        ops.conv_epilogue(x, noise=torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError, match="bias"):
        ops.conv_epilogue(x, bias=torch.zeros(4))
    with pytest.raises(ValueError, match="no kernel"):
        ops.conv_epilogue(x.to("meta"))


# --- K7 ---------------------------------------------------------------------

def test_fused_leaky_relu_matches_the_pallas_kernel(rng):
    x, b = _rand(rng, 2, 4, 4, 128), _rand(rng, 128)
    ref = jfa.fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b))
    xt, bt = T(x, True), T(b, True)
    got = ops.fused_leaky_relu(xt, bt)
    assert_rel(got, ref, 1e-5)
    g = _rand(rng, *x.shape)
    _, vjp = jax.vjp(jfa.fused_leaky_relu, jnp.asarray(x), jnp.asarray(b))
    for a, r in zip(torch.autograd.grad(got, (xt, bt), T(g)),
                    vjp(jnp.asarray(g))):
        assert_rel(a, r, 1e-5)


@pytest.mark.parametrize("shape", [(4, 512), (2, 3, 5, 7)])
def test_fused_and_scaled_leaky_relu_match_jax(rng, shape):
    x, b = _rand(rng, *shape), _rand(rng, shape[-1])
    assert_rel(ops.fused_leaky_relu(T(x), T(b)),
               jfa.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)), 1e-5)
    assert_rel(ops.scaled_leaky_relu(T(x)),
               jfa.scaled_leaky_relu(jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("check", [torch.autograd.gradcheck,
                                   torch.autograd.gradgradcheck])
def test_fused_leaky_relu_function_is_twice_differentiable(rng, check):
    x = T(_rand(rng, 3, 6)).double().requires_grad_()
    b = T(_rand(rng, 6)).double().requires_grad_()
    assert check(ops.fused_leaky_relu, (x, b))


def test_fused_leaky_relu_refuses_a_slope_its_backward_cannot_read():
    with pytest.raises(ValueError, match="positive"):
        ops.fused_leaky_relu(torch.zeros(2, 3), negative_slope=0.0)
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_leaky_relu(torch.zeros(2, 3, device="meta"))


# --- K5 ---------------------------------------------------------------------

def _smart_inputs(rng, b=2, hg=8, wg=8, c=8, cb=2, cout=8):
    """(x unpacked (B, 2hg, 2wg, C), style, ws, wf), as
    tests/test_pallas_smart.py draws them."""
    x = _rand(rng, b, 2 * hg, 2 * wg, c)
    style = _rand(rng, b, c, scale=0.2, offset=1.0)
    ws = [_rand(rng, 3, 3, c, cb, scale=0.3) for _ in range(4)]
    wf = _rand(rng, 3, 3, 4 * cb, cout, scale=0.3)
    return x, style, ws, wf


@pytest.mark.parametrize("mode", ["interpret", "reference"])
@pytest.mark.parametrize("demod", [True, False])
def test_smart_core_matches_jax(rng, mode, demod):
    x, style, ws, wf = _smart_inputs(rng)
    ref = depth_to_space(j_smart_core(
        space_to_depth(jnp.asarray(x)), jnp.asarray(style),
        [jnp.asarray(w) for w in ws], jnp.asarray(wf), demodulate=demod,
        mode=mode))
    got = ops.smart_core(T(x), T(style), [T(w) for w in ws], T(wf),
                         demodulate=demod)
    assert_rel(got, ref, 1e-4)
    assert_rel(ops.smart_core_plain(T(x), T(style), [T(w) for w in ws],
                                    T(wf), demodulate=demod), ref, 1e-4)


def test_smart_core_grads_match_jax(rng):
    """Every input's gradient of K5's Function (the K2 + K1 composition's)
    against `jax.grad` of the interpret-mode kernel; the packed input's
    gradient is unpacked with `depth_to_space`."""
    x, style, ws, wf = _smart_inputs(rng, b=1, hg=4, wg=4)
    g = _rand(rng, *x.shape[:3], wf.shape[3])
    gp = space_to_depth(jnp.asarray(g))

    def loss(xp, s, w1, w2, w3, w4, f):
        return jnp.sum(j_smart_core(xp, s, [w1, w2, w3, w4], f,
                                    mode="interpret") * gp)

    args = [space_to_depth(jnp.asarray(x)), jnp.asarray(style),
            *map(jnp.asarray, ws), jnp.asarray(wf)]
    refs = list(jax.grad(loss, argnums=tuple(range(7)))(*args))
    refs[0] = depth_to_space(refs[0])
    leaves = [T(a, True) for a in (x, style, *ws, wf)]
    out = ops.smart_core(leaves[0], leaves[1], leaves[2:6], leaves[6])
    for a, r in zip(torch.autograd.grad(out, leaves, T(g)), refs):
        assert_rel(a, r, 1e-4)


def test_smart_core_refuses_bad_shapes_and_other_devices(rng):
    x, style, ws, wf = (T(a) if not isinstance(a, list) else [T(w) for w in a]
                        for a in _smart_inputs(rng, b=1, hg=2, wg=2))
    with pytest.raises(ValueError):
        ops.smart_core(x, style, ws[:3], wf)
    with pytest.raises(ValueError):
        ops.smart_core(x, style, ws, wf[:, :, :4])
    with pytest.raises(ValueError, match="no kernel"):
        ops.smart_core(x.to("meta"), style.to("meta"),
                       [w.to("meta") for w in ws], wf.to("meta"))


# --- routing ----------------------------------------------------------------

def _refuse(*_, **__):
    raise AssertionError("a plain version reached a kernel's Function")


def test_plain_versions_never_reach_a_kernel(rng, monkeypatch):
    """Every kernel Function (and K6's and K7's forward primitives, which
    the no-gradient route calls directly) refuses to run; the plain
    versions still give their values (the card compares each kernel with
    them, so they must not be kernels themselves)."""
    for fn in (tdc._DenseConv, tdc._DenseConvEpi, tdl._DilatedMulti,
               tep._ConvEpilogue, tfa._FusedLeakyRelu, tsm._SmartCore,
               *(getattr(td2s, n) for n in dir(td2s)
                 if isinstance(getattr(td2s, n), type)
                 and issubclass(getattr(td2s, n), torch.autograd.Function))):
        monkeypatch.setattr(fn, "apply", _refuse)
    # K6 and K7 also launch without their Function where no gradient is
    # needed: refuse that route too
    monkeypatch.setattr(tep, "_epilogue_forward", _refuse)
    monkeypatch.setattr(tfa, "_flr_forward", _refuse)
    x, style, ws, wf = _smart_inputs(rng, b=1, hg=3, wg=3)
    x, style, wf = T(x), T(style), T(wf)
    ws = [T(w) for w in ws]
    c = x.shape[-1]
    kw = dict(out_scale=style, noise=x[..., :1], bias=style[0], act=True,
              post_add=(x,))
    w = T(_rand(rng, 3, 3, c, c, scale=0.3))
    ops.dense_conv_plain(x, w, ((1, 1), (1, 1)), style)
    ops.dense_conv_epilogue_plain(x, w, ((1, 1), (1, 1)), **kw)
    ops.dense_conv_epilogue_plain(x, w, ((1, 1), (1, 1)), noise2=x[..., :1],
                                  bias2=style[0], act2=True)
    ops.epilogue_plain_chain(x, **kw)
    ops.epilogue_plain(x, style, x[..., :1], style[0])
    ops.fused_leaky_relu_plain(x, style[0])
    ops.dilated_multi_conv_plain(x, ws, (1, 2, 4, 8), style, None)
    ops.smart_core_plain(x, style, ws, wf)
    ops.d2s_plain(x, 2)
    ops.s2d_plain(x[:, :, :, :2], 2)
    with pytest.raises(AssertionError, match="reached a kernel"):
        ops.apply_epilogue(x, bias=style[0])


@pytest.mark.parametrize("stage2,post,launches", [(False, 0, 1),
                                                  (False, 2, 1),
                                                  (True, 0, 1)])
def test_apply_epilogue_routes_each_stage_through_k6(rng, monkeypatch, stage2,
                                                     post, launches):
    """With the epilogue switch off a styled conv is K1, then one K6 pass
    for the whole chain (`_epi_ref`: both stages and the post-activation
    adds between them); the values are the plain chain's."""
    monkeypatch.setenv("VSPBFR_FUSED_EPI", "0")
    calls = []
    real = tep._epilogue_forward
    monkeypatch.setattr(tep, "_epilogue_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    b, h, w_, c = 2, 5, 6, 4
    x, w = T(_rand(rng, b, h, w_, 3)), T(_rand(rng, 3, 3, 3, c, scale=0.3))
    kw = dict(out_scale=T(_rand(rng, b, c, offset=1.0)),
              noise=T(_rand(rng, b, h, w_, 1)), bias=T(_rand(rng, c)),
              post_add=tuple(T(_rand(rng, b, h, w_, c)) for _ in range(post)))
    if stage2:
        kw.update(noise2=T(_rand(rng, b, h, w_, 1)), bias2=T(_rand(rng, c)),
                  act2=True)
    got = ops.conv2d_dense_epilogue(x, w, ((1, 1), (1, 1)), **kw)
    assert len(calls) == launches
    assert_rel(got, ops.dense_conv_epilogue_plain(x, w, ((1, 1), (1, 1)),
                                                  **kw), 1e-6)


def test_layers_route_their_activations_through_k7(rng, monkeypatch):
    """EqualLinear's activation, FusedLeakyReLU and the code diffuser's
    scaled_leaky_relu all go through K7's forward (through its Function
    where a gradient is needed, directly where none is)."""
    from vspbfr_tpu_torch.models.layers import EqualLinear, FusedLeakyReLU

    calls = []
    real = tfa._flr_forward
    monkeypatch.setattr(tfa, "_flr_forward",
                        lambda *a: calls.append(a[1] is not None) or real(*a))
    lin, act = EqualLinear(8, 6, activation=True), FusedLeakyReLU(6)
    with torch.no_grad():
        lin.init_from(torch.Generator().manual_seed(0))
        act.init_from(None)
    lin(T(_rand(rng, 2, 8)))
    act(T(_rand(rng, 2, 3, 3, 6)))
    ops.scaled_leaky_relu(T(_rand(rng, 2, 6)))
    assert calls == [True, True, False]
