"""The space-to-depth packed layout in the PyTorch port against the JAX
package, on the CPU.

The same numpy inputs go through `vspbfr_tpu/ops/packed.py` and the packed
model paths and through their port counterparts (`vspbfr_tpu_torch/ops/
packed.py`, the `packed*` layers, `packed_min_res` of the models, the
pipeline and the trainers); on the CPU every kernel wrapper runs its plain
version. Sizes 16-64, `channel_div=8`, `packed_min_res` at the top level and
two levels down (as `tests/test_packed_models.py`).

Tolerances (f32): the ops max |port - jax| <= 1e-5 of max |jax| (one conv
each, both sides in f32; the assembled kernels sum the same products in
another order); the layers and models <= 1e-3 of max |jax|, as
`tests/test_torch_models.py` (deeper stacks compound the order); the
pipeline against JAX the serving gate of `tests/test_torch_pipeline.py`
(mean |err| <= 1e-3 and max <= 1e-2 of JAX's range: the 4-step DDPM chain
amplifies rounding); the port at packed_min_res > 0 against itself at 0
<= 1e-3 of max (the two layouts are equal in exact arithmetic); the
gradients of the new kernel forms (K2 grouped, K6 and K1e with nc = 4
noise) 1e-5 against JAX's VJP or torch autograd of the plain composition.
The trainers' steps are in tests/test_torch_packed_train.py.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.models import layers as jl  # noqa: E402
from vspbfr_tpu.ops import modulated_conv as jmc  # noqa: E402
from vspbfr_tpu.ops import packed as jpk  # noqa: E402
from vspbfr_tpu.ops.pallas_conv import _epi_ref  # noqa: E402
from vspbfr_tpu.ops.pallas_d2s import gather_s2d, interleave_d2s  # noqa: E402
from vspbfr_tpu.ops.pallas_dilated import _multi_ref  # noqa: E402
from vspbfr_tpu.ops.pallas_epilogue import epilogue_ref  # noqa: E402
from vspbfr_tpu_torch import ops  # noqa: E402
from vspbfr_tpu_torch.convert import port_key, state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.models import layers as tl  # noqa: E402
from vspbfr_tpu_torch.models.layers import init_module  # noqa: E402
from vspbfr_tpu_torch.ops import modulated_conv as tmc  # noqa: E402
from vspbfr_tpu_torch.ops import packed as tpk  # noqa: E402

OPS_REL = 1e-5
REL = 1e-3
T = torch.tensor


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach().double() if hasattr(port, "detach")
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12))


def assert_rel(port, ref, rel=REL):
    err = rel_err(port, ref)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# ops/packed.py
# ---------------------------------------------------------------------------

def test_layout_converters(rng):
    """space_to_depth / depth_to_space / pack_vector equal JAX's; the
    converters are K4 / K3 (s2d / d2s with inner = C), whose JAX forms
    (gather_s2d / interleave_d2s) equal the layout too."""
    x = rand(rng, 2, 8, 6, 5)
    ref = jpk.space_to_depth(jnp.asarray(x))
    np.testing.assert_array_equal(tpk.space_to_depth(T(x)).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(gather_s2d(jnp.asarray(x), 5)),
                                  ref)
    back = tpk.depth_to_space(T(np.asarray(ref)))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(interleave_d2s(ref, 5)), x)
    v = rand(rng, 3, 7)
    np.testing.assert_array_equal(tpk.pack_vector(T(v)).numpy(),
                                  jpk.pack_vector(jnp.asarray(v)))
    # the converters are the K4 / K3 wrappers (their Functions: each is
    # the other's gradient)
    xg = T(x, requires_grad=True)
    y = tpk.depth_to_space(tpk.space_to_depth(xg))
    assert "D2S" in type(y.grad_fn).__name__
    y.backward(T(x))
    np.testing.assert_array_equal(xg.grad.numpy(), x)


def _scale(rng, b, c):
    return (1.0 + 0.2 * rng.standard_normal((b, c))).astype(np.float32)


CONV_CASES = [  # (k, dilation, perm, in_scale, epi)
    (3, 1, False, False, False), (3, 1, True, True, False),
    (3, 1, False, True, True), (3, 3, False, False, False),
    (1, 1, False, False, False), (3, 2, False, True, False),
    (3, 4, False, False, True), (3, 8, False, True, False),
]


@pytest.mark.parametrize("k,dil,perm,scaled,epi", CONV_CASES)
def test_conv2d_packed(rng, k, dil, perm, scaled, epi):
    b, h, ci, co = 2, 6, 8, 8
    x = rand(rng, b, h, h, 4 * ci)
    w = rand(rng, k, k, ci, co, scale=0.3)
    p = rng.permutation(4 * ci) if perm else None
    isc = _scale(rng, b, 4 * ci) if scaled else None
    e = None
    if epi:
        e = dict(out_scale=_scale(rng, b, 4 * co),
                 noise=rand(rng, b, h, h, 4), bias=rand(rng, 4 * co),
                 act=True)
    jx = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = jpk.conv2d_packed(
        jnp.asarray(x), jnp.asarray(w), dilation=dil, in_ch_perm=p,
        in_scale=jx(isc),
        epi=None if e is None else {k_: jx(v) if k_ != "act" else v
                                    for k_, v in e.items()})
    tx = lambda a: None if a is None else T(a)  # noqa: E731
    got = tpk.conv2d_packed(
        T(x), T(w), dilation=dil,
        in_ch_perm=None if p is None else tuple(int(i) for i in p),
        in_scale=tx(isc),
        epi=None if e is None else {k_: tx(v) if k_ != "act" else v
                                    for k_, v in e.items()})
    assert_rel(got, ref, OPS_REL)


@pytest.mark.parametrize("perm,scaled", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_conv1x1_packed(rng, perm, scaled):
    b, h, ci, co = 2, 5, 6, 3
    x, w = rand(rng, b, h, h, 4 * ci), rand(rng, 1, 1, ci, co)
    p = rng.permutation(4 * ci) if perm else None
    isc = _scale(rng, b, 4 * ci) if scaled else None
    ref = jpk.conv1x1_packed(jnp.asarray(x), jnp.asarray(w), in_ch_perm=p,
                             in_scale=None if isc is None
                             else jnp.asarray(isc))
    got = tpk.conv1x1_packed(
        T(x), T(w), in_ch_perm=None if p is None else tuple(p.tolist()),
        in_scale=None if isc is None else T(isc))
    assert_rel(got, ref, OPS_REL)


@pytest.mark.parametrize("form", ["up", "up_packed", "down",
                                  "down_packed", "upsample",
                                  "upsample_packed"])
def test_resampling_packed(rng, form):
    b, ci, co, taps = 2, 8, 4, (1, 3, 3, 1)
    packed_in = form.endswith("packed") or form == "down"
    h = 4
    x = rand(rng, b, h, h, 4 * ci if packed_in else ci)
    w = rand(rng, 3, 3, ci, co, scale=0.3)
    isc = _scale(rng, b, x.shape[-1])
    if form.startswith("upsample"):
        x = x[..., :12 if packed_in else 3]
        ref = jpk.upsample2d_packed(jnp.asarray(x), taps, packed_in)
        got = tpk.upsample2d_packed(T(x), taps, packed_in)
    elif form.startswith("up"):
        ref = jpk.up_conv_blur_packed(jnp.asarray(x), jnp.asarray(w), taps,
                                      packed_in, jnp.asarray(isc))
        got = tpk.up_conv_blur_packed(T(x), T(w), taps, packed_in, T(isc))
    elif form == "down":
        ref = jpk.blur_down_conv_packed(jnp.asarray(x), jnp.asarray(w), taps,
                                        jnp.asarray(isc))
        got = tpk.blur_down_conv_packed(T(x), T(w), taps, T(isc))
    else:
        ref = jpk.blur_down_conv_packed_packed(jnp.asarray(x),
                                               jnp.asarray(w), taps,
                                               jnp.asarray(isc))
        got = tpk.blur_down_conv_packed_packed(T(x), T(w), taps, T(isc))
    assert_rel(got, ref, OPS_REL)


@pytest.mark.parametrize("pair", ["d12", "d48"])
def test_smart_pair_packed(rng, pair):
    b, h, c, cb = 2, 8, 16, 4
    x, s = rand(rng, b, h, h, 4 * c), _scale(rng, b, c)
    wa, wb = rand(rng, 3, 3, c, cb), rand(rng, 3, 3, c, cb)
    jfn = getattr(jmc, f"modulated_conv2d_{pair}_packed")
    tfn = getattr(tmc, f"modulated_conv2d_{pair}_packed")
    ref = jfn(jnp.asarray(x), jnp.asarray(wa), jnp.asarray(wb),
              jnp.asarray(s))
    assert_rel(tfn(T(x), T(wa), T(wb), T(s)), ref, OPS_REL)


# ---------------------------------------------------------------------------
# the new kernel forms: K2 grouped, K6 and K1e with nc = 4 noise
# ---------------------------------------------------------------------------

def test_dilated_multi_grouped_matches_multi_ref(rng):
    """K2's grouped form (the plain version on the CPU) and its gradient
    (every operand) against `_multi_ref(groups=4)` and JAX's VJP of it."""
    b, h, cg, cos, dils, g = 2, 6, 4, (3, 2), (2, 4), 4
    x, isc = rand(rng, b, h, h, g * cg), _scale(rng, b, g * cg)
    ws = [rand(rng, 3, 3, cg, co, scale=0.3) for co in cos]
    osc = _scale(rng, b, g * sum(cos))
    gy = rand(rng, b, h, h, g * sum(cos))

    def f(x_, ws_, isc_, osc_):
        return _multi_ref(x_, ws_, isc_, osc_, dils, g)

    args = (jnp.asarray(x), [jnp.asarray(w) for w in ws], jnp.asarray(isc),
            jnp.asarray(osc))
    ref, vjp = jax.vjp(f, *args)
    rdx, rdws, rdis, rdos = vjp(jnp.asarray(gy))
    leaves = [T(x, requires_grad=True), *[T(w, requires_grad=True)
                                          for w in ws],
              T(isc, requires_grad=True), T(osc, requires_grad=True)]
    got = ops.dilated_multi_conv(leaves[0], leaves[1:3], dils, groups=g,
                                 in_scale=leaves[3], out_scale=leaves[4])
    assert_rel(got, ref, OPS_REL)
    assert_rel(ops.dilated_multi_conv_plain(*map(T, (x,)), list(map(T, ws)),
                                            dils, T(isc), T(osc), groups=g),
               ref, OPS_REL)
    got.backward(T(gy))
    for leaf, r in zip(leaves, [rdx, *rdws, rdis, rdos]):
        assert_rel(leaf.grad, r, OPS_REL)
    pair = ops.dilated_pair_conv(T(x), T(ws[0]), T(ws[1]), *dils, groups=g,
                                 in_scale=T(isc), out_scale=T(osc))
    assert_rel(pair, ref, OPS_REL)


def _nc4_operands(rng, b, h, c):
    return dict(out_scale=T(_scale(rng, b, c)),
                noise=T(rand(rng, b, h, h, 4)), bias=T(rand(rng, c)))


@pytest.mark.parametrize("chain", ["stage1", "tail"])
def test_epilogue_nc4_matches_jax(rng, chain):
    """K6 with nc = 4 noise (the plain version here) against JAX's
    `epilogue_ref` / `_epi_ref`; its gradient against autograd of the plain
    chain, and its double backward (R1's pattern) by gradgradcheck in
    float64."""
    b, h, c = 2, 4, 12
    x = rand(rng, b, h, h, c)
    kw = _nc4_operands(rng, b, h, c)
    if chain == "tail":   # the SMART tail: the second stage's noise packed
        kw.update(noise=None, noise2=T(rand(rng, b, h, h, 4)),
                  bias2=T(rand(rng, c)), act2=True)
    jkw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    ref = (epilogue_ref(jnp.asarray(x), jkw["out_scale"], jkw["noise"],
                        jkw["bias"], True) if chain == "stage1"
           else _epi_ref(jnp.asarray(x), act=True, **jkw))
    assert_rel(ops.conv_epilogue(T(x), **kw), ref, OPS_REL)

    leaves = {k: v.double().requires_grad_() for k, v in kw.items()
              if isinstance(v, torch.Tensor)}
    xd = T(x).double().requires_grad_()
    flags = {k: v for k, v in kw.items() if not isinstance(v, torch.Tensor)}
    got = ops.conv_epilogue(xd, **leaves, **flags)
    want = ops.epilogue_plain_chain(xd, **leaves, **flags)
    gy = torch.randn_like(got)
    g1 = torch.autograd.grad(got, [xd, *leaves.values()], gy)
    g2 = torch.autograd.grad(want, [xd, *leaves.values()], gy)
    for a, r in zip(g1, g2):
        assert_rel(a, r.numpy(), OPS_REL)
    names = list(leaves)

    def fn(x_, *ts):
        return ops.conv_epilogue(x_, **dict(zip(names, ts)), **flags)

    assert torch.autograd.gradgradcheck(fn, (xd, *leaves.values()))


def test_dense_conv_epilogue_nc4(rng, monkeypatch):
    """K1e with nc = 4 noise and a second stage (the plain version here)
    against JAX's conv + `_epi_ref`, and its Function's gradient against
    autograd of the plain composition; the switch routes the packed styled
    conv through it."""
    b, h, ci, co = 2, 5, 8, 8
    x, w = rand(rng, b, h, h, ci), rand(rng, 3, 3, ci, co, scale=0.3)
    isc = _scale(rng, b, ci)
    kw = _nc4_operands(rng, b, h, co)
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    pads = ((1, 1), (1, 1))
    ref = _epi_ref(jmc.conv2d(jnp.asarray(x) * jnp.asarray(isc)[:, None,
                                                                 None],
                              jnp.asarray(w), padding=1), act=True, **jkw)
    leaves = [T(x, requires_grad=True), T(w, requires_grad=True),
              T(isc, requires_grad=True),
              *[v.clone().requires_grad_() for v in kw.values()]]
    got = ops.dense_conv_epilogue(leaves[0], leaves[1], pads, leaves[2],
                                  *leaves[3:], act=True)
    assert_rel(got, ref, OPS_REL)
    want = ops.dense_conv_epilogue_plain(leaves[0], leaves[1], pads,
                                         leaves[2], *leaves[3:], act=True)
    gy = torch.randn_like(got)
    for a, r in zip(torch.autograd.grad(got, leaves, gy),
                    torch.autograd.grad(want, leaves, gy)):
        assert_rel(a, r.numpy(), OPS_REL)
    # the switch on: the packed styled conv's store takes the epilogue
    monkeypatch.setenv("VSPBFR_FUSED_EPI", "1")
    xs = rand(rng, b, h, h, 4 * ci)
    e = dict(noise=rand(rng, b, h, h, 4), bias=rand(rng, 4 * co), act=True)
    sty = _scale(rng, b, 4 * ci)
    ref = jpk.conv2d_packed(jnp.asarray(xs), jnp.asarray(w),
                            in_scale=jnp.asarray(sty),
                            epi={k: jnp.asarray(v) if k != "act" else v
                                 for k, v in e.items()})
    calls = []
    real = ops.dense_conv.__globals__["_DenseConvEpi"].apply

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(ops.dense_conv.__globals__["_DenseConvEpi"],
                        "apply", spy)
    got = tpk.conv2d_packed(T(xs), T(w), in_scale=T(sty),
                            epi={k: T(v) if k != "act" else v
                                 for k, v in e.items()})
    assert calls and rel_err(got, ref) <= OPS_REL


# ---------------------------------------------------------------------------
# packed layers
# ---------------------------------------------------------------------------

def shared(fm, tm, rng, *args, rngs=None, **kw):
    """The flax tree of fm's parameters (shapes by `jax.eval_shape`, no
    init compiled) filled from the port module tm, whose parameters are
    seeded and moved off their init (noise gains and biases nonzero), and
    fm's eager flax output on args with it. Returns (params, output)."""
    init_module(tm, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t in tm.parameters():
            t.add_(torch.randn(t.shape, generator=torch.Generator()
                               .manual_seed(t.numel())) * 0.1)
    keys = rngs or jax.random.key(0)
    shapes = jax.eval_shape(lambda *a: fm.init(keys, *a, **kw),
                            *args)["params"]
    sd = tm.state_dict()
    params = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(sd[port_key(tuple(k.key for k in path))]
                                    .numpy()), shapes)
    tm.eval()
    return params, fm.apply({"params": params}, *args, **kw,
                            **({"rngs": rngs} if rngs else {}))


LAYERS = ["styled_up", "styled_up_packed_in", "styled", "styled_down",
          "styled_down_packed_out", "to_rgb", "to_rgb_packed_skip",
          "conv_perm", "smart", "smart_intermediates", "large"]


@pytest.mark.parametrize("kind", LAYERS)
def test_packed_layer(rng, kind):
    """Each packed layer against the flax layer with the same flags, with
    explicit (unpacked) noise and nonzero noise gains."""
    b, h, c, sd = 2, 4, 8, 16      # h: the packed grid
    s = rand(rng, b, sd)
    jx = jnp.asarray
    if kind.startswith("styled"):
        up, down = "up" in kind, "down" in kind
        pk_in = not (kind == "styled_up")
        pk_out = not (kind == "styled_down")
        x = rand(rng, b, h, h, 4 * c if pk_in else c)
        res = (2 * h if pk_in else h) * (2 if up else 1) // (2 if down
                                                               else 1)
        nz = rand(rng, b, res, res, 1)
        tm = tl.StyledConv(c, c, sd, upsample=up, downsample=down,
                           packed_in=pk_in, packed_out=pk_out)
        _, ref = shared(jl.StyledConv(c, 3, upsample=up, downsample=down,
                                      packed_in=pk_in, packed_out=pk_out),
                        tm, rng, jx(x), jx(s), noise=jx(nz))
        args, kw = (T(x), T(s)), dict(noise=T(nz))
    elif kind.startswith("to_rgb"):
        skip_pk = kind.endswith("skip")
        x = rand(rng, b, h, h, 4 * c)
        skip = rand(rng, b, h // 2, h // 2, 12) if skip_pk else rand(
            rng, b, h, h, 3)
        tm = tl.ToRGB(c, sd, packed=True, skip_packed=skip_pk)
        _, ref = shared(jl.ToRGB(packed=True, skip_packed=skip_pk), tm, rng,
                        jx(x), jx(s), jx(skip))
        args, kw = (T(x), T(s), T(skip)), {}
    elif kind == "conv_perm":
        perm = jl._branch_major_perm(c, 4)
        assert perm == tl._branch_major_perm(c, 4)
        x = rand(rng, b, h, h, 4 * c)
        tm = tl.ConvLayer(c, c, 3, packed=True, packed_in_perm=perm)
        _, ref = shared(jl.ConvLayer(c, 3, packed=True, packed_in_perm=perm),
                        tm, rng, jx(x))
        args, kw = (T(x),), {}
    elif kind.startswith("smart"):
        inter = kind.endswith("intermediates")
        x, nz = rand(rng, b, h, h, 4 * c), rand(rng, b, 2 * h, 2 * h, 1)
        tm = tl.SMARTLayer(c, c, sd, packed=True)
        _, ref = shared(jl.SMARTLayer(c, packed=True), tm, rng, jx(x), jx(s),
                        noise=jx(nz), return_intermediates=inter)
        args, kw = (T(x), T(s)), dict(noise=T(nz),
                                      return_intermediates=inter)
    else:
        x = rand(rng, b, h, h, 12)
        tm = tl.LargeConvLayer(3, c, 1, packed=True)
        _, ref = shared(jl.LargeConvLayer(c, 1, packed=True), tm, rng, jx(x))
        args, kw = (T(x),), {}
    with torch.no_grad():
        got = tm(*args, **kw)
    if kind == "smart_intermediates":
        assert len(got[1]) == len(ref[1]) == 5
        for g_, r_ in zip(got[1], ref[1]):
            assert_rel(g_, r_)
        got, ref = got[0], ref[0]
    assert_rel(got, ref)


# ---------------------------------------------------------------------------
# models: packed_min_res at the top level and two levels down
# ---------------------------------------------------------------------------

SIZE = 32
PMRS = (SIZE, SIZE // 4)


@pytest.mark.parametrize("pmr", PMRS)
def test_generator_packed(rng, pmr):
    """The decoder at pmr > 0 against JAX's at the same pmr (image, the
    packed feature taps, the cut decode), and against the port at 0."""
    from vspbfr_tpu.models import stylegan2 as jsg
    from vspbfr_tpu_torch.models import stylegan2 as tsg

    b = 2
    fm = jsg.Generator(size=SIZE, channel_div=8, packed_min_res=pmr)
    tm = tsg.Generator(size=SIZE, channel_div=8, packed_min_res=pmr)
    lat = rand(rng, b, fm.n_latent, 512)
    noise = [rand(rng, *(s[0], 2 * s[1], 2 * s[2], 1) if s[3] == 4 else s)
             for s in tm.noise_shapes(b)]
    _, (img, feats) = shared(fm, tm, rng, jnp.asarray(lat),
                             noise=list(map(jnp.asarray, noise)),
                             return_features=True)
    flat = tsg.Generator(size=SIZE, channel_div=8)
    flat.load_state_dict(tm.state_dict())
    with torch.no_grad():
        gimg, gfeats = tm(T(lat), noise=list(map(T, noise)),
                          return_features=True)
        _, cut = tm(T(lat), noise=list(map(T, noise)), return_features=True,
                    return_image=False, max_feature_res=16)
        fimg, ffeats = flat(T(lat), noise=list(map(T, noise)),
                            return_features=True)
    assert_rel(gimg, img)
    assert_rel(gimg, fimg.numpy())
    assert len(gfeats) == len(feats) and len(cut) == 3
    for g_, r_, f_ in zip(gfeats, feats, ffeats):
        assert_rel(g_, r_)
        if g_.shape != f_.shape:
            f_ = tpk.space_to_depth(f_)
        assert_rel(g_, f_.numpy())
    # the packed draw: one (B, r/2, r/2, 4) map a packed layer
    assert tm.noise_shapes(b)[-1] == (b, SIZE // 2, SIZE // 2, 4)


def _restorenet_inputs(rng, tm, b):
    from vspbfr_tpu_torch.models import stylegan2 as tsg

    ch = tsg.channel_dict(2, 8)
    feats = []
    for f in range(tm.log_size - 1):
        r = 2 ** (f + 2)
        feats.append(rand(rng, *((b, r // 2, r // 2, 4 * ch[r])
                                 if tm.packed(r) else (b, r, r, ch[r])),
                          scale=0.2))
    return (rand(rng, b, SIZE, SIZE, 3, scale=0.5), feats,
            rand(rng, b, 18, 512), rand(rng, 2, b, 512))


@pytest.mark.parametrize("pmr", PMRS)
def test_restorenet_packed(rng, pmr):
    """RestoreNet at pmr > 0 against JAX's at the same pmr, with JAX's own
    noise draws (recorded as flax drew them: packed (B, r/2, r/2, 4) at
    the packed layers, `noise_shapes`) and nonzero noise gains; then the
    same weights at pmr 0 on the same noise, unpacked, and the port's
    refusal of 0 < pmr <= 4."""
    import flax.linen as nn
    from vspbfr_tpu.models import restorenet as jrn
    from vspbfr_tpu_torch.models import restorenet as trn

    b = 1
    fm = jrn.RestorationNet(size=SIZE, channel_div=8, packed_min_res=pmr)
    tm = trn.RestorationNet(size=SIZE, channel_div=8, packed_min_res=pmr)
    img, feats, pre, z = _restorenet_inputs(rng, tm, b)
    args = (jnp.asarray(img), list(map(jnp.asarray, feats)),
            jnp.asarray(pre), jnp.asarray(z))
    maps = []

    def rec(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if isinstance(context.module, jl.NoiseInjection):
            maps.append(out[1])
        return out

    with nn.intercept_methods(rec):
        _, ref = shared(fm, tm, rng, *args, inject_index=3,
                        rngs={"params": jax.random.key(0),
                              "noise": jax.random.key(2)})
    # eval_shape traced the layers too: the draws of the forward are last
    noise = [T(np.asarray(m)) for m in maps[-len(tm.noise_shapes(b)):]]
    assert [tuple(n.shape) for n in noise] == tm.noise_shapes(b)
    with torch.no_grad():
        got = tm(T(img), list(map(T, feats)), T(pre), T(z), inject_index=3,
                 noise=noise)
    assert_rel(got, ref)
    # the same weights unpacked: the packed noise and features unpacked
    flat = trn.RestorationNet(size=SIZE, channel_div=8)
    flat.load_state_dict(tm.state_dict())
    unpack = [tpk.depth_to_space(n) if n.shape[-1] == 4 else n
              for n in noise]
    ufeats = [tpk.depth_to_space(T(f)) if tm.packed(2 ** (i + 2)) else T(f)
              for i, f in enumerate(feats)]
    with torch.no_grad():
        want = flat.eval()(T(img), ufeats, T(pre), T(z), inject_index=3,
                           noise=unpack)
    assert_rel(got, want.numpy())
    with pytest.raises(ValueError, match="above 4"):
        trn.RestorationNet(size=SIZE, channel_div=8, packed_min_res=4)


# ---------------------------------------------------------------------------
# the pipeline, checkpoints and the CLIs
# ---------------------------------------------------------------------------

def _pipe_cfg():
    from vspbfr_tpu.models.e4e import TINY_STAGES
    return dict(size=SIZE, decoder_size=64, encode_size=64,
                encoder_stages=TINY_STAGES, channel_div=8)


def _port_pipeline(pmr, seed=0):
    """The port pipeline at pmr, seeded, its diffuser's attention q / k
    sharpened x4 (as tests/test_torch_pipeline.py, so the 4-step chain is
    well conditioned)."""
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    pipe = RestorationPipeline(packed_min_res=pmr,
                               **_pipe_cfg()).init_from_seed(seed)
    with torch.no_grad():
        for blk in pipe.diffuser.block:
            blk.attention_layer.q.kernel.mul_(4.0)
            blk.attention_layer.k.kernel.mul_(4.0)
    return pipe.eval()


@functools.lru_cache(maxsize=None)
def _jax_pipeline(pmr):
    """The JAX pipeline at pmr and its parameter tree's shapes."""
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline

    jpipe = JaxPipeline(packed_min_res=pmr, **_pipe_cfg())
    return jpipe, jax.eval_shape(jpipe.init_params, jax.random.key(0))


def _tree_of(module, shapes):
    sd = module.state_dict()
    return jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(sd[port_key(tuple(k.key for k in path))]
                                    .numpy()), shapes)


def test_pipeline_restore_packed():
    """`RestorationPipeline.restore` at pmr 8 (decoder and RestoreNet on
    one threshold, every level from 8 up packed, the sample image pooled
    from the packed RGB) against the JAX pipeline at the same pmr on the
    same weights and draws, and against the port at 0. (The top-level
    threshold runs through the same layers: the model tests hold it.)"""
    pmr = PMRS[1]
    jpipe, shapes = _jax_pipeline(pmr)
    tpipe = _port_pipeline(pmr)
    assert tpipe.psp._pooled_from_packed()
    params = _tree_of(tpipe, shapes)
    low = np.random.default_rng(0).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    key = jax.random.key(1)
    ref, ref_smp = jax.jit(functools.partial(jpipe.restore,
                                             return_sample=True))(
        params, jnp.asarray(low), key)
    k_diff, k_mix, _, _ = jax.random.split(key, 4)
    k_z, k_flip, k_idx = jax.random.split(k_mix, 3)
    n_lat = jpipe.generator.n_latent
    idx = jnp.where(jax.random.bernoulli(k_flip, jpipe.mixing_prob),
                    jax.random.randint(k_idx, (), 1, n_lat), n_lat)
    draws = {"init_noise": np.asarray(jax.random.normal(k_diff, (2, 10,
                                                                 512))),
             "z": np.asarray(jax.random.normal(k_z, (2, 2, 512))),
             "inject_index": int(idx)}
    gen = torch.Generator().manual_seed(0)   # noise gains 0: not drawn on
    got, smp = tpipe.restore(T(low), gen, return_sample=True, draws=draws)
    # against JAX: the serving gate of tests/test_torch_pipeline.py (the
    # random-init 4-step DDPM chain ahead of the decode amplifies rounding)
    for g_, r_ in ((got, ref), (smp, ref_smp)):
        r_ = np.asarray(r_, np.float64)
        err = np.abs(g_.double().numpy() - r_)
        span = r_.max() - r_.min()
        assert err.mean() <= 1e-3 * span and err.max() <= 1e-2 * span
    flat = _port_pipeline(0)
    want, want_smp = flat.restore(T(low), gen, return_sample=True,
                                  draws=draws)
    assert_rel(got, want.numpy())
    assert_rel(smp, want_smp.numpy())
    # features: packed at the packed resolutions, as `_dummy_feats` says
    feats = tpipe.restore(T(low), gen, upto="decode", draws=draws)
    assert [tuple(f.shape) for f in feats] == [
        tuple(f.shape) for f in tpipe._dummy_feats(2)][:len(feats)]


def test_packed_tree_loads_through_state_dict_from_jax():
    """Parameter shapes do not depend on the layout: a JAX pipeline tree
    at packed_min_res 8 loads (strict) through `state_dict_from_jax` into
    the port's pipelines at 8 and at 0 alike."""
    _, shapes = _jax_pipeline(PMRS[1])
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), shapes)
    for pmr in (PMRS[1], 0):
        tpipe = _port_pipeline(pmr)
        tpipe.load_state_dict(state_dict_from_jax(tree, tpipe))
        np.testing.assert_array_equal(
            tpipe.generator.convs[-1].fusion.conv.weight.detach().numpy(),
            tree["generator"]["convs_5"]["fusion"]["conv"]["weight"])


@pytest.mark.parametrize("value,ok", [(0, True), (8, True), (64, True),
                                      (512, False), (4, False), (12, False),
                                      (-8, False)])
def test_cli_packed_min_res_validation(value, ok):
    """The three CLIs take 0 or a power of two above 4 and at most the
    larger of --size and --decoder_size (here 32 and 64)."""
    from vspbfr_tpu_torch.cli import infer, train_diffuser, train_restore
    from vspbfr_tpu_torch.cli.common import check_packed_min_res

    for mod, extra in ((infer, ["--lq_dirs", "x"]),
                       (train_diffuser, ["--path", "x"]),
                       (train_restore, ["--path", "x"])):
        p = mod.build_parser()
        args = p.parse_args(extra + ["--size", "32", "--decoder_size", "64",
                                     "--packed_min_res", str(value)])
        if ok:
            check_packed_min_res(p, args)
            assert args.packed_min_res == value
        else:
            with pytest.raises(SystemExit):
                check_packed_min_res(p, args)
        assert p.parse_args(extra).packed_min_res == 0
