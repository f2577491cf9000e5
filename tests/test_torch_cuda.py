"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. On a
machine with one (which need not have JAX, so the JAX conftest is left
out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

`chip_smoke.py` checks the main paths' full-width shapes; these cases
cover the edges the kernels must also get right: odd widths, channel counts
that are not multiples of the kernels' tiles, asymmetric pads, a halo
larger than the image, uneven branch widths, sub-16-byte interleave and
gather units, K1's gradients (odd channel counts, asymmetric pads, 1x1 and
2x2 kernels) against plain torch autograd, K1e (the fused styled epilogue:
odd Ci, post-activation adds, the second stage, 1x1) and its gradient, K2's
gradient, the `VSPBFR_FUSED_EPI` switch, and the wrappers' refusals; K6
(the styled epilogue pass) and K7 (bias + leaky ReLU) at odd C, C = 3,
pixel counts that are no multiple of a block, each piece absent, a
misaligned view, with their gradients and K6's double backward; K6's
whole chain (post-adds, the second stage) in one launch at C = 3 and other
odd widths, n no multiple of the vector width, misaligned x or post-adds,
f32 operands under bf16 x, its sign mask; K5 (the
fused SMART core) at 4 and 8 px, odd sizes, narrow and uneven-tile widths,
demod off, ragged tiles of each of its plan's kinds, an image smaller than
the dilation-8 reach, C512, Co slices that are no multiple of 64, every
cluster size, with its gradient (a K2 + K1 recomputation); K8 (the
interleave's stack and repeat forms) at odd widths, h not divisible by
a block's rows, offset views that shrink its unit, a staged column of
16-32 KB; K9 (the stripe conv) at odd W, H not divisible by its tile, Ci
and Co that are no multiple of 16 (Ci 5 and 6, and an offset view, fill
the ring with plain loads instead of TMA), 1x1 and 2x2 kernels with
asymmetric pads, enough input channels to wrap both rings, a ragged
256-channel tile, more tiles than multiprocessors; K10's four stripe loads
at H not divisible by h_t (`nomemset` on columns 1 .. W-2). K1, K1e and K2 share
one tile body (`csrc/conv_tile.cuh`) with several tiles; the tile-edge
cases put H, W and Co off each tile's multiples, take Ci 3, 8 and 513,
misaligned views (the plain-load fill), 1x1 and 2x2 taps, pads (0, 1) and
(1, 0), 4 and 8 px images with dilation 8, unequal branch widths, and
K1e with every epilogue piece and its sign mask.

Tolerance: f32 <= 1e-4 of max |plain| (the same products summed in another
order); bf16 <= 2e-2 (plain runs in f32 on the same bf16 inputs, so the
kernel's bf16 output rounding dominates); K3 and K4 exact.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

from vspbfr_tpu_torch import ops  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, dev, *shape, scale=1.0, offset=0.0):
    return torch.randn(shape, generator=gen, device=dev) * scale + offset


def _offset_view(t, elems):
    """A contiguous copy of t whose data starts `elems` elements past a
    16-byte boundary (so the interleave's unit shrinks, and the convs fill
    their stage with plain loads)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    v = buf[elems:].view(t.shape)
    v.copy_(t)
    return v


def _scaled_input(x, s, dtype):
    """x * in_scale in f32, rounded to `dtype` (its gradient unchanged): the
    kernels, like the TPU kernel and the plain version at the working
    dtype, round the scaled input to x's dtype before the products. A
    gradient reference across an activation must round there too: where
    the rounding moves a pre-activation across 0, the slope changes by 5x
    in that element."""
    xs = x * s[:, None, None, :]
    return xs + (xs.to(dtype).to(xs.dtype) - xs).detach()


def _assert_close(got, ref, dtype):
    assert got.dtype == dtype and got.shape == ref.shape
    err = float((got.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw,co,pads,isc", [
    ((2, 7, 9, 5), (3, 3), 12, ((1, 1), (1, 1)), True),
    ((1, 6, 5, 8), (3, 3), 70, ((0, 2), (2, 0)), False),
    ((2, 5, 7, 3), (1, 1), 16, ((0, 0), (0, 0)), True),
    ((1, 8, 8, 40), (2, 2), 9, ((0, 1), (1, 0)), True),
    ((3, 17, 33, 24), (3, 3), 130, ((1, 1), (1, 1)), True),
])
def test_dense_conv_matches_plain(dev, dtype, shape, kw, co, pads, isc):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, *kw, shape[3], co) * 0.2).to(dtype)
    s = (_rand(gen, dev, shape[0], shape[3], scale=0.2, offset=1.0).to(dtype)
         if isc else None)
    got = ops.dense_conv(x, w, pads, in_scale=s)
    ref = ops.dense_conv_plain(x.float(), w.float(), pads,
                               None if s is None else s.float())
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,ci,cos,dils,scales", [
    ((6, 10), 8, (2, 2, 2, 2), (1, 2, 4, 8), True),
    ((4, 4), 16, (4, 4, 4, 4), (1, 2, 4, 8), True),   # halo > image
    ((8, 8), 20, (3, 5), (4, 8), False),              # uneven, Ci % 8 != 0
    ((13, 9), 12, (16, 16, 16, 16, 16), (1, 2, 3, 5, 9), True),
])
def test_dilated_multi_conv_matches_plain(dev, dtype, hw, ci, cos, dils,
                                          scales):
    gen = torch.Generator(device=dev).manual_seed(1)
    b = 2
    x = _rand(gen, dev, b, *hw, ci).to(dtype)
    ws = [(_rand(gen, dev, 3, 3, ci, c) * 0.3).to(dtype) for c in cos]
    s = o = None
    if scales:
        s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
        o = _rand(gen, dev, b, sum(cos), scale=0.2, offset=1.0).to(dtype)
    got = ops.dilated_multi_conv(x, ws, dils, in_scale=s, out_scale=o)
    ref = ops.dilated_multi_conv_plain(
        x.float(), [w.float() for w in ws], dils,
        None if s is None else s.float(), None if o is None else o.float())
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,inner", [((2, 3, 5, 12), 3),
                                         ((1, 4, 6, 20), 5),
                                         ((2, 8, 8, 64), 16),
                                         ((1, 5, 7, 256), 64)])
def test_d2s_matches_plain_exactly(dev, dtype, shape, inner):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = _rand(gen, dev, *shape).to(dtype)
    assert torch.equal(ops.d2s(x, inner), ops.d2s_plain(x, inner))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,inner", [((2, 6, 10, 1), 1),   # 2-4 bytes
                                         ((1, 4, 6, 3), 3),
                                         ((2, 6, 14, 4), 4),   # 8-16 bytes
                                         ((1, 10, 6, 5), 5),
                                         ((2, 16, 16, 16), 16),
                                         ((1, 10, 14, 64), 64)])
def test_s2d_matches_plain_exactly(dev, dtype, shape, inner):
    gen = torch.Generator(device=dev).manual_seed(3)
    y = _rand(gen, dev, *shape).to(dtype)
    got = ops.s2d(y, inner)
    assert torch.equal(got, ops.s2d_plain(y, inner))
    assert torch.equal(ops.d2s(got, inner), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw,co,pads,isc", [
    ((2, 7, 9, 5), (3, 3), 12, ((1, 1), (1, 1)), True),     # odd widths
    ((1, 6, 5, 7), (3, 3), 70, ((0, 2), (2, 0)), True),     # asymmetric
    ((2, 5, 7, 3), (1, 1), 17, ((0, 0), (0, 0)), True),     # 1x1
    ((1, 8, 8, 40), (2, 2), 9, ((0, 1), (1, 0)), False),    # 2x2
    ((2, 12, 10, 33), (3, 3), 65, ((2, 1), (1, 2)), True),  # pads up to k-1
])
def test_dense_conv_grads_match_plain_autograd(dev, dtype, shape, kw, co,
                                               pads, isc):
    """dx (a K1 launch), d_in_scale and dw against autograd of the plain
    version in f32 on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, *kw, shape[3], co) * 0.2).to(dtype)
    s = (_rand(gen, dev, shape[0], shape[3], scale=0.2, offset=1.0).to(dtype)
         if isc else None)
    leaves = [t for t in (x, w, s) if t is not None]
    for t in leaves:
        t.requires_grad_(True)
    out = ops.dense_conv(x, w, pads, in_scale=s)
    g = _rand(gen, dev, *out.shape).to(dtype)
    ops.reset_launch_counts()
    got = torch.autograd.grad(out, leaves, g)
    assert ops.launch_counts()["dense_conv"] == 1
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    rx, rw = ref_leaves[:2]
    rs = ref_leaves[2] if isc else None
    ref_out = ops.dense_conv_plain(rx, rw, pads, rs)
    ref = torch.autograd.grad(ref_out, ref_leaves, g.float())
    for a, b in zip(got, ref):
        _assert_close(a, b, dtype)


def test_launch_counters_count_launches(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    ops.reset_launch_counts()
    ops.dense_conv(x, torch.zeros(3, 3, 8, 8, device=dev), ((1, 1), (1, 1)))
    ops.d2s(x, 2)
    ops.d2s(x, 2)
    ops.s2d(x, 8)
    ops.conv_epilogue(x, bias=torch.zeros(8, device=dev))
    ops.fused_leaky_relu(x)
    ops.fused_leaky_relu(x)
    assert ops.launch_counts() == {"dense_conv": 1, "dense_conv_epilogue": 0,
                                   "dilated_multi_conv": 0, "d2s": 2,
                                   "s2d": 1, "smart_core": 0,
                                   "conv_epilogue": 1, "fused_leaky_relu": 2,
                                   "interleave_stack": 0,
                                   "interleave_repeat": 0, "stripe_conv": 0,
                                   "inkpad_conv": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    w = torch.zeros(3, 3, 8, 4, device=dev)
    pads = ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="negative pads"):
        ops.dense_conv(x.clone().requires_grad_(), w,
                       ((3, 0), (1, 1))).sum().backward()
    with pytest.raises(ValueError, match="contiguous"):
        ops.dense_conv(x.transpose(1, 2), w, pads)
    with pytest.raises(TypeError):
        ops.dense_conv(x, w.bfloat16(), pads)
    with pytest.raises(TypeError):
        ops.d2s(x.half(), 2)
    with pytest.raises(TypeError):
        ops.s2d(x.half(), 8)
    with pytest.raises(ValueError):
        ops.s2d(torch.zeros(1, 3, 4, 8, device=dev), 8)
    with pytest.raises(ValueError):
        ops.dense_conv(x, torch.zeros(3, 3, 5, 4, device=dev), pads)
    with pytest.raises(ValueError):
        ops.dilated_multi_conv(x, [w], (2,), out_scale=torch.zeros(
            1, 5, device=dev))
    with pytest.raises(ValueError, match="post_add"):
        ops.dense_conv_epilogue(x, w, pads, post_add=(x,))
    with pytest.raises(ValueError, match="noise"):   # nc is 1 or 4
        ops.dense_conv_epilogue(x, w, pads, noise=torch.zeros(
            1, 4, 4, 2, device=dev))
    with pytest.raises(TypeError):
        ops.dense_conv_epilogue(x, w, pads, bias=torch.zeros(
            4, device=dev, dtype=torch.bfloat16))


def _epilogue_operands(gen, dev, dtype, b, oh, ow, co, post, stage2):
    kw = dict(out_scale=_rand(gen, dev, b, co, scale=0.2, offset=1.0),
              noise=_rand(gen, dev, b, oh, ow, 1, scale=0.3),
              bias=_rand(gen, dev, co, scale=0.3),
              post_add=tuple(_rand(gen, dev, b, oh, ow, co)
                             for _ in range(post)))
    if stage2:
        kw.update(noise2=_rand(gen, dev, b, oh, ow, 1, scale=0.3),
                  bias2=_rand(gen, dev, co, scale=0.3), act2=True)
    return {k: (tuple(t.to(dtype) for t in v) if k == "post_add" else
                v.to(dtype) if torch.is_tensor(v) else v)
            for k, v in kw.items()}


def _f32(kw):
    return {k: (tuple(t.float() for t in v) if k == "post_add" else
                v.float() if torch.is_tensor(v) else v)
            for k, v in kw.items()}


K1E_CASES = [
    ((2, 7, 9, 5), 3, 12, 2, False),     # odd Ci, two post-activation adds
    ((2, 6, 6, 65), 3, 64, 0, True),     # Ci 65 (final_conv's +1), stage 2
    ((1, 9, 5, 7), 1, 70, 1, False),     # 1x1, Co not a tile multiple
    ((3, 17, 11, 24), 3, 130, 0, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,co,post,stage2", K1E_CASES)
def test_dense_conv_epilogue_matches_plain(dev, dtype, shape, k, co, post,
                                           stage2):
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h, w_, ci = shape
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, k, k, ci, co) * 0.2).to(dtype)
    s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
    kw = _epilogue_operands(gen, dev, dtype, b, h, w_, co, post, stage2)
    ops.reset_launch_counts()
    got = ops.dense_conv_epilogue(x, w, pads, in_scale=s, **kw)
    assert ops.launch_counts()["dense_conv_epilogue"] == 1
    ref = ops.dense_conv_epilogue_plain(x.float(), w.float(), pads, s.float(),
                                        **_f32(kw))
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,co,post,stage2", K1E_CASES)
def test_dense_conv_epilogue_grads_match_plain_autograd(dev, dtype, shape, k,
                                                        co, post, stage2):
    """Every operand's gradient of the K1e Function (dx a K1 launch) against
    autograd of the plain version in f32 on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(6)
    b, h, w_, ci = shape
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, k, k, ci, co) * 0.2).to(dtype)
    s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
    kw = _epilogue_operands(gen, dev, dtype, b, h, w_, co, post, stage2)
    names = [n for n, v in kw.items() if torch.is_tensor(v)]
    leaves = [x, w, s, *(kw[n] for n in names), *kw["post_add"]]
    for t in leaves:
        t.requires_grad_(True)
    out = ops.dense_conv_epilogue(x, w, pads, in_scale=s, **kw)
    g = _rand(gen, dev, *out.shape).to(dtype)
    ops.reset_launch_counts()
    got = torch.autograd.grad(out, leaves, g)
    assert ops.launch_counts()["dense_conv"] == 1
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    rkw = dict(kw, **dict(zip(names, ref_leaves[3:3 + len(names)])),
               post_add=tuple(ref_leaves[3 + len(names):]))
    ref_out = ops.dense_conv_epilogue_plain(
        _scaled_input(ref_leaves[0], ref_leaves[2], dtype), ref_leaves[1],
        pads, **rkw)
    ref = torch.autograd.grad(ref_out, ref_leaves, g.float())
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype)


@pytest.mark.parametrize("fused,kernels", [
    ("0", {"dense_conv": 1, "conv_epilogue": 1}),
    ("1", {"dense_conv_epilogue": 1})])
def test_fused_epi_switch_picks_the_kernel(dev, monkeypatch, fused, kernels):
    """Off: K1, then K6 (one stage; the post-activation add in torch); on:
    one K1e launch. No plain epilogue runs on the card either way."""
    monkeypatch.setenv("VSPBFR_FUSED_EPI", fused)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _rand(gen, dev, 2, 8, 8, 16)
    w = _rand(gen, dev, 3, 3, 16, 8) * 0.2
    kw = _epilogue_operands(gen, dev, torch.float32, 2, 8, 8, 8, 1, False)
    ops.reset_launch_counts()
    ops.reset_plain_cuda_calls()
    got = ops.conv2d_dense_epilogue(x, w, ((1, 1), (1, 1)), **kw)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == kernels
    assert sum(ops.plain_cuda_calls().values()) == 0
    _assert_close(got, ops.dense_conv_epilogue_plain(
        x, w, ((1, 1), (1, 1)), **kw), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,ci,cos,dils", [
    ((6, 10), 8, (2, 2, 2, 2), (1, 2, 4, 8)),
    ((4, 4), 16, (4, 4, 4, 4), (1, 2, 4, 8)),     # halo > image
    ((8, 8), 20, (3, 5), (4, 8)),
])
def test_dilated_multi_grads_match_plain_autograd(dev, dtype, hw, ci, cos,
                                                  dils):
    """dx, every dws, d_in_scale and d_out_scale of the K2 Function (K2 in
    the forward) against autograd of the plain version in f32."""
    gen = torch.Generator(device=dev).manual_seed(8)
    b = 2
    x = _rand(gen, dev, b, *hw, ci).to(dtype)
    ws = [(_rand(gen, dev, 3, 3, ci, c) * 0.3).to(dtype) for c in cos]
    s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
    o = _rand(gen, dev, b, sum(cos), scale=0.2, offset=1.0).to(dtype)
    leaves = [x, *ws, s, o]
    for t in leaves:
        t.requires_grad_(True)
    ops.reset_launch_counts()
    out = ops.dilated_multi_conv(x, ws, dils, in_scale=s, out_scale=o)
    assert ops.launch_counts()["dilated_multi_conv"] == 1
    g = _rand(gen, dev, *out.shape).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = ops.dilated_multi_conv_plain(rl[0], rl[1:-2], dils, rl[-2],
                                           rl[-1])
    ref = torch.autograd.grad(ref_out, rl, g.float())
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype)


# --- K1 / K1e / K2 tile edges -----------------------------------------------
# K1 and K2 run one tile body (csrc/conv_tile.cuh) with four tiles: 64
# channels by 256 px (bf16) / 128 px (f32), 32 channels, 16 channels, and
# 64 px for images of at most 64 px. These cases sit on each tile's edges.

K1_TILE_CASES = [   # (x shape, (KH, KW), Co, pads)
    ((2, 19, 23, 32), (3, 3), 64, ((1, 1), (1, 1))),    # H, W no tile mult.
    ((1, 21, 37, 24), (3, 3), 70, ((1, 1), (1, 1))),    # Co past a 64 tile
    ((2, 35, 18, 16), (3, 3), 40, ((1, 1), (1, 1))),    # Co 40: two tiles
    ((1, 40, 33, 32), (3, 3), 24, ((1, 1), (1, 1))),    # the 32 tile, ragged
    ((2, 17, 30, 8), (3, 3), 12, ((1, 1), (1, 1))),     # the 16 tile, Ci 8
    ((1, 33, 20, 3), (3, 3), 16, ((1, 1), (1, 1))),     # Ci 3: plain loads
    ((2, 12, 11, 5), (1, 1), 3, ((0, 0), (0, 0))),      # 1x1, Co 3
    ((1, 16, 24, 40), (2, 2), 33, ((0, 1), (0, 1))),    # 2x2 (0, 1)
    ((2, 15, 9, 24), (2, 2), 64, ((1, 0), (1, 0))),     # 2x2 (1, 0)
    ((1, 14, 13, 16), (3, 3), 20, ((0, 1), (1, 0))),    # pads (0, 1), (1, 0)
    ((2, 4, 4, 513), (3, 3), 96, ((1, 1), (1, 1))),     # 4 px, Ci 513
    ((1, 8, 8, 36), (3, 3), 130, ((1, 1), (1, 1))),     # 8 px, Co 130
    ((1, 5, 3, 12), (3, 3), 7, ((2, 0), (0, 2))),       # halo > image
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,co,pads", K1_TILE_CASES)
def test_dense_conv_tile_edges(dev, dtype, shape, k, co, pads):
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, *k, shape[3], co) / (k[0] * k[1] * shape[3]) ** 0.5
         ).to(dtype)
    s = _rand(gen, dev, shape[0], shape[3], scale=0.2, offset=1.0).to(dtype)
    ops.reset_launch_counts()
    got = ops.dense_conv(x, w, pads, in_scale=s)
    assert ops.launch_counts()["dense_conv"] == 1
    ref = ops.dense_conv_plain(x.float(), w.float(), pads, s.float())
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_dense_conv_takes_misaligned_views(dev, dtype, offset):
    """x, w and in_scale start off a 16-byte boundary, so the stage is
    filled by plain loads (and the store by scalars where y is also)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    x = _offset_view(_rand(gen, dev, 2, 13, 18, 32).to(dtype), offset)
    w = _offset_view((_rand(gen, dev, 3, 3, 32, 48) * 0.1).to(dtype), offset)
    s = _offset_view(_rand(gen, dev, 2, 32, scale=0.2, offset=1.0).to(dtype),
                     offset)
    pads = ((1, 1), (1, 1))
    got = ops.dense_conv(x, w, pads, in_scale=s)
    ref = ops.dense_conv_plain(x.float(), w.float(), pads, s.float())
    _assert_close(got, ref, dtype)
    kw = _epilogue_operands(gen, dev, dtype, 2, 13, 18, 48, 1, False)
    got = ops.dense_conv_epilogue(x, w, pads, in_scale=s, **kw)
    ref = ops.dense_conv_epilogue_plain(x.float(), w.float(), pads, s.float(),
                                        **_f32(kw))
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,co,post,stage2", [
    ((2, 9, 19, 32), 3, 32, 1, False),    # the 32 tile, one post add
    ((1, 18, 17, 8), 3, 16, 2, False),    # the 16 tile, two post adds
    ((2, 4, 4, 65), 3, 64, 0, True),      # 4 px, stage 2
    ((1, 21, 13, 16), 1, 70, 1, False),   # 1x1, Co past a tile
])
def test_dense_conv_epilogue_every_piece_and_mask(dev, dtype, shape, k, co,
                                                  post, stage2):
    """K1e with every epilogue piece on each tile; the sign byte it stores
    for the backward equals the plain first-stage pre-activation's sign
    wherever that lies outside rounding of 0."""
    from vspbfr_tpu_torch.ops.dense_conv import _dense_conv_epi_forward

    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, w_, ci = shape
    pads = ((k // 2, k // 2), (k // 2, k // 2))
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, k, k, ci, co) / (k * k * ci) ** 0.5).to(dtype)
    s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
    kw = _epilogue_operands(gen, dev, dtype, b, h, w_, co, post, stage2)
    got, mask = _dense_conv_epi_forward(
        x, w, pads, s, kw["out_scale"], kw["noise"], kw["bias"], True,
        kw["post_add"], kw.get("noise2"), kw.get("bias2"),
        kw.get("act2", False), want_mask=True)
    f = _f32(kw)
    ref = ops.dense_conv_epilogue_plain(x.float(), w.float(), pads, s.float(),
                                        **f)
    _assert_close(got, ref, dtype)
    u = ops.epilogue_plain_chain(
        ops.dense_conv_plain(x.float(), w.float(), pads, s.float()),
        f["out_scale"], f["noise"], f["bias"], act=False)
    far = u.abs() > 4 * TOL[dtype] * float(u.abs().max())
    assert mask.dtype == torch.bool and mask.shape == u.shape
    assert torch.equal(mask[far], (u >= 0)[far])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,ci,cos,dils", [
    ((4, 4), 32, (8, 8, 8, 8), (1, 2, 4, 8)),        # 4 px, dilation 8
    ((8, 8), 64, (16, 16, 16, 16), (1, 2, 4, 8)),    # 8 px, dilation 8
    ((19, 21), 24, (5, 16, 33, 70), (1, 2, 4, 8)),   # unequal widths
    ((17, 33), 16, (16, 16, 16, 16), (1, 2, 4, 8)),  # the 16 tile, ragged
    ((12, 40), 32, (32, 24, 32), (8, 1, 3)),         # the 32 tile
    ((9, 14), 3, (4, 6), (2, 5)),                    # Ci 3: plain loads
    ((6, 7), 513, (64, 66), (1, 8)),                 # Ci 513
])
def test_dilated_multi_tile_edges(dev, dtype, hw, ci, cos, dils):
    gen = torch.Generator(device=dev).manual_seed(12)
    b = 2
    x = _rand(gen, dev, b, *hw, ci).to(dtype)
    ws = [(_rand(gen, dev, 3, 3, ci, c) / (9 * ci) ** 0.5).to(dtype)
          for c in cos]
    s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
    o = _rand(gen, dev, b, sum(cos), scale=0.2, offset=1.0).to(dtype)
    ops.reset_launch_counts()
    got = ops.dilated_multi_conv(x, ws, dils, in_scale=s, out_scale=o)
    assert ops.launch_counts()["dilated_multi_conv"] == 1
    ref = ops.dilated_multi_conv_plain(x.float(), [t.float() for t in ws],
                                       dils, s.float(), o.float())
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dilated_multi_takes_misaligned_branch_weights(dev, dtype):
    """Each branch's weights are read where they lie: views off a 16-byte
    boundary (plain loads) and views into one shared buffer."""
    gen = torch.Generator(device=dev).manual_seed(13)
    x = _offset_view(_rand(gen, dev, 2, 11, 13, 16).to(dtype), 1)
    full = (_rand(gen, dev, 4, 3, 3, 16, 8) * 0.1).to(dtype)
    ws = [full[0], full[1], _offset_view(full[2], 1), _offset_view(full[3], 3)]
    dils = (1, 2, 4, 8)
    got = ops.dilated_multi_conv(x, ws, dils)
    ref = ops.dilated_multi_conv_plain(x.float(), [t.float() for t in ws],
                                       dils)
    _assert_close(got, ref, dtype)


# --- K6 ---------------------------------------------------------------------

EPI_PIECES = [   # (shape, out_scale, noise, bias, act)
    ((2, 7, 9, 12), True, True, True, True),     # every piece, f32 vector
    ((2, 5, 7, 3), True, True, True, True),      # C = 3 (ToRGB-like)
    ((1, 6, 5, 13), True, False, True, True),    # odd C
    ((3, 11, 13, 16), False, True, False, True),  # pixels no block multiple
    ((2, 4, 4, 24), True, True, False, False),   # no bias, no act
    ((2, 4, 4, 64), False, False, True, False),  # bias only
    ((1, 3, 3, 8), False, False, False, True),   # act only
]


def _epi_case(gen, dev, dtype, shape, osc, nz, bias):
    b, h, w, c = shape
    x = _rand(gen, dev, *shape).to(dtype)
    kw = {}
    if osc:
        kw["out_scale"] = _rand(gen, dev, b, c, scale=0.2,
                                offset=1.0).to(dtype)
    if nz:
        kw["noise"] = _rand(gen, dev, b, h, w, 1, scale=0.3).to(dtype)
    if bias:
        kw["bias"] = _rand(gen, dev, c, scale=0.3).to(dtype)
    return x, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,osc,nz,bias,act", EPI_PIECES)
def test_conv_epilogue_matches_plain(dev, dtype, shape, osc, nz, bias, act):
    gen = torch.Generator(device=dev).manual_seed(9)
    x, kw = _epi_case(gen, dev, dtype, shape, osc, nz, bias)
    ops.reset_launch_counts()
    got = ops.conv_epilogue(x, act=act, **kw)
    assert ops.launch_counts()["conv_epilogue"] == 1
    ref = ops.epilogue_plain(x.float(), act=act,
                             **{k: v.float() for k, v in kw.items()})
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,osc,nz,bias,act", EPI_PIECES[:5])
def test_conv_epilogue_grads_match_plain_autograd(dev, dtype, shape, osc, nz,
                                                  bias, act):
    gen = torch.Generator(device=dev).manual_seed(10)
    x, kw = _epi_case(gen, dev, dtype, shape, osc, nz, bias)
    leaves = [x, *kw.values()]
    for t in leaves:
        t.requires_grad_(True)
    out = ops.conv_epilogue(x, act=act, **kw)
    g = _rand(gen, dev, *out.shape).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = ops.epilogue_plain(rl[0], act=act, **dict(zip(kw, rl[1:])))
    ref = torch.autograd.grad(ref_out, rl, g.float())
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype)


def test_conv_epilogue_double_backward_matches_plain(dev):
    """R1's pattern through K6 (D's strided ConvLayers): the bias gradient
    of |dL/dx|^2."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _rand(gen, dev, 2, 8, 8, 32)
    bias = _rand(gen, dev, 32, scale=0.5)

    def r1(fn):
        xt, bt = x.clone().requires_grad_(), bias.clone().requires_grad_()
        (gx,) = torch.autograd.grad((fn(xt, bias=bt) ** 2).sum(), xt,
                                    create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), bt)[0]

    _assert_close(r1(ops.conv_epilogue), r1(ops.epilogue_plain),
                  torch.float32)


def test_conv_epilogue_takes_a_misaligned_view(dev):
    gen = torch.Generator(device=dev).manual_seed(12)
    base = _rand(gen, dev, 2 * 4 * 4 * 8 + 1)
    x = base[1:].view(2, 4, 4, 8)       # 4 bytes past a 16-byte boundary
    bias = _rand(gen, dev, 8)
    _assert_close(ops.conv_epilogue(x, bias=bias),
                  ops.epilogue_plain(x, bias=bias), torch.float32)
    _assert_close(ops.fused_leaky_relu(x, bias),
                  ops.fused_leaky_relu_plain(x, bias), torch.float32)


# the whole chain in one K6 pass: (shape, pieces as `cli.profile`'s
# K6_CASES spell them)
CHAIN_CASES = [
    ((2, 5, 7, 3), "snbapp"),     # C = 3, two skips (flat 16-byte vectors)
    ((1, 6, 5, 13), "sba2"),      # odd C, the second stage
    ((3, 11, 13, 16), "nbap"),    # C a vector multiple, one skip
    ((2, 9, 7, 5), "nba2"),       # n = 630: no multiple of 4 or 8 (a tail)
    ((1, 1, 1, 3), "snba2"),      # one pixel: vectors span batches
    ((5, 3, 1, 7), "snbap"),      # 3-pixel images, C = 7
    ((2, 4, 4, 512), "snbapp"),   # wide C: a vector step of whole pixels
]


def _chain_case(gen, dev, dtype, shape, pieces, op_dtype=None):
    from vspbfr_tpu_torch.cli.profile import k6_operands

    def rand(*s, scale=1.0, offset=0.0):
        return _rand(gen, dev, *s, scale=scale, offset=offset)

    return k6_operands(rand, dtype, shape, pieces, op_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pieces", CHAIN_CASES)
def test_conv_epilogue_chain_matches_plain(dev, dtype, shape, pieces):
    """The whole chain (stage 1, the post-adds, stage 2) in one launch."""
    gen = torch.Generator(device=dev).manual_seed(21)
    x, kw = _chain_case(gen, dev, dtype, shape, pieces)
    ops.reset_launch_counts()
    got = ops.apply_epilogue(x, **kw)
    assert ops.launch_counts()["conv_epilogue"] == 1
    _assert_close(got, ops.epilogue_plain_chain(x.float(), **_f32(kw)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pieces", [((2, 5, 7, 3), "snbapp"),
                                          ((2, 4, 4, 16), "sba2")])
def test_conv_epilogue_chain_grads_match_plain_autograd(dev, dtype, shape,
                                                        pieces):
    gen = torch.Generator(device=dev).manual_seed(22)
    x, kw = _chain_case(gen, dev, dtype, shape, pieces)
    flags = {k: kw.pop(k) for k in ("act", "act2") if k in kw}
    post = kw.pop("post_add", ())
    names = list(kw)
    leaves = [x, *kw.values(), *post]
    for t in leaves:
        t.requires_grad_(True)

    def run(fn, x_, *o):
        return fn(x_, **dict(zip(names, o)), post_add=tuple(o[len(names):]),
                  **flags)

    out = run(ops.conv_epilogue, *leaves)
    g = _rand(gen, dev, *out.shape).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref = torch.autograd.grad(run(ops.epilogue_plain_chain, *rl), rl,
                              g.float())
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["x", "post"])
def test_conv_epilogue_chain_takes_misaligned_views(dev, dtype, which):
    """x or a post-add at a storage offset off 16 bytes: the one-element
    path."""
    gen = torch.Generator(device=dev).manual_seed(23)
    x, kw = _chain_case(gen, dev, dtype, (2, 6, 5, 16), "snbapp")
    if which == "x":
        x = _offset_view(x, 1)
    else:
        kw["post_add"] = (kw["post_add"][0], _offset_view(kw["post_add"][1],
                                                          3))
    _assert_close(ops.conv_epilogue(x, **kw),
                  ops.epilogue_plain_chain(x.float(), **_f32(kw)), dtype)


@pytest.mark.parametrize("shape,pieces", [((2, 5, 7, 3), "snba2"),
                                          ((2, 8, 8, 64), "snbap")])
def test_conv_epilogue_reads_f32_operands_under_bf16_x(dev, shape, pieces):
    """f32 operands are rounded to bf16 in the kernel: the same output as
    casting them first, with no cast launched."""
    gen = torch.Generator(device=dev).manual_seed(24)
    x, kw = _chain_case(gen, dev, torch.bfloat16, shape, pieces,
                        torch.float32)
    pre = {k: (v.bfloat16() if torch.is_tensor(v) and k != "post_add"
               else v) for k, v in kw.items()}
    assert torch.equal(ops.conv_epilogue(x, **kw), ops.conv_epilogue(x, **pre))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pieces", [((2, 5, 7, 3), "snbap"),
                                          ((2, 4, 6, 24), "sba2"),
                                          ((2, 9, 7, 5), "nbapp")])
def test_conv_epilogue_mask_is_the_stage1_sign(dev, dtype, shape, pieces):
    """The sign byte K6 stores for the backward equals the plain stage-1
    pre-activation's sign wherever that lies outside rounding of 0."""
    from vspbfr_tpu_torch.ops.epilogue import _epilogue_forward

    gen = torch.Generator(device=dev).manual_seed(25)
    x, kw = _chain_case(gen, dev, dtype, shape, pieces)
    got, mask = _epilogue_forward(
        x, kw.get("out_scale"), kw.get("noise"), kw.get("bias"), True,
        kw.get("post_add", ()), kw.get("noise2"), kw.get("bias2"),
        kw.get("act2", False), want_mask=True)
    f = _f32(kw)
    _assert_close(got, ops.epilogue_plain_chain(x.float(), **f), dtype)
    u = ops.epilogue_plain(x.float(), f.get("out_scale"), f.get("noise"),
                           f.get("bias"), act=False)
    far = u.abs() > 4 * TOL[dtype] * float(u.abs().max())
    assert mask.dtype == torch.bool and mask.shape == u.shape
    assert torch.equal(mask[far], (u >= 0)[far])


# each operand the last elements of a 2 MiB allocation of its own, made
# without the caching allocator: a read past an operand's end leaves the
# allocation (an illegal address where nothing is mapped after it)
_TAIL_SCRIPT = r"""
import torch
from vspbfr_tpu_torch import ops

gen = torch.Generator(device="cuda").manual_seed(27)


def tail(*shape, dtype=torch.float32):
    n = 1
    for s in shape:
        n *= s
    buf = torch.empty(2 ** 21 // dtype.itemsize, dtype=dtype, device="cuda")
    t = buf[buf.numel() - n:].view(shape)
    t.copy_(torch.randn(shape, generator=gen, device="cuda"))
    return t


for b, h, w, c in ((1, 1, 1, 3), (2, 5, 7, 3), (1, 1, 1, 16), (2, 3, 1, 8)):
    for dt in (torch.float32, torch.bfloat16):
        x = tail(b, h, w, c, dtype=dt)
        kw = dict(out_scale=tail(b, c), noise=tail(b, h, w, 1),
                  bias=tail(c), post_add=(tail(b, h, w, c, dtype=dt),),
                  act=True)
        got = ops.conv_epilogue(x, **kw)
        ref = ops.epilogue_plain_chain(
            x.float(), **{k: (tuple(p.float() for p in v) if k == "post_add"
                              else v.to(dt).float() if torch.is_tensor(v)
                              else v) for k, v in kw.items()})
        k7 = ops.fused_leaky_relu(x, kw["bias"])
        torch.cuda.synchronize()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        for a, r in ((got, ref), (k7, ops.fused_leaky_relu_plain(
                x.float(), kw["bias"].to(dt).float()))):
            err = float((a.float() - r).abs().max())
            assert err <= tol * max(float(r.abs().max()), 1e-6), err
print("TAIL OK")
"""


def test_streaming_kernels_read_nothing_past_their_operands(dev):
    """K6 and K7 at a few pixels with C = 3, 8 and 16 (grids far larger
    than the work), every operand ending where its allocation ends."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
               PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _TAIL_SCRIPT], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "TAIL OK" in proc.stdout, (
        proc.stdout[-2000:] + proc.stderr[-4000:])


# --- K7 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 13), (2, 5, 7, 3), (4, 512)])
def test_fused_leaky_relu_reads_an_f32_bias_under_bf16_x(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(26)
    x = _rand(gen, dev, *shape).to(torch.bfloat16)
    b = _rand(gen, dev, shape[-1], scale=0.3)
    got = ops.fused_leaky_relu(x, b)
    assert torch.equal(got, ops.fused_leaky_relu(x, b.bfloat16()))
    _assert_close(got, ops.fused_leaky_relu_plain(x.float(), b),
                  torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bias", [((4, 512), True),
                                        ((2, 7, 9, 16), True),
                                        ((3, 5, 13), True),       # odd C
                                        ((2, 5, 7, 3), False),    # C = 3
                                        ((2, 18, 1000), False)])
def test_fused_leaky_relu_and_grads_match_plain(dev, dtype, shape, bias):
    gen = torch.Generator(device=dev).manual_seed(13)
    x = _rand(gen, dev, *shape).to(dtype).requires_grad_(True)
    b = (_rand(gen, dev, shape[-1], scale=0.3).to(dtype).requires_grad_(True)
         if bias else None)
    leaves = [t for t in (x, b) if t is not None]
    ops.reset_launch_counts()
    out = ops.fused_leaky_relu(x, b)
    assert ops.launch_counts()["fused_leaky_relu"] == 1
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref = ops.fused_leaky_relu_plain(rl[0], rl[1] if bias else None)
    _assert_close(out, ref, dtype)
    g = _rand(gen, dev, *shape).to(dtype)
    for a, r in zip(torch.autograd.grad(out, leaves, g),
                    torch.autograd.grad(ref, rl, g.float())):
        _assert_close(a, r, dtype)


# --- K5 ---------------------------------------------------------------------

SMART_CASES = [   # (B, H, W, C, Cb, Cout, demod)
    (2, 4, 4, 16, 4, 16, True),     # 4 px: dilation 8 all padding
    (2, 8, 8, 32, 8, 32, True),     # 8 px
    (1, 9, 13, 12, 3, 10, True),    # odd sizes, Cb % 4 != 0, Cout < 64
    (2, 16, 16, 8, 2, 8, False),    # demod off
    (1, 12, 10, 64, 16, 70, True),  # Cout above one 64-channel pass
    (1, 6, 6, 256, 64, 256, True),  # the 4-px tile width class (4Cb 256)
    # the plan's kinds, ragged tiles and cluster splits (ops.smart_plan):
    (1, 33, 17, 64, 16, 64, True),    # 16x16 tiles, ragged in both axes
    (1, 33, 17, 64, 16, 64, False),
    (2, 19, 21, 96, 24, 40, True),    # bf16 Cb <= 32, f32 8x8; Co 40 split
    (1, 5, 7, 32, 8, 32, True),       # smaller than the dilation-8 reach
    (1, 12, 12, 512, 128, 512, True),  # C512 b1: bf16 8x8, f32 4x8, cluster 8
    (1, 12, 12, 512, 128, 512, False),
    (1, 20, 20, 128, 32, 136, True),  # Co no multiple of 64 over a cluster
]


def _smart_case(gen, dev, dtype, b, h, w, c, cb, co):
    x = _rand(gen, dev, b, h, w, c).to(dtype)
    style = _rand(gen, dev, b, c, scale=0.2, offset=1.0).to(dtype)
    ws = [_rand(gen, dev, 3, 3, c, cb).to(dtype) for _ in range(4)]
    wf = _rand(gen, dev, 3, 3, 4 * cb, co).to(dtype)
    return x, style, ws, wf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,cb,co,demod", SMART_CASES)
def test_smart_core_matches_plain(dev, dtype, b, h, w, c, cb, co, demod):
    gen = torch.Generator(device=dev).manual_seed(14)
    x, style, ws, wf = _smart_case(gen, dev, dtype, b, h, w, c, cb, co)
    ops.reset_launch_counts()
    got = ops.smart_core(x, style, ws, wf, demodulate=demod)
    assert ops.launch_counts()["smart_core"] == 1
    ref = ops.smart_core_plain(x.float(), style.float(),
                               [t.float() for t in ws], wf.float(),
                               demodulate=demod)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_smart_core_every_cluster_matches_plain(dev, dtype, cluster):
    """Each cluster a plan may take (one block a tile, one branch a block,
    half a branch a block), forced at one shape: the branch tile exchanged
    over distributed shared memory and each block's Co slice."""
    smart = importlib.import_module("vspbfr_tpu_torch.ops.smart")
    gen = torch.Generator(device=dev).manual_seed(16)
    x, style, ws, wf = _smart_case(gen, dev, dtype, 2, 11, 19, 40, 16, 70)
    ops.reset_launch_counts()
    got = smart._smart_forward(x, style, ws, wf, True, 1e-8, cluster)
    assert ops.launch_counts()["smart_core"] == 1
    ref = ops.smart_core_plain(x.float(), style.float(),
                               [t.float() for t in ws], wf.float())
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,cb,co,demod", SMART_CASES[:4])
def test_smart_core_grads_match_plain_autograd(dev, dtype, b, h, w, c, cb,
                                               co, demod):
    """Every input's gradient of K5's Function, whose backward recomputes
    the composition (K2, then K1), against plain autograd in f32."""
    gen = torch.Generator(device=dev).manual_seed(15)
    x, style, ws, wf = _smart_case(gen, dev, dtype, b, h, w, c, cb, co)
    leaves = [x, style, *ws, wf]
    for t in leaves:
        t.requires_grad_(True)
    out = ops.smart_core(x, style, ws, wf, demodulate=demod)
    g = _rand(gen, dev, *out.shape).to(dtype)
    ops.reset_launch_counts()
    got = torch.autograd.grad(out, leaves, g)
    counts = ops.launch_counts()
    assert counts["dilated_multi_conv"] == 1 and counts["dense_conv"] >= 1
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = ops.smart_core_plain(rl[0], rl[1], rl[2:6], rl[6],
                                   demodulate=demod)
    for a, r in zip(got, torch.autograd.grad(ref_out, rl, g.float())):
        _assert_close(a, r, dtype)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(TypeError):
        ops.conv_epilogue(x.half())
    with pytest.raises(ValueError, match="bias"):
        ops.fused_leaky_relu(x, torch.zeros(4, device=dev))
    with pytest.raises(TypeError):
        ops.smart_core(x.half(), torch.ones(1, 8, device=dev).half(),
                       [torch.zeros(3, 3, 8, 2, device=dev).half()] * 4,
                       torch.zeros(3, 3, 8, 8, device=dev).half())


# --- K8 (interleave forms), K9 (stripe conv), K10 (its stripe loads) -------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,inner,offset", [
    ((2, 3, 5, 12), 3, 0),         # odd w, h below a block's rows, 2-4 B
    ((1, 5, 7, 256), 64, 0),       # 16-byte units, ragged last row group
    ((2, 8, 8, 64), 16, 1),        # an offset view: 2-4 byte units
    ((1, 6, 6, 32), 8, 2),         # an offset view: 4-8 byte units, ragged
    ((1, 2, 9, 8192), 2048, 0),    # a column of 16-32 KB: 1-2 a stage
])
def test_interleave_forms_match_plain_exactly(dev, dtype, shape, inner,
                                              offset):
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _rand(gen, dev, *shape).to(dtype)
    if offset:
        x = _offset_view(x, offset)
    ref = ops.d2s_plain(x, inner)
    assert torch.equal(ops.interleave_stack(x, inner), ref)
    assert torch.equal(ops.interleave_repeat(x, inner), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,co,pads", [
    ((2, 7, 9, 5), (3, 3), 12, ((1, 1), (1, 1))),     # odd W, Ci 5: plain
    ((1, 13, 21, 24), (3, 3), 70, ((1, 1), (1, 1))),  # Ci, Co not 16k
    ((2, 10, 11, 40), (2, 2), 9, ((0, 1), (0, 1))),   # 2x2, asymmetric pads
    ((1, 6, 5, 8), (3, 3), 20, ((0, 2), (2, 0))),
    ((2, 5, 7, 16), (1, 1), 3, ((0, 0), (0, 0))),
    ((1, 19, 33, 136), (3, 3), 130, ((1, 1), (1, 1))),
    # five chunks (both rings wrap), Co 300 on a ragged 256-channel tile
    ((1, 21, 19, 264), (3, 3), 300, ((1, 1), (1, 1))),
    ((1, 18, 20, 192), (2, 2), 96, ((0, 1), (0, 1))),   # 2x2, three chunks
    ((4, 96, 96, 128), (3, 3), 128, ((1, 1), (1, 1))),  # more tiles than SMs
])
def test_stripe_conv_matches_plain(dev, dtype, shape, k, co, pads):
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, *k, shape[3], co) * 0.2).to(dtype)
    got = ops.stripe_conv(x, w, pads)
    _assert_close(got, ops.stripe_conv_plain(x.float(), w.float(), pads),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["legacy", "inkpad", "nomemset",
                                     "nobranch"])
@pytest.mark.parametrize("shape,co,h_t", [
    ((2, 20, 9, 24), 40, 4),     # H not divisible by h_t, odd W
    ((1, 37, 13, 6), 16, 16),    # Ci 6: plain loads; ragged last tile
    ((1, 16, 16, 64), 64, 1),
    ((2, 34, 40, 136), 264, 8),  # three chunks, ragged 256-channel tile
])
def test_inkpad_conv_matches_plain(dev, dtype, variant, shape, co, h_t):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, 3, 3, shape[3], co) * 0.2).to(dtype)
    got = ops.inkpad_conv(x, w, variant, h_t)
    ref = ops.inkpad_conv_plain(x.float(), w.float(), variant, h_t)
    if variant == "nomemset":
        got, ref = got[:, :, 1:-1], ref[:, :, 1:-1]
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stripe_conv_takes_misaligned_views(dev, dtype):
    """An x that starts off a 16-byte boundary: the plain-load producer
    (bf16: instead of TMA, into the same ring) with Ci that TMA could take
    otherwise."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _offset_view(_rand(gen, dev, 2, 11, 13, 64).to(dtype), 1)
    w = (_rand(gen, dev, 3, 3, 64, 72) * 0.2).to(dtype)
    pads = ((1, 1), (1, 1))
    tsc = importlib.import_module("vspbfr_tpu_torch.ops.stripe_conv")
    assert x.data_ptr() % 16 and tsc.stripe_plan(
        dtype == torch.bfloat16, x.shape, w.shape, pads,
        aligned=False)["producer"] == 0
    _assert_close(ops.stripe_conv(x, w, pads),
                  ops.stripe_conv_plain(x.float(), w.float(), pads), dtype)


def test_experiment_kernels_count_launches_and_refuse(dev):
    x = torch.zeros(1, 8, 8, 16, device=dev)
    w = torch.zeros(3, 3, 16, 8, device=dev)
    ops.reset_launch_counts()
    ops.interleave_stack(x, 4)
    ops.interleave_repeat(x, 4)
    ops.stripe_conv(x, w, ((1, 1), (1, 1)))
    ops.inkpad_conv(x, w, "legacy", 4)
    ops.inkpad_conv(x, w, "inkpad", 4)
    counts = ops.launch_counts()
    assert (counts["interleave_stack"], counts["interleave_repeat"],
            counts["stripe_conv"], counts["inkpad_conv"]) == (1, 1, 1, 2)
    with pytest.raises(TypeError):
        ops.stripe_conv(x.half(), w.half(), ((1, 1), (1, 1)))
    with pytest.raises(TypeError):
        ops.interleave_stack(x.half()[..., :12].contiguous(), 3)
    with pytest.raises(ValueError):
        ops.inkpad_conv(x, w, "nobranch", 8)   # H < h_t + 2
    with pytest.raises(RuntimeError):
        ops.stripe_conv(x, torch.zeros(9, 9, 16, 8, device=dev),
                        ((4, 4), (4, 4)))       # weights exceed the block
    with pytest.raises(RuntimeError):           # bf16: two stripes do
        ops.stripe_conv(x.bfloat16(),
                        torch.zeros(17, 17, 16, 8, device=dev).bfloat16(),
                        ((8, 8), (8, 8)))


# --- the space-to-depth layout's forms: K2 grouped, K6 / K1e nc = 4 --------
# K2 with groups = 4: each group's Cg input channels staged at their offset
# of a wider x, the shared weights, the group's output block; cases put the
# group width off 8 (plain-load fill), the branch width off every tile
# (ragged), the image under the dilations' reach. K6 and K1e with one noise
# value a phase: C / 4 off the vector width (the per-element path), on it
# (one value a vector), a second stage, post-adds.

GROUPED_CASES = [   # (hw, Cg, cos, dils)
    ((6, 10), 5, (3, 5), (1, 2)),          # Cg 5: plain loads, odd widths
    ((4, 4), 8, (4, 4), (2, 4)),           # halo > image
    ((9, 13), 16, (20, 12), (2, 4)),       # a branch past the 16 tile
    ((16, 16), 64, (16, 16), (2, 4)),      # the packed SMART's form
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,cg,cos,dils", GROUPED_CASES)
def test_dilated_multi_grouped_matches_plain(dev, dtype, hw, cg, cos, dils):
    gen = torch.Generator(device=dev).manual_seed(21)
    b, g = 2, 4
    x = _rand(gen, dev, b, *hw, g * cg).to(dtype)
    ws = [(_rand(gen, dev, 3, 3, cg, c) * 0.3).to(dtype) for c in cos]
    s = _rand(gen, dev, b, g * cg, scale=0.2, offset=1.0).to(dtype)
    o = _rand(gen, dev, b, g * sum(cos), scale=0.2, offset=1.0).to(dtype)
    ops.reset_launch_counts()
    got = ops.dilated_multi_conv(x, ws, dils, groups=g, in_scale=s,
                                 out_scale=o)
    assert ops.form_counts()["dilated_multi_conv_grouped"] == 1
    ref = ops.dilated_multi_conv_plain(x.float(), [w.float() for w in ws],
                                       dils, s.float(), o.float(), groups=g)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,cg,cos,dils", GROUPED_CASES[:3])
def test_dilated_multi_grouped_grads_match_plain_autograd(dev, dtype, hw, cg,
                                                          cos, dils):
    """Every operand's gradient of the grouped K2 Function (the shared
    weights' the sum over the groups) against plain autograd in f32."""
    gen = torch.Generator(device=dev).manual_seed(22)
    b, g = 2, 4
    x = _rand(gen, dev, b, *hw, g * cg).to(dtype)
    ws = [(_rand(gen, dev, 3, 3, cg, c) * 0.3).to(dtype) for c in cos]
    s = _rand(gen, dev, b, g * cg, scale=0.2, offset=1.0).to(dtype)
    o = _rand(gen, dev, b, g * sum(cos), scale=0.2, offset=1.0).to(dtype)
    leaves = [x, *ws, s, o]
    for t in leaves:
        t.requires_grad_(True)
    out = ops.dilated_multi_conv(x, ws, dils, groups=g, in_scale=s,
                                 out_scale=o)
    gy = _rand(gen, dev, *out.shape).to(dtype)
    got = torch.autograd.grad(out, leaves, gy)
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref = torch.autograd.grad(ops.dilated_multi_conv_plain(
        rl[0], rl[1:-2], dils, rl[-2], rl[-1], groups=g), rl, gy.float())
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype)


# (shape, pieces): s scale, n noise, b bias, p a post-add, 2 stage 2
NC4_CASES = [
    ((2, 5, 7, 12), "snb"),      # C / 4 = 3: per element
    ((2, 4, 6, 32), "snb"),      # C / 4 = 8: one value a vector
    ((1, 3, 5, 20), "snbp"),     # post-adds
    ((2, 6, 4, 4), "sn"),        # one channel a phase
    ((3, 5, 3, 48), "b2"),       # the SMART tail: noise2 packed
]


def _nc4_case(gen, dev, dtype, shape, pieces):
    b, h, w, c = shape
    kw = {}
    if "s" in pieces:
        kw["out_scale"] = _rand(gen, dev, b, c, scale=0.2, offset=1.0)
    if "n" in pieces:
        kw["noise"] = _rand(gen, dev, b, h, w, 4, scale=0.3)
    if "b" in pieces:
        kw["bias"] = _rand(gen, dev, c, scale=0.3)
    if "p" in pieces:
        kw["post_add"] = (_rand(gen, dev, *shape),)
    if "2" in pieces:
        kw.update(noise2=_rand(gen, dev, b, h, w, 4, scale=0.3),
                  bias2=_rand(gen, dev, c, scale=0.3), act2=True)
    return {k: (tuple(t.to(dtype) for t in v) if k == "post_add" else
                v.to(dtype) if torch.is_tensor(v) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pieces", NC4_CASES)
def test_conv_epilogue_nc4_matches_plain(dev, dtype, shape, pieces):
    gen = torch.Generator(device=dev).manual_seed(23)
    x = _rand(gen, dev, *shape).to(dtype)
    kw = _nc4_case(gen, dev, dtype, shape, pieces)
    ops.reset_launch_counts()
    got = ops.conv_epilogue(x, **kw)
    assert ops.form_counts()["conv_epilogue_nc4"] == 1
    _assert_close(got, ops.epilogue_plain_chain(x.float(), **_f32(kw)),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pieces", [NC4_CASES[0], NC4_CASES[4]])
def test_conv_epilogue_nc4_grads_match_plain_autograd(dev, dtype, shape,
                                                      pieces):
    gen = torch.Generator(device=dev).manual_seed(24)
    x = _rand(gen, dev, *shape).to(dtype)
    kw = _nc4_case(gen, dev, dtype, shape, pieces)
    names = [k for k, v in kw.items() if torch.is_tensor(v)]
    leaves = [x.requires_grad_()] + [kw[k].requires_grad_() for k in names]
    out = ops.conv_epilogue(x, **kw)
    gy = _rand(gen, dev, *out.shape).to(dtype)
    got = torch.autograd.grad(out, leaves, gy)
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = ops.epilogue_plain_chain(
        rl[0], **dict(zip(names, rl[1:])),
        **{k: v for k, v in kw.items() if k not in names})
    for a, r in zip(got, torch.autograd.grad(ref_out, rl, gy.float())):
        _assert_close(a, r, dtype)


def test_conv_epilogue_nc4_double_backward_matches_plain(dev):
    """R1's pattern through K6 with one noise value a phase: the noise's
    gradient of |dL/dx|^2."""
    gen = torch.Generator(device=dev).manual_seed(25)
    x = _rand(gen, dev, 2, 6, 6, 32)
    nz = _rand(gen, dev, 2, 6, 6, 4, scale=0.5)
    osc = _rand(gen, dev, 2, 32, scale=0.2, offset=1.0)

    def r1(fn):
        xt, nt = x.clone().requires_grad_(), nz.clone().requires_grad_()
        (gx,) = torch.autograd.grad((fn(xt, osc, nt) ** 2).sum(), xt,
                                    create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), nt)[0]

    _assert_close(r1(ops.conv_epilogue), r1(ops.epilogue_plain),
                  torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,co,stage2", [((2, 7, 9, 8), 12, False),
                                             ((1, 6, 6, 16), 36, True),
                                             ((2, 9, 5, 20), 64, False)])
def test_dense_conv_epilogue_nc4_matches_plain(dev, dtype, shape, co, stage2):
    """K1e with one noise value a phase, and its gradient."""
    gen = torch.Generator(device=dev).manual_seed(26)
    b, h, w_, ci = shape
    pads = ((1, 1), (1, 1))
    x = _rand(gen, dev, *shape).to(dtype)
    w = (_rand(gen, dev, 3, 3, ci, co) * 0.2).to(dtype)
    s = _rand(gen, dev, b, ci, scale=0.2, offset=1.0).to(dtype)
    kw = _nc4_case(gen, dev, dtype, (b, h, w_, co),
                   "snb2" if stage2 else "snbp")
    ops.reset_launch_counts()
    got = ops.dense_conv_epilogue(x, w, pads, in_scale=s, **kw)
    assert ops.form_counts()["dense_conv_epilogue_nc4"] == 1
    ref = ops.dense_conv_epilogue_plain(x.float(), w.float(), pads,
                                        s.float(), **_f32(kw))
    _assert_close(got, ref, dtype)
    if not stage2:
        return
    names = [k for k, v in kw.items() if torch.is_tensor(v)]
    leaves = [x, w, s] + [kw[k] for k in names]
    for t in leaves:
        t.requires_grad_(True)
    out = ops.dense_conv_epilogue(x, w, pads, in_scale=s, **kw)
    gy = _rand(gen, dev, *out.shape).to(dtype)
    got = torch.autograd.grad(out, leaves, gy)
    rl = [t.detach().float().requires_grad_(True) for t in leaves]
    ref_out = ops.dense_conv_epilogue_plain(
        _scaled_input(rl[0], rl[2], dtype), rl[1], pads,
        **dict(zip(names, rl[3:])), act2=True)
    for a, r in zip(got, torch.autograd.grad(ref_out, rl, gy.float())):
        _assert_close(a, r, dtype)
