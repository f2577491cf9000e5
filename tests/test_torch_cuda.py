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
gradient, the `VSPBFR_FUSED_EPI` switch, and the wrappers' refusals.

Tolerance: f32 <= 1e-4 of max |plain| (the same products summed in another
order); bf16 <= 2e-2 (plain runs in f32 on the same bf16 inputs, so the
kernel's bf16 output rounding dominates); K3 and K4 exact.
"""

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
    assert ops.launch_counts() == {"dense_conv": 1, "dense_conv_epilogue": 0,
                                   "dilated_multi_conv": 0, "d2s": 2,
                                   "s2d": 1}


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
    with pytest.raises(ValueError, match="noise"):
        ops.dense_conv_epilogue(x, w, pads, noise=torch.zeros(
            1, 4, 4, 4, device=dev))
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
    ref_out = ops.dense_conv_epilogue_plain(*ref_leaves[:2], pads,
                                            ref_leaves[2], **rkw)
    ref = torch.autograd.grad(ref_out, ref_leaves, g.float())
    for a, r in zip(got, ref):
        _assert_close(a, r, dtype)


@pytest.mark.parametrize("fused,kernel", [("0", "dense_conv"),
                                          ("1", "dense_conv_epilogue")])
def test_fused_epi_switch_picks_the_kernel(dev, monkeypatch, fused, kernel):
    monkeypatch.setenv("VSPBFR_FUSED_EPI", fused)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _rand(gen, dev, 2, 8, 8, 16)
    w = _rand(gen, dev, 3, 3, 16, 8) * 0.2
    kw = _epilogue_operands(gen, dev, torch.float32, 2, 8, 8, 8, 1, False)
    ops.reset_launch_counts()
    got = ops.conv2d_dense_epilogue(x, w, ((1, 1), (1, 1)), **kw)
    counts = ops.launch_counts()
    assert counts[kernel] == 1 and sum(counts.values()) == 1
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
