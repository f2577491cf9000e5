"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. On a
machine with one (which need not have JAX, so the JAX conftest is left
out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

`chip_smoke.py` checks the serving path's full-width shapes; these cases
cover the edges the kernels must also get right: odd widths, channel counts
that are not multiples of the kernels' tiles, asymmetric pads, a halo
larger than the image, uneven branch widths, sub-16-byte interleave units,
and the wrappers' refusals.

Tolerance: f32 <= 1e-4 of max |plain| (the same products summed in another
order); bf16 <= 2e-2 (plain runs in f32 on the same bf16 inputs, so the
kernel's bf16 output rounding dominates); K3 exact.
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


def test_launch_counters_count_launches(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    ops.reset_launch_counts()
    ops.dense_conv(x, torch.zeros(3, 3, 8, 8, device=dev), ((1, 1), (1, 1)))
    ops.d2s(x, 2)
    ops.d2s(x, 2)
    assert ops.launch_counts() == {"dense_conv": 1, "dilated_multi_conv": 0,
                                   "d2s": 2}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 8, device=dev)
    w = torch.zeros(3, 3, 8, 4, device=dev)
    pads = ((1, 1), (1, 1))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.dense_conv(x, w.clone().requires_grad_(), pads)
    with pytest.raises(ValueError, match="contiguous"):
        ops.dense_conv(x.transpose(1, 2), w, pads)
    with pytest.raises(TypeError):
        ops.dense_conv(x, w.bfloat16(), pads)
    with pytest.raises(TypeError):
        ops.d2s(x.half(), 2)
    with pytest.raises(ValueError):
        ops.dense_conv(x, torch.zeros(3, 3, 5, 4, device=dev), pads)
    with pytest.raises(ValueError):
        ops.dilated_multi_conv(x, [w], (2,), out_scale=torch.zeros(
            1, 5, device=dev))
