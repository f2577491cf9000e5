"""The port's width-only (semi-packed) layout (`vspbfr_tpu_torch/ops/
semipacked.py`) against `vspbfr_tpu/ops/semipacked.py`, on the CPU.

Every case feeds the same numpy draws to both packages (the JAX dilation-1
conv runs its Pallas K1 in interpret mode or its plain reference, as the
JAX package's own tests run it on the CPU). Tolerances, per case:

- the layout converters: exact (they move values);
- the convs, f32: 1e-5 of the output's largest magnitude (two f32
  summation orders);
- the gradient against the unpacked conv's, f32: 1e-4 of its largest
  magnitude (the gradient goes through the assembly and K1's backward);
- bf16: the dtype is kept, and the values agree with the f32 port within
  2e-2 of the largest magnitude (bf16's rounding of x, w and the output).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.ops import semipacked as jsp  # noqa: E402
from vspbfr_tpu.ops.packed import space_to_depth as jax_s2d  # noqa: E402
from vspbfr_tpu_torch.ops import semipacked as tsp  # noqa: E402
from vspbfr_tpu_torch.ops.packed import space_to_depth  # noqa: E402

F32 = 1e-5


def T(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def rel_err(port, ref) -> float:
    port = port.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_layout_converters_match_jax(rng):
    x = draw(rng, 2, 8, 8, 5)
    for name in ("space_to_width", "width_to_space"):
        a = x if name == "space_to_width" else x.reshape(2, 8, 4, 10)
        np.testing.assert_array_equal(getattr(tsp, name)(T(a)).numpy(),
                                      np.asarray(getattr(jsp, name)(a)))
    sp = tsp.space_to_width(T(x))
    # phase-major: out[..., i, j, b*C + c] = x[..., i, 2j + b, c]
    assert float(sp[0, 3, 1, 5 + 2]) == float(x[0, 3, 3, 2])
    np.testing.assert_array_equal(tsp.width_to_space(sp).numpy(), x)
    pk = space_to_depth(T(x))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jax_s2d(x)))
    semi = tsp.packed_to_semipacked(pk)
    np.testing.assert_array_equal(
        semi.numpy(), np.asarray(jsp.packed_to_semipacked(np.asarray(pk))))
    np.testing.assert_array_equal(semi.numpy(), sp.numpy())
    np.testing.assert_array_equal(tsp.semipacked_to_packed(semi).numpy(),
                                  pk.numpy())
    v = draw(rng, 3, 5)
    np.testing.assert_array_equal(tsp.pack_vector_w(T(v)).numpy(),
                                  np.asarray(jsp.pack_vector_w(v)))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv2d_semipacked_dense(rng, k):
    x, w = draw(rng, 2, 10, 12, 4), draw(rng, k, k, 4, 6)
    xs = jsp.space_to_width(jnp.asarray(x))
    if k == 1:
        got = tsp.conv1x1_semipacked(tsp.space_to_width(T(x)), T(w))
        ref = jsp.conv1x1_semipacked(xs, jnp.asarray(w))
    else:
        got = tsp.conv2d_semipacked(tsp.space_to_width(T(x)), T(w))
        ref = jsp.conv2d_semipacked(xs, jnp.asarray(w))
        wp, pads = tsp._assemble_x(T(w))
        jwp, jpads = jsp._assemble_x(jnp.asarray(w))
        assert pads == jpads
        np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
    assert rel_err(got, ref) <= F32


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("groups_hint", [True, False])
def test_conv2d_semipacked_even_dilation(rng, d, groups_hint):
    x, w = draw(rng, 1, 32, 32, 4), draw(rng, 3, 3, 4, 5)
    got = tsp.conv2d_semipacked(tsp.space_to_width(T(x)), T(w), dilation=d,
                                groups_hint=groups_hint)
    ref = jsp.conv2d_semipacked(jsp.space_to_width(jnp.asarray(x)),
                                jnp.asarray(w), dilation=d,
                                groups_hint=groups_hint)
    assert rel_err(got, ref) <= F32


def test_conv2d_semipacked_odd_dilation_raises(rng):
    x, w = draw(rng, 1, 8, 8, 4), draw(rng, 3, 3, 2, 2)
    with pytest.raises(NotImplementedError):
        tsp.conv2d_semipacked(T(x), T(w), dilation=3)


@pytest.mark.parametrize("d", [1, 2])
def test_conv2d_semipacked_in_scale(rng, d):
    """A per-sample input scale folds like multiplying x up front (into
    K1 at d = 1), against JAX's with the same scale."""
    x, w = draw(rng, 2, 8, 8, 4), draw(rng, 3, 3, 4, 4)
    s = rng.uniform(0.5, 1.5, (2, 4)).astype(np.float32)
    sp, xs = tsp.pack_vector_w(T(s)), tsp.space_to_width(T(x))
    got = tsp.conv2d_semipacked(xs, T(w), dilation=d, in_scale=sp)
    want = tsp.conv2d_semipacked(xs * sp[:, None, None, :], T(w),
                                 dilation=d)
    ref = jsp.conv2d_semipacked(jsp.space_to_width(jnp.asarray(x)),
                                jnp.asarray(w), dilation=d,
                                in_scale=jsp.pack_vector_w(jnp.asarray(s)))
    assert rel_err(got, want.numpy()) <= F32
    assert rel_err(got, ref) <= F32


def test_conv2d_semipacked_grad_matches_unpacked(rng):
    """The weight's gradient through the assembly and K1's Function against
    the unpacked conv's, and against JAX's gradient of its semi-packed
    conv."""
    x, w0 = draw(rng, 1, 8, 8, 3), draw(rng, 3, 3, 3, 3)
    w = T(w0).requires_grad_(True)
    torch.tanh(tsp.conv2d_semipacked(tsp.space_to_width(T(x)), w)).sum() \
        .backward()
    w_ref = T(w0).requires_grad_(True)
    out = torch.nn.functional.conv2d(T(x).permute(0, 3, 1, 2),
                                     w_ref.permute(3, 2, 0, 1), padding=1)
    torch.tanh(tsp.space_to_width(out.permute(0, 2, 3, 1))).sum().backward()
    assert rel_err(w.grad, w_ref.grad.numpy()) <= 1e-4

    def f_sp(wj):
        return jnp.sum(jnp.tanh(jsp.conv2d_semipacked(
            jsp.space_to_width(jnp.asarray(x)), wj)))

    assert rel_err(w.grad, jax.grad(f_sp)(jnp.asarray(w0))) <= 1e-4


@pytest.mark.parametrize("d", [1, 2])
def test_conv2d_semipacked_bf16(rng, d):
    x, w = draw(rng, 1, 8, 8, 4), draw(rng, 3, 3, 4, 4)
    xs = tsp.space_to_width(T(x))
    out = tsp.conv2d_semipacked(xs.bfloat16(), T(w).bfloat16(), dilation=d)
    assert out.dtype == torch.bfloat16
    ref = jsp.conv2d_semipacked(jsp.space_to_width(jnp.asarray(x))
                                .astype(jnp.bfloat16),
                                jnp.asarray(w).astype(jnp.bfloat16),
                                dilation=d)
    assert ref.dtype == jnp.bfloat16
    want = tsp.conv2d_semipacked(xs, T(w), dilation=d)
    assert rel_err(out.float(), want.numpy()) <= 2e-2
    assert rel_err(out.float(), np.asarray(ref.astype(jnp.float32))) <= 2e-2
