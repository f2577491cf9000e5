"""The port's K6 as one pass over the whole epilogue chain, on the CPU,
against the JAX package's `_epi_ref` (vspbfr_tpu/ops/pallas_conv.py:387).

On the CPU `conv_epilogue` / `apply_epilogue` run the plain chain through
the same autograd Function the card uses, so these pin the chain's values,
its backward (slopes from the output's sign or from stage 1's sign mask,
d_out_scale from the saved input) and its double backward:

- forward and every operand's VJP against `jax.vjp(_epi_ref)`, for stage 1
  alone, with one and two post-adds, with the second stage, with and
  without out_scale, with and without the activation;
- R1's double backward (the bias gradient of |dL/dx|^2) against plain
  autograd through `epilogue_plain_chain`, and gradgradcheck in float64;
- f32 operands under a bf16 x against the same operands cast first (what
  the kernel does in registers), and their gradients in their own dtype;
- no autograd Function where no gradient is needed, and the sign mask.

Tolerance: max |port - jax| <= 1e-5 of max |jax| in f32 (the same
elementwise arithmetic; JAX at `highest` precision, which the conftest
sets); the bf16 comparisons are exact (both sides round the same values).
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.ops.pallas_conv import _epi_ref  # noqa: E402
from vspbfr_tpu_torch import ops  # noqa: E402

tep, tfa = (importlib.import_module(f"vspbfr_tpu_torch.ops.{m}")
            for m in ("epilogue", "fused_act"))

B, H, W, C = 2, 5, 6, 8


def assert_rel(port, ref, rel):
    port = np.asarray(port.detach().double().numpy(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


def _operands(rng, osc, act, n_post, stage2):
    """Seeded numpy operands of one chain case, by `_epi_ref`'s names."""
    def r(*shape, scale=1.0, offset=0.0):
        return (rng.standard_normal(shape) * scale + offset).astype(
            np.float32)

    arrs = {"z": r(B, H, W, C), "noise": r(B, H, W, 1, scale=0.5),
            "bias": r(C, scale=0.3)}
    if osc:
        arrs["out_scale"] = r(B, C, scale=0.2, offset=1.0)
    for i in range(n_post):
        arrs[f"post{i}"] = r(B, H, W, C)
    if stage2:
        arrs.update(noise2=r(B, H, W, 1, scale=0.5), bias2=r(C, scale=0.3))
    return arrs, dict(act=act, act2=stage2)


def _split(kw):
    """`_epi_ref` / `apply_epilogue` keyword arguments from a flat dict of
    operands (post0, post1 -> post_add)."""
    out = {k: v for k, v in kw.items() if not k.startswith("post")}
    out["post_add"] = tuple(kw[k] for k in sorted(kw) if k.startswith("post"))
    return out


CHAIN_CASES = [   # (out_scale, act, post-adds, second stage)
    (True, True, 0, False),    # stage 1 alone (a decoder StyledConv)
    (True, True, 1, False),
    (True, True, 2, False),    # RestoreNet StyledConv with its two skips
    (False, True, 0, True),    # the SMART tail
    (True, True, 0, True),
    (False, False, 2, False),  # no scale, no activation
    (True, False, 0, True),    # no first activation, then stage 2
]


@pytest.mark.parametrize("osc,act,n_post,stage2", CHAIN_CASES)
def test_chain_matches_jax_epi_ref(rng, osc, act, n_post, stage2):
    arrs, flags = _operands(rng, osc, act, n_post, stage2)
    names = list(arrs)

    def jfn(*a):
        kw = _split(dict(zip(names, a)))
        return _epi_ref(kw.pop("z"), kw.pop("out_scale", None),
                        kw.pop("noise"), kw.pop("bias"), flags["act"],
                        **kw, act2=flags["act2"])

    out, vjp = jax.vjp(jfn, *map(jnp.asarray, arrs.values()))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs.values()]
    kw = _split(dict(zip(names, leaves)))
    got = ops.apply_epilogue(kw.pop("z"), **kw, **flags)
    assert_rel(got, out, 1e-5)
    g = rng.standard_normal(out.shape).astype(np.float32)
    if stage2 and n_post:
        return   # no backward, as in the JAX package
    for a, ref in zip(torch.autograd.grad(got, leaves, torch.tensor(g)),
                      vjp(jnp.asarray(g))):
        assert_rel(a, ref, 1e-5)


def test_chain_refuses_a_backward_of_stage2_with_post_adds(rng):
    arrs, flags = _operands(rng, True, True, 1, True)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    kw = _split(t)
    y = ops.conv_epilogue(kw.pop("z"), **kw, **flags)
    with pytest.raises(ValueError, match="no gradient"):
        y.sum().backward()


@pytest.mark.parametrize("n_post,stage2", [(0, True), (2, False)])
def test_chain_double_backward_matches_plain_autograd(rng, n_post, stage2):
    """R1 through a chain (the bias gradient of |dL/dx|^2): the Function's
    backward, differentiated again, against plain autograd through
    `epilogue_plain_chain`."""
    arrs, flags = _operands(rng, True, True, n_post, stage2)

    def r1(fn):
        t = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
             for k, v in arrs.items()}
        kw = _split(t)
        z = kw.pop("z")
        (gz,) = torch.autograd.grad((fn(z, **kw, **flags) ** 2).sum(), z,
                                    create_graph=True)
        return torch.autograd.grad((gz ** 2).sum(), t["bias"])[0]

    got, ref = r1(ops.conv_epilogue), r1(ops.epilogue_plain_chain)
    assert_rel(got, ref.numpy(), 1e-10)


@pytest.mark.parametrize("check", [torch.autograd.gradcheck,
                                   torch.autograd.gradgradcheck])
@pytest.mark.parametrize("n_post,stage2", [(0, True), (2, False)])
def test_chain_function_is_twice_differentiable(rng, check, n_post, stage2):
    arrs, flags = _operands(rng, True, True, n_post, stage2)
    # keep the pre-activations away from 0, where lrelu has its kink
    arrs["z"] = arrs["z"] + np.sign(arrs["z"]) * 0.5
    names = list(arrs)
    args = tuple(torch.tensor(a, dtype=torch.float64, requires_grad=True)
                 for a in arrs.values())

    def fn(*a):
        kw = _split(dict(zip(names, a)))
        return ops.conv_epilogue(kw.pop("z"), **kw, **flags)

    assert check(fn, args)


def test_f32_operands_under_bf16_x_match_precast_operands(rng):
    """The operands are read in their own dtype and rounded to x's: the
    same values as casting them first; their gradients come back in their
    own dtype."""
    arrs, flags = _operands(rng, True, True, 0, True)
    f32 = {k: torch.tensor(v) for k, v in arrs.items()}
    x = f32.pop("z").bfloat16()
    pre = {k: v.bfloat16() for k, v in f32.items()}
    got = ops.conv_epilogue(x, **f32, **flags)
    ref = ops.conv_epilogue(x, **pre, **flags)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    leaves = {k: v.clone().requires_grad_() for k, v in f32.items()}
    y = ops.conv_epilogue(x, **leaves, **flags)
    grads = torch.autograd.grad(y.float().sum(), list(leaves.values()))
    assert all(g.dtype == torch.float32 and g.shape == t.shape
               for g, t in zip(grads, leaves.values()))
    b = torch.tensor(arrs["bias"])
    assert torch.equal(ops.fused_leaky_relu(x, b),
                       ops.fused_leaky_relu(x, b.bfloat16()))


def _refuse(*_, **__):
    raise AssertionError("an autograd Function ran")


def test_no_gradient_needed_makes_no_function_call(rng, monkeypatch):
    """Under no_grad, or with no tensor that requires a gradient, K6 and
    K7 call their forward primitive directly; where a gradient is needed
    the Function runs."""
    monkeypatch.setattr(tep._ConvEpilogue, "apply", _refuse)
    monkeypatch.setattr(tfa._FusedLeakyRelu, "apply", _refuse)
    arrs, flags = _operands(rng, True, True, 2, False)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    kw = _split(t)
    z = kw.pop("z")
    with torch.no_grad():
        y = ops.apply_epilogue(z, **kw, **flags)
        ops.fused_leaky_relu(z, t["bias"])
    ref = ops.epilogue_plain_chain(z, **kw, **flags)
    assert not y.requires_grad and torch.allclose(y, ref)
    plain = {k: v.detach() for k, v in kw.items() if k != "post_add"}
    ops.apply_epilogue(z.detach(), **plain, **flags)
    ops.scaled_leaky_relu(z.detach())
    with pytest.raises(AssertionError, match="Function ran"):
        ops.apply_epilogue(z, **kw, **flags)
    with pytest.raises(AssertionError, match="Function ran"):
        ops.fused_leaky_relu(z.detach(), t["bias"])


@pytest.mark.parametrize("n_post,stage2", [(1, False), (0, True)])
def test_forward_primitive_returns_stage1_sign_mask(rng, n_post, stage2):
    """Where something follows stage 1's activation and a gradient is
    needed, the forward returns the sign of stage 1's pre-activation (the
    card's kernel stores it as a byte an element)."""
    arrs, flags = _operands(rng, True, True, n_post, stage2)
    t = {k: torch.tensor(v) for k, v in arrs.items()}
    kw = _split(t)
    z = kw.pop("z")
    y, mask = tep._epilogue_forward(
        z, kw["out_scale"], kw["noise"], kw["bias"], True, kw["post_add"],
        kw.get("noise2"), kw.get("bias2"), flags["act2"], want_mask=True)
    u = ops.epilogue_plain(z, kw["out_scale"], kw["noise"], kw["bias"],
                           act=False)
    assert mask.dtype == torch.bool and torch.equal(mask, u >= 0)
    assert torch.equal(y, ops.epilogue_plain_chain(z, **kw, **flags))


def test_chain_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="post_add"):
        ops.conv_epilogue(x, post_add=(x, x, x))
    with pytest.raises(ValueError, match="post_add"):
        ops.conv_epilogue(x, post_add=(x[..., :4],))
    with pytest.raises(NotImplementedError, match="packed"):
        ops.conv_epilogue(x, noise2=torch.zeros(1, 4, 4, 4))
    with pytest.raises(ValueError, match="bias2"):
        ops.conv_epilogue(x, bias2=torch.zeros(4))


def test_operand_code_reads_operands_in_their_own_dtype():
    """One dtype code for the small operands: their own when they share
    one (no cast), x's after one cast each when they are mixed; contiguous
    copies only where needed; other dtypes raise."""
    from vspbfr_tpu_torch.ops import _build

    x = torch.zeros(2, 3, 4, 5, dtype=torch.bfloat16)
    s, b = torch.ones(2, 5), torch.ones(5)
    code, (s2, n2, b2) = _build.operand_code("k", x, (s, None, b))
    assert code == _build.DTYPE_CODES[torch.float32]
    assert s2 is s and n2 is None and b2 is b
    code, (s2, b2) = _build.operand_code("k", x, (s, b.bfloat16()))
    assert code == _build.DTYPE_CODES[torch.bfloat16]
    assert s2.dtype == b2.dtype == torch.bfloat16
    t = torch.ones(5, 2).t()
    (_, (t2,)) = _build.operand_code("k", x, (t,))
    assert t2.is_contiguous() and torch.equal(t2, t)
    assert _build.operand_code("k", x, (None,))[0] == _build.DTYPE_CODES[
        torch.bfloat16]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.operand_code("k", x, (b.half(),))
    assert _build.addr(None) == 0 and _build.addr(b) == b.data_ptr()
