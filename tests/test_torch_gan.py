"""Stage 3's discriminator, GAN losses and R1 in the port against the JAX
package, on the CPU.

The flax `Discriminator` (size 16, channel_div 8: the final conv takes
Ci = 64 + 1 after `minibatch_stddev`, an odd count), its parameters moved
off their init, goes through `state_dict_from_jax` into the port's; both
run on the same numpy images. R1 and its D-parameter gradient are compared
with the `VSPBFR_FUSED_EPI` switch off (K1 + torch epilogue) and on (the
K1e Function, whose double backward R1 runs through).

Tolerances: D's logits and parameter gradient, R1 and its gradient <= 1e-4
of max |jax| (f32, summation order); the losses and minibatch_stddev
<= 1e-6; R1 with remat on vs off <= 1e-6 (the same ops, recomputed).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from vspbfr_tpu.losses import gan as jgan  # noqa: E402
from vspbfr_tpu.models import layers as jl  # noqa: E402
from vspbfr_tpu.models import restorenet as jrn  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.losses import gan as tgan  # noqa: E402
from vspbfr_tpu_torch.models import layers as tl  # noqa: E402
from vspbfr_tpu_torch.models import restorenet as trn  # noqa: E402

SIZE, B = 16, 4
T = torch.tensor


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach().double() if hasattr(port, "detach")
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.fixture(scope="module")
def disc():
    """(flax module, jittered flax params, port Discriminator with them)."""
    fm = jrn.Discriminator(size=SIZE, channel_div=8)
    params = jax.jit(fm.init)(jax.random.key(0),
                              jnp.zeros((B, SIZE, SIZE, 3)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda v: np.asarray(v, np.float32)
        + rng.standard_normal(v.shape).astype(np.float32) * 0.1, params)
    tm = trn.Discriminator(size=SIZE, channel_div=8)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    assert tm.final_conv.conv.weight.shape[2] == 65
    return fm, params, tm


def images(seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)


def port_grads(tm, loss) -> dict:
    names = [k for k, _ in tm.named_parameters()]
    params = [p for _, p in tm.named_parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for k, p, g in zip(names, params, grads)}


def assert_grads(got: dict, ref_tree, tm, rel):
    ref = state_dict_from_jax(jax.tree.map(np.asarray, ref_tree), tm)
    assert set(ref) == set(got)
    worst = max(rel_err(got[k], ref[k]) for k in got)
    assert worst <= rel, worst


@pytest.mark.parametrize("fused", ["0", "1"])
def test_discriminator_and_param_grads_match_jax(disc, monkeypatch, fused):
    monkeypatch.setenv("VSPBFR_FUSED_EPI", fused)
    fm, params, tm = disc
    x = images(2)
    w = np.random.default_rng(3).standard_normal((B, 1)).astype(np.float32)

    def jloss(p):
        return jnp.sum(fm.apply({"params": p}, jnp.asarray(x))
                       * jnp.asarray(w))

    ref_out = fm.apply({"params": params}, jnp.asarray(x))
    ref_g = jax.grad(jloss)(params)
    out = tm(T(x))
    assert rel_err(out, ref_out) <= 1e-4
    assert_grads(port_grads(tm, (out * T(w)).sum()), ref_g, tm, 1e-4)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_r1_and_its_param_grads_match_jax(disc, monkeypatch, fused):
    """The penalty E||dD/dx||^2 and its gradient in D's parameters (a
    double backward through every conv of D)."""
    monkeypatch.setenv("VSPBFR_FUSED_EPI", fused)
    fm, params, tm = disc
    real = images(4)

    def jpen(p):
        return jgan.r1_penalty(lambda x_: fm.apply({"params": p}, x_),
                               jnp.asarray(real))

    ref_pen, ref_g = jax.value_and_grad(jpen)(params)
    pen = tgan.r1_penalty(tm, T(real))
    assert rel_err(pen, ref_pen) <= 1e-4
    assert_grads(port_grads(tm, pen), ref_g, tm, 1e-4)


def test_r1_with_remat_equals_r1_without(disc):
    """Non-reentrant checkpointing of D leaves R1 and its parameter
    gradient as they are: the double backward runs through the
    recompute."""
    _, _, tm = disc
    real = T(images(5))
    pens, grads = [], []
    for remat in (False, True):
        def d_fn(x):
            return checkpoint(tm, x, use_reentrant=False) if remat else tm(x)
        pen = tgan.r1_penalty(d_fn, real)
        pens.append(pen)
        grads.append(port_grads(tm, pen))
    assert rel_err(pens[1], pens[0].detach().numpy()) <= 1e-6
    for k in grads[0]:
        assert rel_err(grads[1][k], grads[0][k].numpy()) <= 1e-6, k


@pytest.mark.parametrize("b", [4, 8, 2])
def test_minibatch_stddev_matches_jax(b):
    x = np.random.default_rng(6).standard_normal((b, 4, 4, 6)).astype(
        np.float32)
    ref = jl.minibatch_stddev(jnp.asarray(x))
    got = tl.minibatch_stddev(T(x))
    assert got.shape == (b, 4, 4, 7)
    assert rel_err(got, ref) <= 1e-6


def test_gan_losses_match_jax():
    rng = np.random.default_rng(7)
    real, fake = (rng.standard_normal((5, 1)).astype(np.float32) * 3
                  for _ in range(2))
    assert rel_err(tgan.d_logistic_loss(T(real), T(fake)),
                   jgan.d_logistic_loss(jnp.asarray(real),
                                        jnp.asarray(fake))) <= 1e-6
    assert rel_err(tgan.g_nonsaturating_loss(T(fake)),
                   jgan.g_nonsaturating_loss(jnp.asarray(fake))) <= 1e-6
    # R1 of D(x) = sum(a * x^2) per sample: dD/dx = 2 a x
    a = rng.standard_normal((3, 4)).astype(np.float32)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    pen = tgan.r1_penalty(lambda v: (T(a) * v * v).sum(dim=(1, 2)), T(x))
    want = np.mean(np.sum((2 * a * x) ** 2, axis=(1, 2)))
    assert rel_err(pen, want) <= 1e-6
    assert rel_err(pen, jgan.r1_penalty(
        lambda v: jnp.sum(jnp.asarray(a) * v * v, axis=(1, 2)),
        jnp.asarray(x))) <= 1e-6
