"""The port's stage-2 losses against the JAX package's, on the CPU.

KD, LPIPS (VGG16 + lin) and the ArcFace ID loss (ResNet-101 embedder at
b1, 112 px) on the same numpy inputs, with random flax parameter trees
carried into the port by `state_dict_from_jax` (which raises on any unused
or unfilled name). Values and the gradients with respect to the input
image.

Tolerance: values and gradients <= 1e-4 of max |jax| in f32 (1e-3 through
the 101-layer embedder, whose sums compound); the bf16 trunks <= 3e-2
(bf16 rounding at every layer in both frameworks, at other places).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.losses import id_loss as jid  # noqa: E402
from vspbfr_tpu.losses import lpips as jlp  # noqa: E402
from vspbfr_tpu.losses.kd import kd_loss as j_kd  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.losses import (  # noqa: E402
    LPIPS,
    ResNet101Embedder,
    id_loss,
    kd_loss,
)
from vspbfr_tpu_torch.models.layers import init_module  # noqa: E402


def assert_rel(port, ref, rel):
    port = np.asarray(port.detach().float(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


def _random_params(init, *args, seed):
    """A flax parameter tree of init's shapes (traced, not run), filled
    from numpy: conv and dense kernels N(0, 1/fan_in), everything else near
    its neutral value (lin heads and BN scale/var near 1, biases and BN
    means near 0) but off it, so that every parameter matters."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.key(0), *args)["params"]

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var") or name.startswith("lin"):
            return 1.0 + 0.05 * np.abs(n)
        return 0.05 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_kd_loss_matches_jax(rng):
    pred = rng.standard_normal((2, 18, 512)).astype(np.float32)
    target = rng.standard_normal((2, 18, 512)).astype(np.float32)
    kl_r, l1_r = j_kd(jnp.asarray(pred), jnp.asarray(target), 0.15)
    g_r = jax.grad(lambda p: j_kd(p, jnp.asarray(target), 0.15)[1])(
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    kl, l1 = kd_loss(p, torch.tensor(target), 0.15)
    l1.backward()
    assert_rel(kl, kl_r, 1e-5)
    assert_rel(l1, l1_r, 1e-6)
    assert_rel(p.grad, g_r, 1e-6)


@pytest.fixture(scope="module")
def lpips_params():
    z = jnp.zeros((1, 32, 32, 3))
    return _random_params(jlp.LPIPS().init, z, z, seed=1)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_lpips_value_and_input_grad_match_jax(lpips_params, dtype):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jnet = jlp.LPIPS(compute_dtype=None if dtype is None else jnp.bfloat16)

    def jfn(a):
        return jnp.mean(jnet.apply({"params": lpips_params}, a,
                                   jnp.asarray(y)))

    val_r, g_r = jax.value_and_grad(jfn)(jnp.asarray(x))
    net = LPIPS(compute_dtype=None if dtype is None else torch.bfloat16)
    net.load_state_dict(state_dict_from_jax(lpips_params, net))
    xt = torch.tensor(x, requires_grad=True)
    val = torch.mean(net(xt, torch.tensor(y)))
    val.backward()
    rel = 1e-4 if dtype is None else 3e-2
    assert_rel(val, val_r, rel)
    assert_rel(xt.grad, g_r, rel)


def test_id_loss_and_embedder_match_jax():
    jnet = jid.ResNet101Embedder()
    params = _random_params(jnet.init, jnp.zeros((1, 112, 112, 3)), seed=4)
    rng = np.random.default_rng(5)
    fake = rng.uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    val_r, g_r = jax.value_and_grad(
        lambda a: jid.id_loss(jnet.apply, params, a, jnp.asarray(real)))(
        jnp.asarray(fake))

    net = ResNet101Embedder()
    net.load_state_dict(state_dict_from_jax(params, net))
    net.requires_grad_(False)
    ft = torch.tensor(fake, requires_grad=True)
    val = id_loss(net, ft, torch.tensor(real))
    val.backward()
    assert_rel(val, val_r, 1e-3)
    assert_rel(ft.grad, g_r, 1e-3)


def test_id_loss_is_zero_for_the_same_image():
    net = ResNet101Embedder()
    init_module(net, torch.Generator().manual_seed(0))
    img = torch.rand(1, 64, 64, 3) * 2 - 1
    with torch.no_grad():
        assert float(id_loss(net, img, img)) == pytest.approx(0.0, abs=1e-6)
