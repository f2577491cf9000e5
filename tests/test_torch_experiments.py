"""Parity of the port's K8 (interleave forms), K9 (stripe conv) and K10 (its
in-kernel padding variants) with the TPU experiments they replace, on the
CPU, and the `cli.profile` entries that measure them.

The three kernels live only in `scripts/exp_interleave.py`,
`scripts/exp_pallas_conv.py` and `scripts/exp_inkpad.py`; the tests load
the scripts by path. On the CPU the port's wrappers take their plain
versions, so these tests pin the plain versions against the Pallas kernels
on the same seeded numpy inputs:

- K8: `interleave_stack` / `interleave_repeat` against `pallas_stack` /
  `pallas_repeat` (interpret mode, which the script picks off the TPU):
  exactly equal, in f32 and bf16;
- K9: `stripe_conv` against `conv_pallas` (interpret mode), f32, within
  1e-5 of max |ref| (the same products summed in another order);
- K10: `inkpad_conv` against `run` under `pltpu.force_tpu_interpret_mode()`
  (the script passes no `interpret`): `legacy` and `inkpad` everywhere,
  `nomemset` on its interior columns (the border columns read scratch
  that was never zeroed), `nobranch` everywhere at H = 256 (the script
  hard-codes 256 - stripe), within 1e-5 of max |ref|.

JAX runs at `highest` matmul precision (tests/conftest.py). The entries'
work counts and their CPU summaries are checked as `--smart`'s are.
"""

import importlib
import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from vspbfr_tpu_torch import ops  # noqa: E402
from vspbfr_tpu_torch.cli import profile  # noqa: E402

# the package's ops/__init__ re-exports `stripe_conv` under the module's name
tsc = importlib.import_module("vspbfr_tpu_torch.ops.stripe_conv")
SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exp_interleave():
    return _script("exp_interleave")


@pytest.fixture(scope="module")
def exp_pallas_conv():
    return _script("exp_pallas_conv")


@pytest.fixture(scope="module")
def exp_inkpad():
    return _script("exp_inkpad")


def _np(t):
    return t.detach().float().numpy()


def assert_rel(port, ref, rel):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["stack", "repeat"])
@pytest.mark.parametrize("shape,inner,h_t", [((1, 8, 8, 32), 8, 4),
                                             ((2, 4, 8, 64), 16, 2)])
def test_interleave_forms_equal_the_pallas_kernels(exp_interleave, dt, form,
                                                   shape, inner, h_t):
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    if form == "stack":
        ref = exp_interleave.pallas_stack(xj, inner, h_t=h_t)
        got = ops.interleave_stack(xt, inner)
    else:
        ref = exp_interleave.pallas_repeat(xj, inner, h_t=h_t)
        got = ops.interleave_repeat(xt, inner)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(
        np.asarray(ref, np.float32),
        np.asarray(exp_interleave.xla6d(xj, inner), np.float32))


@pytest.mark.parametrize("xs,ws,pads", [
    ((1, 16, 16, 8), (3, 3, 8, 8), (1, 1, 1, 1)),
    ((2, 8, 12, 8), (2, 2, 8, 16), (0, 1, 0, 1)),
    ((1, 8, 8, 16), (3, 3, 16, 4), (1, 1, 1, 1)),
])
def test_stripe_conv_matches_conv_pallas(exp_pallas_conv, xs, ws, pads):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.2).astype(np.float32)
    py0, py1, px0, px1 = pads
    ref = exp_pallas_conv.conv_pallas(jnp.asarray(x), jnp.asarray(w), py0,
                                      py1, px0, px1)
    got = ops.stripe_conv(torch.from_numpy(x), torch.from_numpy(w),
                          ((py0, py1), (px0, px1)))
    assert_rel(_np(got), np.asarray(ref), 1e-5)


def _inkpad_inputs(shape, co, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[3], co)) * 0.2).astype(np.float32)
    return x, w


@pytest.mark.parametrize("variant,shape,h_t,cols", [
    ("legacy", (1, 16, 16, 8), 4, slice(None)),
    ("inkpad", (1, 16, 16, 8), 4, slice(None)),
    ("nomemset", (1, 16, 16, 8), 4, slice(1, -1)),
    ("nobranch", (1, 256, 8, 4), 16, slice(None)),
])
def test_inkpad_conv_matches_run(exp_inkpad, variant, shape, h_t, cols):
    x, w = _inkpad_inputs(shape, 8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(exp_inkpad.run(jnp.asarray(x), jnp.asarray(w),
                                        variant, h_t=h_t))
    got = _np(ops.inkpad_conv(torch.from_numpy(x), torch.from_numpy(w),
                              variant, h_t=h_t))
    assert_rel(got[:, :, cols], ref[:, :, cols], 1e-5)
    if variant == "nomemset":
        assert np.isnan(got[:, :, [0, -1]]).all()
    assert np.isfinite(got[:, :, cols]).all()


def test_stripe_model_reads_each_tiles_rows():
    rows = tsc.stripe_rows(40, 16)
    # tiles start at 0 and 16; the third (32) is clamped to 40 - 18 = 22
    assert rows[:16].tolist() == list(range(16))
    assert rows[16:32].tolist() == list(range(16, 32))
    assert rows[32:].tolist() == list(range(22, 30))


def test_inkpad_legacy_and_inkpad_equal_the_pad1_conv():
    x, w = _inkpad_inputs((2, 12, 10, 6), 5, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref = ops.stripe_conv(xt, wt, ((1, 1), (1, 1)))
    for v in ("legacy", "inkpad"):
        assert torch.equal(ops.inkpad_conv(xt, wt, v, h_t=4), ref)


def test_interleave_work_and_cpu_summary():
    assert profile.interleave_work(4, 256, 256, 128, 4) == (
        0, 2 * 4 * 256 * 256 * 512 * 4)
    rows = profile.profile_interleave(
        torch.float32, device="cpu", shapes=((4, 8),), batch=1,
        timer=lambda fn: (fn(), 2.0)[1])
    assert [r["form"] for r in rows] == ["stack", "repeat"]
    for r in rows:
        assert (r["h"], r["inner"], r["batch"], r["dtype"]) == (4, 8, 1,
                                                                "f32")
        assert r["exact"] and r["max_rel_diff"] == 0.0
        assert r["ms"] == r["plain_ms"] == r["k3_ms"] == 2.0
        assert r["library_ms"] == 2.0 and r["launches"] == 0
        assert (r["flops"], r["bytes"]) == profile.interleave_work(1, 4, 4,
                                                                   8, 4)
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0


@pytest.mark.parametrize("h,w,k,pads", [
    (9, 7, (3, 3), ((1, 1), (1, 1))), (8, 8, (2, 2), ((0, 1), (0, 1))),
    (6, 5, (3, 2), ((0, 2), (1, 0))), (4, 4, (5, 5), ((2, 2), (0, 4)))])
def test_stripe_work_counts_the_taps_inside_the_image(h, w, k, pads):
    """Against a brute-force count: a conv of ones padded with zeros sums
    one for each (output, tap) pair whose input lies inside the image."""
    (py0, py1), (px0, px1) = pads
    ones = F.pad(torch.ones(1, 1, h, w), (px0, px1, py0, py1))
    taps = int(F.conv2d(ones, torch.ones(1, 1, *k)).sum())
    flops, moved = profile.stripe_work(2, h, w, 3, *k, 5, pads, 4)
    assert flops == 2 * 2 * 3 * 5 * taps
    oh, ow = h + py0 + py1 - k[0] + 1, w + px0 + px1 - k[1] + 1
    assert moved == 4 * (2 * h * w * 3 + k[0] * k[1] * 3 * 5
                         + 2 * oh * ow * 5)


def test_stripe_work_and_cpu_summary():
    # the script's first shape: 3 * 512 - 2 taps inside along each axis
    flops, moved = profile.stripe_work(4, 512, 512, 128, 3, 3, 128,
                                       ((1, 1), (1, 1)), 2)
    assert flops == 2 * 4 * 1534 * 1534 * 128 * 128
    assert moved == 2 * (2 * 4 * 512 * 512 * 128 + 9 * 128 * 128)
    flops, _ = profile.stripe_work(1, 8, 8, 4, 2, 2, 6, ((0, 1), (0, 1)), 4)
    assert flops == 2 * 15 * 15 * 4 * 6
    rows = profile.profile_stripe_conv(
        torch.float32, device="cpu",
        shapes=(((1, 8, 8, 4), (2, 2, 4, 6), ((0, 1), (0, 1))),),
        timer=lambda fn: (fn(), 3.0)[1])
    (r,) = rows
    assert r["max_rel_diff"] <= 1e-6 and r["launches"] == 0
    assert r["ms"] == r["plain_ms"] == r["library_ms"] == 3.0
    assert (r["flops"], r["bytes"]) == profile.stripe_work(
        1, 8, 8, 4, 2, 2, 6, ((0, 1), (0, 1)), 4)


def test_inkpad_cpu_summary():
    rows = profile.profile_inkpad(torch.float32, device="cpu",
                                  shape=(1, 20, 8, 4), co=4, h_t=4,
                                  timer=lambda fn: (fn(), 1.0)[1])
    assert [r["variant"] for r in rows] == list(tsc.VARIANTS)
    by = {r["variant"]: r for r in rows}
    for r in rows:
        assert r["max_rel_diff"] <= 1e-6 and r["launches"] == 0
        assert r["ms"] == r["plain_ms"] == r["library_ms"] == 1.0
    assert by["legacy"]["vs_legacy_max_abs"] == 0.0
    assert by["inkpad"]["vs_legacy_max_abs"] == 0.0
    # nomemset matches legacy where it is defined; its border is not finite
    assert by["nomemset"]["vs_legacy_max_abs"] == 0.0
    assert by["nomemset"]["nonfinite"] == 2 * 20 * 4
    # nobranch reads other rows than legacy in the tiles it clamps
    assert by["nobranch"]["vs_legacy_max_abs"] > 0
    assert by["nobranch"]["nonfinite"] == 0


@pytest.mark.parametrize("call", [
    lambda x: ops.interleave_stack(x, 3),
    lambda x: ops.interleave_repeat(x, 3),
    lambda x: ops.stripe_conv(x, torch.zeros(3, 3, 5, 4), ((1, 1), (1, 1))),
    lambda x: ops.stripe_conv(x, torch.zeros(3, 3, 4, 4), ((-1, 1), (1, 1))),
    lambda x: ops.inkpad_conv(x, torch.zeros(2, 2, 4, 4), "inkpad", 4),
    lambda x: ops.inkpad_conv(x, torch.zeros(3, 3, 4, 4), "fast", 4),
    lambda x: ops.inkpad_conv(x, torch.zeros(3, 3, 4, 4), "inkpad", 3),
    lambda x: ops.inkpad_conv(x, torch.zeros(3, 3, 4, 4), "nobranch", 16),
])
def test_wrappers_refuse_wrong_shapes(call):
    with pytest.raises(ValueError):
        call(torch.zeros(1, 8, 8, 4))


@pytest.mark.parametrize("call", [
    lambda x: ops.interleave_stack(x, 1),
    lambda x: ops.interleave_repeat(x, 1),
    lambda x: ops.stripe_conv(x, torch.zeros(3, 3, 4, 4, device="meta"),
                              ((1, 1), (1, 1))),
    lambda x: ops.inkpad_conv(x, torch.zeros(3, 3, 4, 4, device="meta"),
                              "inkpad", 4),
])
def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda(call):
    with pytest.raises(ValueError, match="no kernel for device"):
        call(torch.zeros(1, 8, 8, 4, device="meta"))
