"""Stage-3 training in the port against the JAX package, on the CPU.

The tiny config (size 32, decoder 64, encode 64, one-unit IR-SE body,
channel_div 8, unpacked layout). Both sides start from the same
parameters (the flax trees through `state_dict_from_jax`; G and D moved
off their init, so the noise gains and biases are live) and see the same
batch. The JAX d_phase computes the frozen embedding (clean, feats) and the
port is handed it, rather than recomputing it through the random-init DDPM
chain. The generator's draws are the JAX step's own: z and the inject
index from the key split of `sample_mixing_latent`, and every noise map and
the dropout mask as flax drew them (recorded with `nn.intercept_methods`
on a forward with the step's keys). id_weight is 0 (the ID net has its own
test); LPIPS is on.

Three cases: without ADA, with ADA at the fixed augment_p 0.5, and with
adaptive ADA from a state one step short of an adjust (so the controller's
update fires in the D phase and the G phase runs at the new p). The
augment draws are JAX's own, reproduced from the keys the JAX phases split
(`tests/test_torch_ada.py::jax_augment_draws`); the D phase's metrics then
include the controller's signal (ada_rt, equal), the G phase's the p it
ran at, and the adaptive case's controller state must match JAX's.

What is compared, with its tolerance:

- the D phase (D update, then R1, which is due at G step 0): its metrics
  <= 1e-4 of |jax|; D's Adam moments, which hold the gradients (beta1 = 0:
  mu is the R1 update's gradient, nu mixes both updates' squares) <= 1e-3
  of max |jax| per tensor; D's parameters after the two updates <= 1e-4
  (Adam's first steps move each element by about lr, so an element whose
  gradient is near 0 may move by a different fraction of lr);
- the G phase against JAX's updated D: metrics <= 1e-4; G's gradient (mu)
  <= 1e-3 per tensor (the scalar noise gains, each a sum over a whole map,
  as one vector); G's parameters after the update within 2 lr of JAX's
  (an element whose gradient is float noise, ~1e-6 of the tensor's, may
  step along the other sign); g_ema <= 1e-5 (it takes 1 - decay of that
  update). The 1e-3 bounds cover float32
  summation order through the 20-odd layers of G and D, and the double
  backward of R1. With ADA, D's moments are held per tensor to 1e-3 or to
  twice the port's own spread under +-1e-6 moves of the warps' parameters,
  the larger (see `test_d_phase_matches_jax`: D's bias vectors' R1
  gradients move by ~1e-2 under them).

The stage-3 CLI's test is `tests/test_torch_restore_cli.py` (each file
stays under a minute on one CPU core).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu.models import layers as jl  # noqa: E402
from vspbfr_tpu.models.e4e import TINY_STAGES  # noqa: E402
from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline  # noqa: E402
from vspbfr_tpu.train.restore_train import (  # noqa: E402
    RestoreTrainConfig as JaxConfig,
    RestoreTrainer as JaxTrainer,
)
from vspbfr_tpu.losses.ada import ADAState as JaxADAState  # noqa: E402
from vspbfr_tpu.train.state import TrainState as JaxState  # noqa: E402
from vspbfr_tpu_torch.convert import port_key, state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.losses import ADAState  # noqa: E402
from vspbfr_tpu_torch.pipeline import RestorationPipeline  # noqa: E402
from vspbfr_tpu_torch.train.restore_train import (  # noqa: E402
    RestoreTrainConfig,
    RestoreTrainer,
)

from test_torch_ada import jax_augment_draws  # noqa: E402

CFG = dict(size=32, decoder_size=64, encode_size=64,
           encoder_stages=TINY_STAGES, channel_div=8)
B = 2
T = torch.tensor


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach().double() if hasattr(port, "detach")
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12))


def jitter(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: v + rng.standard_normal(v.shape).astype(
        np.float32) * 0.05, tree)


def flax_tree_of(module, shapes):
    """The flax tree of `shapes` (a tree of ShapeDtypeStructs) filled from
    the port module's state_dict (the inverse of `state_dict_from_jax`)."""
    sd = module.state_dict()
    return jax.tree_util.tree_map_with_path(
        lambda path, _: sd[port_key(tuple(k.key for k in path))].numpy(),
        shapes)


def jax_draws(record, g_params, low, feats, clean, key):
    """The generator draws of `_generate(..., key)` in JAX: z and the
    inject index by the same key split, the noise maps and the dropout
    keep mask recorded from a flax forward with the same rngs."""
    z, idx, maps, keep = record(g_params, low, feats, clean, key)
    return {"z": T(np.asarray(z)), "inject_index": int(idx),
            "noise": [T(np.asarray(m)) for m in maps],
            "keep": T(np.asarray(keep))}


def draw_recorder(jtr):
    """A jitted forward of the JAX generator as `_generate` runs it, which
    returns the draws it made."""
    n_lat = jtr.pipe.generator.n_latent

    def record(g_params, low, feats, clean, key):
        k_mix, k_noise, k_drop = jax.random.split(key, 3)
        k_z, k_flip, k_idx = jax.random.split(k_mix, 3)
        z = jax.random.normal(k_z, (2, B, 512))
        idx = jnp.where(jax.random.bernoulli(k_flip, jtr.pipe.mixing_prob),
                        jax.random.randint(k_idx, (), 1, n_lat), n_lat)
        noise_latent = jtr.pipe.sample_mixing_latent(g_params, k_mix, B)
        maps, keep = [], []

        def rec(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, jl.NoiseInjection):
                maps.append(out[1])
            elif isinstance(context.module, nn.Dropout):
                keep.append(out != 0)
            return out

        with nn.intercept_methods(rec):
            jtr.pipe.generator.apply(
                {"params": g_params}, low, feats, clean, noise_latent,
                input_is_latent=True, deterministic=False,
                rngs={"noise": k_noise, "dropout": k_drop})
        return z, idx, maps, keep[0]

    return jax.jit(record)


def compile_all(fns_args):
    """Lower each (jitted fn, args) in turn (tracing holds the GIL) and
    compile them on threads (XLA compiles without it)."""
    lowered = [fn.lower(*args) for fn, args in fns_args]
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda lo: lo.compile(), lowered))


ADA_LENGTH = 10_000
# the controller's state handed to both frameworks in the adaptive case:
# p 0.5, one step short of an adjust, so this step's update fires and the
# G phase runs at the new p
ADA_START = {"fixed": dict(p=0.5, sign_sum=0.0, count=0.0, steps=0),
             "adaptive": dict(p=0.5, sign_sum=100.0, count=510.0,
                              steps=255)}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, shared by the three cases: the weights (the port's
    seeded init, G and D moved off it, carried into the flax trees; no JAX
    init is compiled), the batch, the keys, and the compiled phases of two
    JAX trainers, without ADA and with adaptive ADA (augment_p 0: the
    fixed case runs it with a state whose update does not fire, so its p
    stays 0.5). JAX runs without remat and the port with it (f32's
    default): remat changes the schedule, not the math."""
    tr = RestoreTrainer(RestoreTrainConfig(size=32, batch=B, id_weight=0.0),
                        RestorationPipeline(**CFG)).init_from_seed(0)
    assert tr.remat
    jpipe = JaxPipeline(packed_min_res=0, **CFG)
    jkw = dict(size=32, batch=B, id_weight=0.0, remat=False)
    jtr = JaxTrainer(JaxConfig(**jkw), jpipe)
    jtr_ada = JaxTrainer(JaxConfig(**jkw, augment=True,
                                   ada_length=ADA_LENGTH), jpipe)
    g_sh, d_sh, _, fr_sh = jax.eval_shape(jtr.init_states,
                                          jax.random.key(0))
    g_params = jitter(flax_tree_of(tr.gen, g_sh.params), 1)
    d_params = jitter(flax_tree_of(tr.disc, d_sh.params), 2)
    frozen = {name: flax_tree_of(tr.modules[name], fr_sh[name])
              for name in ("psp", "diffuser", "lpips")}
    frozen["id"] = {}
    # every port module's state_dict (the ID net is not used)
    weights = {name: tr.modules[name].state_dict()
               for name in ("psp", "diffuser", "lpips")}
    for name, tree in (("generator", g_params), ("g_ema", g_params),
                       ("disc", d_params)):
        weights[name] = state_dict_from_jax(tree, tr.modules[name])
    g_state = JaxState.create(jax.tree.map(jnp.asarray, g_params), jtr.g_tx)
    d_state = JaxState.create(jax.tree.map(jnp.asarray, d_params), jtr.d_tx)
    rng = np.random.default_rng(3)
    low, real = (jnp.asarray(rng.uniform(-1, 1, (B, 32, 32, 3)),
                             jnp.float32) for _ in range(2))
    k_d, k_g = jax.random.split(jax.random.key(4))
    # the embedding's shapes, for lowering the G phase before it runs
    clean_s, feats_s = jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
        tr.embedding(T(np.asarray(low)), tr.draw(
            B, torch.Generator().manual_seed(0))["embed"]))
    keys_d, keys_g = jax.random.split(k_d, 5), jax.random.split(k_g)
    ada0 = JaxADAState.create()
    d_args = (d_state, g_state.params, g_state.step, frozen, low, real, k_d)
    g_args = (g_state, g_state.params, d_state.params, frozen, low, real,
              clean_s, feats_s, k_g)
    d_fn, g_fn, d_ada, g_ada, rec_fn = compile_all([
        (jax.jit(jtr.d_phase), d_args),
        (jax.jit(jtr.g_phase), g_args),
        (jax.jit(jtr_ada.d_phase), d_args + (ada0,)),
        (jax.jit(jtr_ada.g_phase), g_args + (ada0.p,)),
        (draw_recorder(jtr), (g_state.params, low, feats_s, clean_s,
                              keys_d[1]))])
    return dict(weights=weights, g_state=g_state, d_state=d_state,
                frozen=frozen, low=low, real=real, k_d=k_d, k_g=k_g,
                keys_d=keys_d, keys_g=keys_g, fns=(d_fn, g_fn), ada_fns=(
                    d_ada, g_ada), rec_fn=rec_fn, n_feats=len(feats_s))


def port_trainer(mode, weights):
    """A port trainer on `weights`: without ADA (mode None), with ADA at
    augment_p 0.5 ("fixed") or adaptive, the controller at `ADA_START`."""
    kw = dict(size=32, batch=B, id_weight=0.0)
    if mode:
        kw.update(augment=True, ada_length=ADA_LENGTH,
                  augment_p=0.5 if mode == "fixed" else 0.0)
    tr = RestoreTrainer(RestoreTrainConfig(**kw), RestorationPipeline(**CFG))
    for name, sd in weights.items():
        tr.modules[name].load_state_dict(sd)
    if mode:
        start = ADA_START[mode]
        tr.ada_state = ADAState(
            p=T(start["p"]), sign_sum=T(start["sign_sum"]),
            count=T(start["count"]),
            steps=T(start["steps"], dtype=torch.int32))
    return tr


@pytest.fixture(scope="module", params=[None, "fixed", "adaptive"])
def run(request, jax_run):
    """One JAX step (d_phase, then g_phase) and a port trainer from the
    same weights, without ADA, with ADA at the fixed augment_p 0.5, or
    adaptive from `ADA_START`. The augment draws are JAX's (from the keys
    the phases split), handed to the port in each phase's "ada" entry."""
    mode, j = request.param, jax_run
    tr = port_trainer(mode, j["weights"])
    g_state, d_state, frozen = j["g_state"], j["d_state"], j["frozen"]
    low, real = j["low"], j["real"]
    if mode:
        start = ADA_START[mode]
        jstate = JaxADAState(
            p=jnp.float32(start["p"]), sign_sum=jnp.float32(start["sign_sum"]),
            count=jnp.float32(start["count"]),
            steps=jnp.int32(start["steps"]))
        d_fn, g_fn = j["ada_fns"]
        d_out, clean, feats, d_m, jstate = d_fn(
            d_state, g_state.params, g_state.step, frozen, low, real,
            j["k_d"], jstate)
    else:
        d_fn, g_fn = j["fns"]
        d_out, clean, feats, d_m, _ = d_fn(
            d_state, g_state.params, g_state.step, frozen, low, real,
            j["k_d"])
    # the JAX decode keeps the feature above out_size, which RestoreNet
    # does not read; the port's decode stops at out_size
    feats = feats[:j["n_feats"]]
    g_args = (g_state, g_state.params, d_out.params, frozen, low, real,
              clean, feats, j["k_g"]) + ((jstate.p,) if mode else ())
    g_out, ema_out, g_m = g_fn(*g_args)
    keys_d, keys_g = j["keys_d"], j["keys_g"]
    draws_d = jax_draws(j["rec_fn"], g_state.params, low, feats, clean,
                        keys_d[1])
    draws_g = jax_draws(j["rec_fn"], g_state.params, low, feats, clean,
                        keys_g[0])
    if mode:
        draws_d["ada"] = {part: jax_augment_draws(keys_d[i], B)
                          for part, i in (("real", 2), ("fake", 3),
                                          ("r1", 4))}
        draws_g["ada"] = {"fake": jax_augment_draws(keys_g[1], B)}
        g_m = {**g_m, "ada_p": jstate.p}
    batch = {"low": T(np.asarray(low)), "real": T(np.asarray(real)),
             "clean": T(np.asarray(clean)),
             "feats": [T(np.asarray(f)) for f in feats]}
    return dict(tr=tr, mode=mode, weights=j["weights"], batch=batch,
                draws_d=draws_d,
                draws_g=draws_g, d_out=d_out, d_m=d_m, g_out=g_out,
                ema_out=ema_out, g_m=g_m,
                ada_after=jstate if mode else None)


def port_moments(tr_state, module):
    """The port's Adam moments and parameters, by parameter name."""
    got = {"mu": {}, "nu": {}, "params": {}}
    for k, p in module.named_parameters():
        st = tr_state.opt.state[p]
        got["mu"][k], got["nu"][k] = st["exp_avg"], st["exp_avg_sq"]
        got["params"][k] = p
    return got


def adam_moments(tr_state, jax_state, module):
    """(port, jax) pairs of the Adam moments and the parameters, by
    parameter name."""
    names = [k for k, _ in module.named_parameters()]
    adam = jax_state.opt_state[0]
    ref = {what: state_dict_from_jax(jax.tree.map(np.asarray, tree), module)
           for what, tree in (("mu", adam.mu), ("nu", adam.nu),
                              ("params", jax_state.params))}
    return names, port_moments(tr_state, module), ref


# the affine draws that set the warp's coordinates continuously
WARP_DRAWS = ("t_int", "iso", "th_pre", "aniso", "th_post", "t_frac")


def own_spread(run, got, eps: float) -> dict:
    """Per moment and D tensor, how far the port's own D phase moves (rel.
    to max) when the continuous parameters of every warp move by +-eps."""
    b, out = run["batch"], {"mu": {}, "nu": {}}
    for f in (1 + eps, 1 - eps):
        draws = {**run["draws_d"], "ada": {
            part: {**d, "affine": {k: v * f if k in WARP_DRAWS else v
                                   for k, v in d["affine"].items()}}
            for part, d in run["draws_d"]["ada"].items()}}
        tr = port_trainer(run["mode"], run["weights"])
        tr.d_phase(b["low"], b["real"], b["clean"], b["feats"], draws)
        moved = port_moments(tr.d_state, tr.disc)
        for what in out:
            for k, v in moved[what].items():
                out[what][k] = max(out[what].get(k, 0.0),
                                   rel_err(v, got[what][k].detach()))
    return out


def worst(names, got, ref) -> float:
    return max(rel_err(got[k], ref[k]) for k in names)


def test_d_phase_matches_jax(run):
    tr, b = run["tr"], run["batch"]
    m = tr.d_phase(b["low"], b["real"], b["clean"], b["feats"],
                   run["draws_d"])
    assert tr.d_state.step == 2            # the D update and R1
    assert float(m["r1"]) > 0
    keys = ("d", "r1", "real_score", "fake_score")
    if run["mode"]:
        keys += ("ada_rt",)
        assert float(run["d_m"]["ada_rt"]) == float(m["ada_rt"])
    assert set(m) == set(keys)
    for k in keys:
        assert rel_err(m[k], run["d_m"][k]) <= 1e-4, k
    if run["mode"] == "adaptive":
        # the update fired: p moved, the counts restarted
        after = run["ada_after"]
        assert float(after.p) != 0.5 and int(after.steps) == 0
        for k in ("p", "sign_sum", "count", "steps"):
            assert float(getattr(tr.ada_state, k)) == pytest.approx(
                float(getattr(after, k)), abs=1e-7), k
    names, got, ref = adam_moments(tr.d_state, run["d_out"], tr.disc)
    if run["mode"]:
        # with ADA the gradients of D's bias vectors are conditioned worse
        # than 1e-3 (the port's own R1 moments move by ~2e-3 there when the
        # batch moves by +-1e-6), and the two frameworks' augmented images
        # differ by ~5e-6: their warp coordinates differ by an ulp (XLA and
        # torch sum G^-1's products in other orders). The port's own
        # moments move as far when the warps' parameters move by +-1e-6
        # (measured: 1.9e-3 vs JAX, 1.9e-3 own, on res.5.conv1's bias nu).
        # So each tensor is held to 1e-3 or to twice that own spread (two
        # roundings, each off the exact value), the larger
        spread = own_spread(run, got, 1e-6)
        for what in ("mu", "nu"):
            for k in names:
                assert rel_err(got[what][k], ref[what][k]) <= max(
                    1e-3, 2 * spread[what][k]), (what, k)
    else:
        assert worst(names, got["mu"], ref["mu"]) <= 1e-3
        assert worst(names, got["nu"], ref["nu"]) <= 1e-3
    assert worst(names, got["params"], ref["params"]) <= 1e-4


def test_g_phase_matches_jax(run):
    tr, b = run["tr"], run["batch"]
    # against JAX's updated D, so the G phase is compared on its own
    tr.disc.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, run["d_out"].params), tr.disc))
    if run["mode"] == "adaptive":
        # and at the p JAX's D phase left
        tr.ada_state = ADAState(*(T(np.asarray(v))
                                  for v in run["ada_after"]))
    m = tr.g_phase(b["low"], b["real"], b["clean"], b["feats"],
                   run["draws_g"])
    assert tr.g_state.step == 1
    keys = ("g", "gan", "percept") + (("ada_p",) if run["mode"] else ())
    for k in keys:
        assert rel_err(m[k], run["g_m"][k]) <= 1e-4, k
    assert float(m["id"]) == 0.0
    names, got, ref = adam_moments(tr.g_state, run["g_out"], tr.gen)
    gains = [k for k in names if k.endswith("noise.weight")]
    assert worst([k for k in names if k not in gains], got["mu"],
                 ref["mu"]) <= 1e-3
    # the scalar noise gains, each a sum over a whole map (cancellation),
    # as one vector
    assert rel_err(torch.cat([got["mu"][k] for k in gains]),
                   torch.cat([ref["mu"][k] for k in gains])) <= 1e-3
    # Adam's first step moves each element by about lr along the sign of
    # its gradient; where the gradient is float noise the sign may differ
    lr = tr.cfg.lr
    assert max(float((got["params"][k].detach() - ref["params"][k]).abs()
                     .max())
               for k in names) <= 2.0 * lr
    ema = state_dict_from_jax(jax.tree.map(np.asarray, run["ema_out"]),
                              tr.g_ema)
    assert max(rel_err(v, ema[k]) for k, v in
               tr.g_ema.state_dict().items()) <= 1e-5
    # only G trains in the G phase
    assert all(p.grad is None for p in tr.disc.parameters())


def test_dropout_mask_statistics():
    """The port's keep mask: keep probability 0.5, kept units scaled by 2
    (flax's Dropout(0.5) in training)."""
    pipe = RestorationPipeline(**CFG)
    g = pipe.generator
    keep = g.draw_dropout_mask(4096, torch.Generator().manual_seed(0))
    assert keep.shape == (4096, g.global_dim) and keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - 0.5) < 0.01
    x = torch.randn(4, g.global_dim)
    out = torch.where(keep[:4], x / 0.5, torch.zeros_like(x))
    assert torch.equal(out[keep[:4]], 2 * x[keep[:4]])
