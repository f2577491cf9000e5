"""One step of each trainer at packed_min_res > 0 in the PyTorch port
against the JAX trainers at the same threshold, on the CPU (the small
config of tests/test_torch_packed.py: size 32, decoder 64, channel_div 8,
packed_min_res 8, every level from 8 up packed). Kept apart from
tests/test_torch_packed.py so that each file stays within its share of the
test lane: these two compile the JAX trainers.

Tolerances are those of the unpacked steps' tests, given with each test.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.models.layers import init_module  # noqa: E402

from test_torch_packed import (  # noqa: E402
    PMRS,
    SIZE,
    T,
    _pipe_cfg,
    _port_pipeline,
    _tree_of,
    rel_err,
)


def test_stage2_step_packed():
    """One stage-2 loss and gradient at pmr 8 (the decode through the
    packed decoder, gradients flowing back through it) against the JAX
    trainer at the same pmr: metrics and the diffuser's gradients within
    4x JAX's own spread under +-1e-6 input moves, as
    tests/test_torch_train.py holds the unpacked step (the random-init
    DDPM chain amplifies rounding)."""
    from test_torch_train import PERTURB, assert_within_spread
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline
    from vspbfr_tpu.train.diffuser_train import (
        DiffuserTrainConfig as JaxConfig,
        DiffuserTrainer as JaxTrainer,
    )
    from vspbfr_tpu_torch.train.diffuser_train import (
        DiffuserTrainConfig,
        DiffuserTrainer,
    )

    pmr, b = PMRS[1], 2
    # JAX without remat (half the compile), the port with it (f32's
    # default): remat changes the schedule, not the math
    jtr = JaxTrainer(JaxConfig(size=SIZE, batch=b, id_weight=0.0,
                               remat=False),
                     JaxPipeline(packed_min_res=pmr, **_pipe_cfg()))
    tr = DiffuserTrainer(DiffuserTrainConfig(size=SIZE, batch=b,
                                             id_weight=0.0),
                         _port_pipeline(pmr))
    init_module(tr.lpips, torch.Generator().manual_seed(1))
    st_sh, fr_sh = jax.eval_shape(jtr.init_states, jax.random.key(0))
    diff = _tree_of(tr.diffuser, st_sh.params)
    frozen = {"psp": _tree_of(tr.psp, fr_sh["psp"]),
              "lpips": _tree_of(tr.lpips, fr_sh["lpips"]), "id": {}}
    rng = np.random.default_rng(4)
    low, real = (rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
                 for _ in range(2))
    key = jax.random.key(5)
    step = jax.jit(jtr._loss_and_grads)
    _, m_r, g_r = step(diff, frozen, jnp.asarray(low), jnp.asarray(real),
                       key)
    perturbed = [step(diff, frozen, jnp.asarray(low * np.float32(f)),
                      jnp.asarray(real), key) for f in PERTURB]
    k_noise, _ = jax.random.split(key)
    init_noise = np.asarray(jax.random.normal(k_noise, (b, 10, 512)))
    draws = tr.draw(b, torch.Generator().manual_seed(0))
    assert [tuple(n.shape) for n in draws["noise"]][-1] == (b, 32, 32, 4)
    draws["init_noise"] = T(init_noise)
    _, m = tr.loss_and_grads(T(low), T(real), draws)
    for k in ("l1", "kl", "percept"):
        assert_within_spread([m[k]], [m_r[k]], [[p[1][k]] for p in perturbed],
                             k)
    names = [k for k, _ in tr.diffuser.named_parameters()]
    got = [p.grad for _, p in tr.diffuser.named_parameters()]
    ref, *refs2 = (state_dict_from_jax(jax.tree.map(np.asarray, g),
                                       tr.diffuser)
                   for g in [g_r] + [p[2] for p in perturbed])
    assert_within_spread(got, [ref[k] for k in names],
                         [[r2[k] for k in names] for r2 in refs2], "grads")


def test_stage3_step_packed():
    """The G update of a stage-3 step at pmr 8 against the JAX trainer's
    G phase at the same pmr, as tests/test_torch_restore_train.py holds
    the unpacked step: RestoreNet's forward and backward through its
    packed levels, on the port's frozen embedding (the packed decoder
    features, handed to JAX) and JAX's generator draws (the packed noise
    maps as flax drew them), D at its seeded weights. Metrics <= 1e-4 of
    |jax|, G's Adam moments <= 1e-3 per tensor (the noise gains as one
    vector), G's parameters within 2 lr, g_ema <= 1e-5. The D half of the
    step meets the packed layout only through G's forward, which the G
    phase holds; compiling JAX's D phase (with R1's double backward) would
    double the test's time."""
    from test_torch_restore_train import (
        adam_moments,
        compile_all,
        draw_recorder,
        jax_draws,
        worst,
    )
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline
    from vspbfr_tpu.train.restore_train import (
        RestoreTrainConfig as JaxConfig,
        RestoreTrainer as JaxTrainer,
    )
    from vspbfr_tpu.train.state import TrainState as JaxState
    from vspbfr_tpu_torch.train.restore_train import (
        RestoreTrainConfig,
        RestoreTrainer,
    )

    pmr, b = PMRS[1], 2
    tr = RestoreTrainer(RestoreTrainConfig(size=SIZE, batch=b,
                                           id_weight=0.0),
                        _port_pipeline(pmr))
    for name in ("lpips", "disc", "generator"):
        init_module(tr.modules[name], torch.Generator().manual_seed(2))
    with torch.no_grad():   # G and D off their init (noise gains nonzero)
        for m in (tr.gen, tr.disc):
            for t in m.parameters():
                t.add_(torch.randn(t.shape, generator=torch.Generator()
                                   .manual_seed(t.numel())) * 0.05)
    tr.sync_ema()
    jtr = JaxTrainer(JaxConfig(size=SIZE, batch=b, id_weight=0.0,
                               remat=False),
                     JaxPipeline(packed_min_res=pmr, **_pipe_cfg()))
    g_sh, d_sh, _, fr_sh = jax.eval_shape(jtr.init_states, jax.random.key(0))
    g_params = _tree_of(tr.gen, g_sh.params)
    frozen = {name: _tree_of(tr.modules[name], fr_sh[name])
              for name in ("psp", "diffuser", "lpips")}
    frozen["id"] = {}
    g_state = JaxState.create(g_params, jtr.g_tx)
    d_params = _tree_of(tr.disc, d_sh.params)
    rng = np.random.default_rng(3)
    low, real = (rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
                 for _ in range(2))
    clean, feats = tr.embedding(T(low), tr.draw(
        b, torch.Generator().manual_seed(0))["embed"])
    assert feats[-1].shape == (b, SIZE // 2, SIZE // 2, 4 * 64)  # packed
    clean, feats = jnp.asarray(clean.numpy()), [jnp.asarray(f.numpy())
                                                 for f in feats]
    low, real = jnp.asarray(low), jnp.asarray(real)
    k_g = jax.random.key(4)
    g_args = (g_state, g_params, d_params, frozen, low, real, clean, feats,
              k_g)
    g_fn, rec_fn = compile_all([
        (jax.jit(jtr.g_phase), g_args),
        (draw_recorder(jtr), (g_params, low, feats, clean,
                              jax.random.split(k_g)[0]))])
    g_out, ema_out, g_m = g_fn(*g_args)
    draws = jax_draws(rec_fn, g_params, low, feats, clean,
                      jax.random.split(k_g)[0])
    assert [tuple(n.shape) for n in draws["noise"]] == \
        tr.gen.noise_shapes(b)
    m = tr.g_phase(T(np.asarray(low)), T(np.asarray(real)),
                   T(np.asarray(clean)), [T(np.asarray(f)) for f in feats],
                   draws)
    for k in ("g", "gan", "percept"):
        assert rel_err(m[k], g_m[k]) <= 1e-4, k
    names, got, ref = adam_moments(tr.g_state, g_out, tr.gen)
    gains = [k for k in names if k.endswith("noise.weight")]
    assert worst([k for k in names if k not in gains], got["mu"],
                 ref["mu"]) <= 1e-3
    assert rel_err(torch.cat([got["mu"][k] for k in gains]),
                   torch.cat([ref["mu"][k] for k in gains])) <= 1e-3
    assert max(float((got["params"][k].detach() - ref["params"][k]).abs()
                     .max()) for k in names) <= 2.0 * tr.cfg.lr
    ema = state_dict_from_jax(jax.tree.map(np.asarray, ema_out), tr.g_ema)
    assert max(rel_err(v, ema[k]) for k, v in
               tr.g_ema.state_dict().items()) <= 1e-5
