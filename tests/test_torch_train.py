"""Stage-2 training in the port against the JAX package, on the CPU.

The tiny config (size 32, decoder 64, encode 64, one-unit IR-SE body,
channel_div 8, unpacked layout) with the same parameters on both sides (the
flax tree through `state_dict_from_jax`), the same DDPM noise (the JAX
key split of `_loss_and_grads`, handed to the port as draws) and noise
gains zero (their init), so the decoder's noise streams, which the two
frameworks cannot share, do not enter. The random-init diffuser's
spatial-attention q/k kernels are sharpened x4 on both sides, as in
tests/test_torch_pipeline.py, to make the chain well conditioned.

Tolerances: the decoder's gradient with respect to the W+ code <= 1e-4
of max |jax| (f32). The random-init DDPM chain amplifies rounding even
sharpened: JAX's own chain output moves by ~4e-3 and its diffuser
gradients by ~5e-2 of their max for a 1e-6 relative change of the input
image (measured on the CPU). So the chain, the loss terms and the
diffuser's gradients are held to JAX as closely as JAX agrees with itself:
the port's error (max |port - jax| / max |jax|, per tensor, worst tensor)
<= 4 x JAX's own spread under input changes of +-1e-6 (+ 1e-6); measured,
the port's error is 0.1-2x that spread. Adam vs optax
<= 1e-6. grad_accum=2 vs the full batch runs the port in float64, where
the chain's amplification leaves ~1e-9: <= 1e-7.
"""

import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vspbfr_tpu.models.e4e import TINY_STAGES  # noqa: E402
from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline  # noqa: E402
from vspbfr_tpu.train.diffuser_train import (  # noqa: E402
    DiffuserTrainConfig as JaxConfig,
    DiffuserTrainer as JaxTrainer,
)
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.diffusion import LatentDDPM  # noqa: E402
from vspbfr_tpu_torch.pipeline import RestorationPipeline  # noqa: E402
from vspbfr_tpu_torch.train import TrainState, ema_update, make_adam  # noqa: E402
from vspbfr_tpu_torch.train.diffuser_train import (  # noqa: E402
    DiffuserTrainConfig,
    DiffuserTrainer,
)

CFG = dict(size=32, decoder_size=64, encode_size=64,
           encoder_stages=TINY_STAGES, channel_div=8)
B = 2


def assert_rel(port, ref, rel):
    port = np.asarray(port.detach().float(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= rel, f"max rel err {err:.3e} > {rel}"


@pytest.fixture(scope="module")
def setup():
    """JAX trainer state and the port trainer loaded with the same
    weights (id_weight 0: the ID net has its own test)."""
    jpipe = JaxPipeline(packed_min_res=0, **CFG)
    jtr = JaxTrainer(JaxConfig(size=32, batch=B, id_weight=0.0), jpipe)
    state, frozen = jax.jit(jtr.init_states)(jax.random.key(0))
    diff = jax.tree.map(np.asarray, state.params)
    for blk in diff.values():
        for name in ("q", "k"):
            blk["attention_layer"][name]["kernel"] = (
                blk["attention_layer"][name]["kernel"] * 4.0)
    frozen = jax.tree.map(np.asarray, frozen)
    return jtr, diff, frozen


def port_trainer(setup, **kw):
    _, diff, frozen = setup
    tr = DiffuserTrainer(DiffuserTrainConfig(size=32, batch=B, id_weight=0.0,
                                             **kw),
                         RestorationPipeline(**CFG))
    for name, tree in (("psp", frozen["psp"]), ("diffuser", diff),
                       ("lpips", frozen["lpips"])):
        m = tr.modules[name]
        m.load_state_dict(state_dict_from_jax(tree, m))
    return tr


def rel_err(a, b) -> float:
    a = np.asarray(a.detach().double() if hasattr(a, "detach") else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def assert_within_spread(port, ref, refs2, what):
    """port vs ref within 4x the spread around ref of refs2 (JAX at inputs
    scaled by 1 +- 1e-6); port and ref are lists of matching tensors, refs2
    a list of such lists."""
    err = max(rel_err(a, b) for a, b in zip(port, ref))
    spread = max(rel_err(c, b) for r2 in refs2 for c, b in zip(r2, ref))
    assert err <= 4 * spread + 1e-6, (what, err, spread)


PERTURB = (1 + 1e-6, 1 - 1e-6)


def batch(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
            for _ in range(2)]


def zero_noise(tr, b):
    """The decoder's noise maps, zeroed (their gains are zero anyway)."""
    return [torch.zeros_like(n) for n in tr.draw(b, None)["noise"]]


def test_get_w_plus_is_a_gradient_boundary():
    """As the JAX `stop_gradient`: no graph comes out of the encode, so a
    stage-2 loss through the decode reaches neither the image nor any
    encoder parameter (which here still require grad)."""
    pipe = RestorationPipeline(**CFG).init_from_seed(0)
    img = torch.rand(B, 32, 32, 3, requires_grad=True)
    lat = pipe.psp.get_w_plus(img)
    assert not lat.requires_grad and lat.grad_fn is None
    code = (lat * 1.0).requires_grad_()
    loss = pipe.psp.decode(code, generator=torch.Generator().manual_seed(0))
    loss.square().mean().backward()
    assert code.grad is not None and torch.isfinite(code.grad).all()
    assert img.grad is None
    assert all(p.grad is None for p in pipe.psp.encoder.parameters())


def test_decoder_grad_wrt_code_matches_jax(setup):
    jtr, _, frozen = setup
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 10, 512)).astype(np.float32)
    w = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)

    def f(c):
        img = jtr.pipe.psp.decode(frozen["psp"], c,
                                  noise_rng=jax.random.key(2))
        return jnp.sum(img * jnp.asarray(w))

    ref = jax.jit(jax.grad(f))(jnp.asarray(lat))
    tr = port_trainer(setup)
    code = torch.tensor(lat, requires_grad=True)
    img = tr.psp.decode(code, noise=zero_noise(tr, 1))
    (img * torch.tensor(w)).sum().backward()
    assert_rel(code.grad, ref, 1e-4)


def test_training_chain_matches_jax(setup):
    jtr, diff, _ = setup
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 10, 512)).astype(np.float32)
    noise = rng.standard_normal((B, 10, 512)).astype(np.float32)
    ddpm = jtr.pipe.ddpm(diff)
    _, chain_r = ddpm.training_chain(jnp.asarray(x), jnp.asarray(x),
                                     jnp.asarray(noise))
    chains2 = []
    for f in PERTURB:
        x2 = jnp.asarray(x * np.float32(f))
        chains2.append(ddpm.training_chain(x2, x2, jnp.asarray(noise))[1])
    tr = port_trainer(setup)
    final, chain = LatentDDPM(tr.diffuser, tr.pipe.schedule).training_chain(
        torch.tensor(x), torch.tensor(x), torch.tensor(noise))
    assert len(chain) == len(chain_r) == 5
    assert rel_err(chain[0], chain_r[0]) <= 1e-6   # q_sample
    for i in range(1, 5):
        assert_within_spread([chain[i]], [chain_r[i]],
                             [[c2[i]] for c2 in chains2], f"step {i}")
    assert torch.equal(final, chain[-1])


def test_diffuser_step_matches_jax_loss_and_grads(setup):
    jtr, diff, frozen = setup
    low, real = batch(4)
    key = jax.random.key(5)
    step = jax.jit(jtr._loss_and_grads)
    _, m_r, g_r = step(diff, frozen, jnp.asarray(low), jnp.asarray(real),
                       key)
    perturbed = [step(diff, frozen, jnp.asarray(low * np.float32(f)),
                      jnp.asarray(real), key) for f in PERTURB]
    k_noise, _ = jax.random.split(key)
    init_noise = np.asarray(jax.random.normal(k_noise, (B, 10, 512)))

    tr = port_trainer(setup)
    draws = {"init_noise": torch.tensor(init_noise),
             "noise": zero_noise(tr, B)}
    loss, m = tr.loss_and_grads(torch.tensor(low), torch.tensor(real), draws)
    for k in ("l1", "kl", "percept"):
        assert_within_spread([m[k]], [m_r[k]], [[p[1][k]] for p in perturbed],
                             k)
    assert float(m["id"]) == 0.0
    assert float(loss) == float(m["l1"] + m["percept"])
    names = [k for k, _ in tr.diffuser.named_parameters()]
    got = [p.grad for _, p in tr.diffuser.named_parameters()]
    assert all(g is not None for g in got)
    ref, *refs2 = (
        state_dict_from_jax(jax.tree.map(np.asarray, g), tr.diffuser)
        for g in [g_r] + [p[2] for p in perturbed])
    assert set(ref) == set(names)
    assert_within_spread(got, [ref[k] for k in names],
                         [[r2[k] for k in names] for r2 in refs2], "grads")
    # only the diffuser trains
    for name in ("psp", "lpips", "id"):
        assert all(p.grad is None for p in tr.modules[name].parameters())


def test_grad_accum_matches_the_full_batch_step(setup):
    """One update from 2 microbatches == one from the whole batch, on the
    same draws, in float64: Adam with beta1 = 0 keeps the step's gradient
    as its first moment, which is compared."""
    low, real = (torch.tensor(a, dtype=torch.float64) for a in batch(6))
    init_noise = torch.randn(B, 10, 512, dtype=torch.float64,
                             generator=torch.Generator().manual_seed(7))
    moments, metrics = [], []
    for accum in (1, 2):
        tr = port_trainer(setup, grad_accum=accum).to(torch.float64)
        draws = {"init_noise": init_noise, "noise": zero_noise(tr, B)}
        metrics.append(tr.train_step(low, real, draws=draws))
        assert tr.state.step == 1
        moments.append([tr.state.opt.state[p]["exp_avg"]
                        for p in tr.diffuser.parameters()])
    for k in metrics[0]:
        assert rel_err(metrics[1][k], metrics[0][k]) <= 1e-7, k
    assert max(rel_err(a, b) for a, b in zip(*moments)) <= 1e-7


def test_adam_matches_optax():
    rng = np.random.default_rng(8)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = optax.adam(0.002 * 0.8, b1=0.0, b2=0.99 ** 0.8)
    params = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   params)
        params = optax.apply_updates(params, upd)

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                     for k, v in p0.items()})
    state = TrainState(module, 0.002, reg_every=4)
    for g in grads:
        for k, p in module.items():
            p.grad = torch.tensor(g[k])
        state.apply_gradients()
    assert state.step == 3
    for k, p in module.items():
        assert_rel(p, params[k], 1e-6)
        assert p.grad is None
    opt = make_adam(module.parameters(), 1.0, None)
    assert opt.defaults["lr"] == 1.0 and opt.defaults["betas"] == (0.0, 0.99)


def test_ema_update():
    a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in a.parameters():
            p.fill_(1.0)
        for p in b.parameters():
            p.zero_()
    ema_update(a, b, decay=0.9)
    assert all(torch.allclose(p, torch.full_like(p, 0.9))
               for p in a.parameters())


def _faces(tmp_path, n=4, size=32):
    rng = np.random.default_rng(9)
    d = tmp_path / "faces"
    d.mkdir()
    for i in range(n):
        np.save(d / f"f{i}.npy",
                (rng.random((size, size, 3)) * 255).astype(np.uint8))
    return str(d)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """Two steps and a checkpoint, then a resume that continues at the
    saved iteration and ends where an uninterrupted three-step run ends."""
    from vspbfr_tpu_torch.cli import train_diffuser as cli
    from vspbfr_tpu_torch.utils import load_checkpoint

    path = _faces(tmp_path)
    base = ["--path", path, "--device", "cpu", "--tiny", "--size", "32",
            "--decoder_size", "64", "--batch", "2", "--id_loss_weight", "0",
            "--show_inter", "2", "--save_inter", "2"]
    a = str(tmp_path / "a")
    rep = cli.main(base + ["--iter", "2", "--out", a])
    assert rep["start_iter"] == 0 and rep["iter"] == 2
    assert len(rep["steps"]) == 2
    for s in rep["steps"]:
        assert all(np.isfinite(s[k]) for k in ("loss", "l1", "kl", "percept"))
    ck_path = tmp_path / "a" / "checkpoint" / "code_diffuser.pt"
    ck = load_checkpoint(str(ck_path))
    assert ck["iter"] == 2 and ck["step"] == 2
    assert (tmp_path / "a" / "checkpoint" / "psp.pt").is_file()
    assert any((tmp_path / "a" / "samples").iterdir())

    rep = cli.main(base + ["--iter", "3", "--out", a, "--ckpt",
                           str(ck_path)])
    assert rep["start_iter"] == 2 and rep["iter"] == 3
    assert len(rep["steps"]) == 1
    b = str(tmp_path / "b")
    straight = cli.main(base + ["--iter", "3", "--out", b, "--save_inter",
                                "3"])
    assert straight["steps"][-1]["loss"] == pytest.approx(
        rep["steps"][-1]["loss"], rel=1e-6)
    # ~0.7 GB of checkpoints at the tiny config; pytest keeps every test's
    # directory to the end of the session (and three sessions), so they go
    # once checked (as tests/test_torch_restore_cli.py's)
    shutil.rmtree(tmp_path)
