"""Training on the port's 2-D data x model mesh (`vspbfr_tpu_torch/
parallel/`) on the CPU: gradients through H-sharded maps.

In this process, with the ranks as threads of it (`ThreadRows`, the
stand-in exchanger of `tests/test_torch_sharding2d.py`, plus the sum the
gradients need), at n = 2 and 4 on a 32-row map:
- `window` (sharded rows, symmetric and lopsided halos), `gather`,
  `rows_op` (from sharded and from whole rows) and `own`: each rank's
  gradient of its rows equals the unsharded op's gradient's own rows; a
  replicated input's gradient equals the unsharded one on every rank; a
  replicated weight read on the rows through `Spatial.summed` gets the
  whole gradient, without it only its rows' part;
- a double backward through an exchange raises.

With real gloo ranks, one 1 data x 2 model run (this file as the ranks'
program, launched once for the file; the lone steps computed here while
the ranks run, at the ranks' one intra-op thread), each rank against the
lone step on the same weights, batch and draws, every parameter's
gradient that Adam takes (the rank's slice of a model-sharded one,
gathered) within 1e-5 of each tensor's max:
- stage 2 at the tiny config (size 32, decoder 64) with the LPIPS and ID
  terms (weights 0.1), so the loss reaches the codes through the
  H-sharded decode: the decoder and the diffuser from the JAX package's
  init (`state_dict_from_jax`; the diffuser's attention q/k x4 as
  `tests/test_torch_train.py` conditions its chain), the encoder, LPIPS
  and ID seeded;
  in float64, as that file's grad_accum test runs, since the random-init
  chain's backward grows f32 rounding of the codes' gradient (its row
  parts add in another order) to ~1e-5 of a tensor's max;
- stage 3 (D update, lazy R1 at step 0, G update) with ADA at p 0.5 on
  half widths (`channel_div` 2: 256 channels at 16 and 32 px, so G's
  model-sharded weights sit in layers on rows and their reduce-scatter
  runs), seeded: the gradients of D's, R1's and G's updates; the losses
  (rtol 1e-5).
The lone steps are held to the JAX trainers by
`tests/test_torch_train.py` and `tests/test_torch_restore_train.py`.
"""

import os
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vspbfr_tpu_torch.parallel import Spatial  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300        # seconds the gloo run may take
GROUP_TIMEOUT = 120       # the process group's timeout, seconds
TOL = 1e-5                # of each gradient's max
STAGE2 = dict(size=32, decoder_size=64)
STAGE3 = dict(size=32, decoder_size=64, channel_div=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the lone steps must run at the gloo ranks' one
    thread (equal work, equal bits in the replicated parts), and the lane
    runs six files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


# -- (i) the exchanges' gradients, ranks as threads ---------------------------

class ThreadRows:
    """Rank `rank` of `hub.n` threads of this process: `all_gather` meets
    the others at a barrier; `all_reduce` sums their tensors in rank
    order (the same bits on every rank)."""

    def __init__(self, hub, rank):
        self.hub, self.rank, self.size = hub, rank, hub.n

    def all_gather(self, t):
        hub = self.hub
        hub.slots[self.rank] = t
        hub.barrier.wait()
        out = list(hub.slots)
        hub.barrier.wait()
        return out

    def all_reduce(self, t):
        parts = self.all_gather(t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out


def run_threads(n, fn):
    """fn(Spatial) on n thread ranks (gradients on); their results in rank
    order."""
    hub = types.SimpleNamespace(n=n, slots=[None] * n,
                                barrier=threading.Barrier(n, timeout=120))
    out, errors = [None] * n, []

    def go(r):
        try:
            out[r] = fn(Spatial(ThreadRows(hub, r)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RANK_TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _rows_conv(x, taps, top, bottom, pads_h):
    """y[i] = sum_d taps[d] x[i - top + d] per column and channel, H
    padded by pads_h: a shift-equivariant op reading `top` rows above and
    `bottom` below."""
    c = x.shape[-1]
    k = taps.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    xn = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 0) + pads_h)
    return torch.nn.functional.conv2d(xn, k, groups=c).permute(0, 2, 3, 1)


def _case(seed, h=32, c=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, h, h, c), generator=g, dtype=torch.float64)
    return x, g


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("top,bottom", [(1, 1), (3, 2), (8, 8)])
def test_window_and_gather_gradients(n, top, bottom):
    """x's rows -> window -> an op on the window (no H padding) -> gather
    -> a replicated loss: each rank's gradient of its rows is the
    unsharded gradient's own rows."""
    x, g = _case(top * 10 + bottom)
    taps = torch.randn(top + bottom + 1, generator=g, dtype=torch.float64)
    probe = torch.randn(x.shape, generator=g, dtype=torch.float64)
    xw = x.clone().requires_grad_(True)
    (_rows_conv(xw, taps, top, bottom, (top, bottom)) * probe).sum(
    ).backward()

    def rank(sp):
        mine = x[:, sp.own_rows(32)].clone().requires_grad_(True)
        out = sp.gather(_rows_conv(sp.window(mine, top, bottom), taps, top,
                                   bottom, (0, 0)))
        (out * probe).sum().backward()
        return mine.grad, sp.exchanges

    for r, (grad, exchanges) in enumerate(run_threads(n, rank)):
        h = 32 // n
        assert _rel(grad, xw.grad[:, r * h:(r + 1) * h]) <= 1e-12
        assert exchanges == 3       # the halo, the gather, the halo back


@pytest.mark.parametrize("n", [2, 4])
def test_rows_op_own_and_summed_gradients(n):
    """`rows_op` (the ToRGB skip's 2x FIR upsample) from a whole 8-row map
    to sharded rows and on sharded rows, `own` of a replicated map, and a
    replicated weight on the rows through `Spatial.summed`: the
    replicated inputs' gradients equal the unsharded ones on every rank;
    without `summed` the weight's gradient is only the rank's part."""
    from vspbfr_tpu_torch.models.layers import BLUR_KERNEL
    from vspbfr_tpu_torch.ops import upsample2d

    # whole at 4n rows (4 a rank), sharded from 8n (8 a rank)
    small, g = _case(7, h=4 * n)
    big, _ = _case(8, h=8 * n)
    w = torch.randn(3, generator=g, dtype=torch.float64)
    probe = torch.randn((2, 16 * n, 16 * n, 3), generator=g,
                        dtype=torch.float64)

    def up(t):
        return upsample2d(t, BLUR_KERNEL)

    def net(s, b, wt, sp=None):
        """up(up(s) + b * w): s whole, up(s) and b sharded."""
        if sp is None:
            return up(up(s) + b * wt)
        hs = sp.rows_op(s, up, 1, 2)
        mid = hs + sp.own(b) * wt
        return sp.gather(sp.rows_op(mid, up, 1, 2))

    leaves = [t.clone().requires_grad_(True) for t in (small, big, w)]
    (net(*leaves) * probe).sum().backward()
    want = [t.grad for t in leaves]

    def rank(sp, summed=True):
        mine = [t.clone().requires_grad_(True) for t in (small, big, w)]
        wt = sp.summed(mine[2]) if summed else mine[2]
        (net(mine[0], mine[1], wt, sp) * probe).sum().backward()
        return [t.grad for t in mine]

    # the FIR passes compute in f32 (`upfirdn2d_separable`)
    for grads in run_threads(n, rank):
        for got, ref in zip(grads, want):
            assert _rel(got, ref) <= 1e-6
    parts = run_threads(n, lambda sp: rank(sp, summed=False))
    assert _rel(parts[0][2], want[2]) > 0.05
    assert _rel(sum(p[2] for p in parts), want[2]) <= 1e-6


def test_double_backward_through_an_exchange_raises():
    """R1's double backward never crosses a halo; one that did would
    raise, not return a wrong value."""
    x, g = _case(3)
    taps = torch.randn(3, generator=g, dtype=torch.float64)

    def rank(sp):
        mine = x[:, sp.own_rows(32)].clone().requires_grad_(True)
        out = sp.gather(_rows_conv(sp.window(mine, 1, 1), taps, 1, 1,
                                   (0, 0)))
        (gx,) = torch.autograd.grad(out.square().sum(), mine,
                                    create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable|twice"):
            gx.square().sum().backward()
        return True

    assert run_threads(2, rank) == [True, True]


def _layer_cases():
    """(name, make layer, input resolution, output resolution, style
    width or None): every form a layer on rows takes in the decoder and
    RestoreNet, at n = 2 (sharded from 16 px)."""
    from vspbfr_tpu_torch.models.layers import (LargeConvLayer, SMARTLayer,
                                                StyledConv, ToRGB)

    return [
        ("styled conv (K1)", lambda: StyledConv(8, 8, 12), 16, 16),
        ("up-conv from whole (K1 + K3)",
         lambda: StyledConv(8, 8, 12, upsample=True), 8, 16),
        ("up-conv, transposed (c_out 128)",
         lambda: StyledConv(8, 128, 12, upsample=True), 8, 16),
        ("down-conv on rows", lambda: StyledConv(8, 8, 12, downsample=True),
         32, 16),
        ("down-conv to whole", lambda: StyledConv(8, 8, 12,
                                                  downsample=True), 16, 8),
        ("SMART (K2)", lambda: SMARTLayer(8, 8, 12), 16, 16),
        ("ToRGB with a whole skip", lambda: ToRGB(8, 12), 16, 16),
        ("LargeConv 3x3, dilation 8", lambda: LargeConvLayer(8, 8, 3), 32,
         32),
    ]


@pytest.mark.parametrize("case", range(8))
def test_layers_on_rows_match_unsharded_gradients(case):
    """Each layer form on this rank's rows (`Spatial.layer`, its style code
    through `Spatial.summed`, its replicated parameters' row parts summed
    by `sum_partial_grads`), noise gains 0.1 with explicit noise, two
    thread ranks: the output and, on every rank, the gradients of the
    input (its rows where sharded, whole where whole), the style code and
    every parameter equal the unsharded layer's (1e-5 of each one's max:
    the FIR passes compute in f32)."""
    import copy

    from vspbfr_tpu_torch.models.layers import (LargeConvLayer, SMARTLayer,
                                                ToRGB, init_module)

    name, make, r_in, r_out = _layer_cases()[case]
    gen = torch.Generator().manual_seed(case)
    layer = init_module(make(), gen).double()
    _noise_gains(layer)
    styled = not isinstance(layer, LargeConvLayer)
    c_in = 8
    x = torch.randn((2, r_in, r_in, c_in), generator=gen,
                    dtype=torch.float64)
    style = torch.randn((2, 12), generator=gen, dtype=torch.float64)
    noise = torch.randn((2, r_out, r_out, 1), generator=gen,
                        dtype=torch.float64)
    skip = torch.randn((2, r_out // 2, r_out // 2, 3), generator=gen,
                       dtype=torch.float64)

    def call(mod, xs, st, sp=None):
        kw = {} if sp is None else {"spatial": sp}
        if isinstance(mod, ToRGB):
            return mod(xs, st, skip, **kw)
        if isinstance(mod, LargeConvLayer):
            return mod(xs, **kw)
        if isinstance(mod, SMARTLayer):
            return mod(xs, st, noise=noise, **kw)
        return mod(xs, st, noise=noise, **kw)

    leaves = [x.clone().requires_grad_(True),
              style.clone().requires_grad_(True)]
    out = call(layer, *leaves)
    probe = torch.randn(out.shape, generator=gen, dtype=torch.float64)
    (out * probe).sum().backward()
    want = {"x": leaves[0].grad, "style": leaves[1].grad,
            **{n: p.grad for n, p in layer.named_parameters()}}

    def rank(sp):
        mine = copy.deepcopy(layer)
        mine.zero_grad(set_to_none=True)
        xs = x.clone().requires_grad_(True)
        st = style.clone().requires_grad_(True)
        with sp.layer(mine, r_in, r_out) as rows:
            assert rows
            y = sp.gather(call(mine, sp.own(xs), sp.summed(st), sp))
        (y * probe).sum().backward()
        sp.sum_partial_grads(mine)
        got = {"x": xs.grad, "style": st.grad,
               **{n: p.grad for n, p in mine.named_parameters()}}
        return y.detach(), got

    for y, got in run_threads(2, rank):
        assert _rel(y, out.detach()) <= 1e-5, name
        for k, w in want.items():
            if not styled and k == "style":
                continue
            g = torch.zeros_like(w) if got[k] is None else got[k]
            assert _rel(g, w) <= 1e-5, (name, k)


# -- (ii) real gloo ranks: stage 2 and stage 3 on a 1 x 2 mesh ----------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _noise_gains(module, value=0.1):
    with torch.no_grad():
        for k, v in module.named_parameters():
            if k.endswith("noise.weight"):
                v.fill_(value)


def _stage2_trainer(packed_min_res=0):
    """The stage-2 trainer at the tiny config, LPIPS and ID on."""
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    pipe = RestorationPipeline(encode_size=64, encoder_stages=TINY_STAGES,
                               channel_div=8, packed_min_res=packed_min_res,
                               **STAGE2)
    return DiffuserTrainer(DiffuserTrainConfig(
        size=STAGE2["size"], batch=2, percept_weight=0.1, id_weight=0.1),
        pipe)


def _stage3_trainer(packed_min_res=0):
    """The stage-3 trainer at half widths, ADA at p 0.5."""
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    pipe = RestorationPipeline(encode_size=64, encoder_stages=TINY_STAGES,
                               packed_min_res=packed_min_res, **STAGE3)
    return RestoreTrainer(RestoreTrainConfig(
        size=STAGE3["size"], batch=2, augment=True, augment_p=0.5), pipe)


def _stage2_weights() -> dict:
    """The stage-2 modules' state_dicts: the decoder (the loss's path to
    the codes) and the diffuser from the JAX package's init at the same
    config (`state_dict_from_jax`; the diffuser's attention q/k x4), the
    encoder, LPIPS and ID seeded (their weights only make the codes and
    score the image); the decoder's noise gains 0.1."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from vspbfr_tpu.models.e4e import TINY_STAGES as JAX_TINY
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline
    from vspbfr_tpu_torch.convert import state_dict_from_jax
    from vspbfr_tpu_torch.models.layers import init_module

    jp = JaxPipeline(packed_min_res=0, encode_size=64,
                     encoder_stages=JAX_TINY, channel_div=8, **STAGE2)
    dec = jp.psp.decoder
    lat = jnp.zeros((1, dec.n_latent, 512))
    dec_params = jax.jit(lambda k: dec.init(
        {"params": k, "noise": k}, lat)["params"])(jax.random.key(0))
    diff = jax.jit(lambda k: jp.diffuser.init(
        k, lat, lat, jnp.zeros((1,), jnp.int32))["params"])(
        jax.random.key(1))
    diff = jax.tree.map(np.asarray, diff)
    for blk in diff.values():
        for name in ("q", "k"):
            blk["attention_layer"][name]["kernel"] = (
                blk["attention_layer"][name]["kernel"] * 4.0)
    tr = _stage2_trainer()
    gen = torch.Generator().manual_seed(2)
    for m in (tr.psp, tr.lpips, tr.id_net):
        init_module(m, gen)
    tr.psp.decoder.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, dec_params), tr.psp.decoder))
    tr.diffuser.load_state_dict(state_dict_from_jax(diff, tr.diffuser))
    _noise_gains(tr.psp)
    return {k: m.state_dict() for k, m in tr.modules.items()}


def _stage3_weights() -> dict:
    tr = _stage3_trainer().init_from_seed(1)
    _noise_gains(tr.pipe)
    tr.sync_ema()
    return {k: m.state_dict() for k, m in tr.modules.items()}


def _load(tr, weights):
    for k, m in tr.modules.items():
        m.load_state_dict(weights[k])
    return tr


def _faces(seed, size=32):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.uniform(-1, 1, (2, size, size, 3)),
                         dtype=torch.float32) for _ in range(2)]


def _recording(state, names, out: list):
    """Append to `out` the gradients Adam takes at each update of `state`
    (after the reductions, before the step), by parameter name."""
    def hook(opt, *_):
        params = opt.param_groups[0]["params"]
        out.append({n: p.grad.clone() for n, p in zip(names, params)})

    return state.opt.register_step_pre_hook(hook)


def _stage2_step(tr) -> dict:
    grads = []
    names = [n for n, _ in tr.diffuser.named_parameters()]
    if getattr(tr.diffuser, "_model_axis", None):
        names = tr.diffuser._model_axis["names"]
    handle = _recording(tr.state, names, grads)
    draws = tr.draw(2, torch.Generator().manual_seed(5))
    m = tr.train_step(*(x.double() for x in _faces(21)), draws={
        "init_noise": draws["init_noise"].double(),
        "noise": [n.double() for n in draws["noise"]]})
    handle.remove()
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads=grads, modules={"state": tr.diffuser})


def _stage3_step(tr) -> dict:
    d, g = [], []
    hooks = []
    for state, out in ((tr.d_state, d), (tr.g_state, g)):
        mod = state.module
        names = (mod._model_axis["names"]
                 if getattr(mod, "_model_axis", None)
                 else [n for n, _ in mod.named_parameters()])
        hooks.append(_recording(state, names, out))
    m = tr.train_step(*_faces(31), torch.Generator().manual_seed(9))
    for h in hooks:
        h.remove()
    return dict(metrics={k: float(v) for k, v in m.items()}, d=d, g=g)


def _whole(grads: list, module) -> list:
    """The recorded gradients with each model-sharded slice gathered
    whole (collective over the model group)."""
    from vspbfr_tpu_torch.parallel.model_axis import (model_axis,
                                                      sharded_names)

    ax, sharded = model_axis(module), set(sharded_names(module))
    return [{n: ax.gather(v) if n in sharded else v for n, v in g.items()}
            for g in grads]


def _rank(out, weights_file):
    """One rank of the 1 x 2 run: both steps on the mesh; writes its
    record to `out`."""
    from vspbfr_tpu_torch.parallel import create_mesh_2d, distributed
    from vspbfr_tpu_torch.parallel.model_axis import model_axis, sharded_names

    weights = torch.load(weights_file, weights_only=True)
    rec = {}
    with distributed("cpu"):
        mesh = create_mesh_2d(1, 2)
        tr = _load(_stage2_trainer(), weights["stage2"]).to(
            torch.float64).shard_model(mesh)
        s2 = _stage2_step(tr)
        rec["stage2"] = dict(metrics=s2["metrics"],
                             grads=_whole(s2["grads"], tr.diffuser),
                             exchanges=tr.spatial.exchanges,
                             grad_sums=tr.spatial.grad_sums)
        tr = _load(_stage3_trainer(), weights["stage3"]).shard_model(mesh)
        s3 = _stage3_step(tr)
        rec["stage3"] = dict(metrics=s3["metrics"],
                             d=_whole(s3["d"], tr.disc),
                             g=_whole(s3["g"], tr.gen),
                             exchanges=tr.spatial.exchanges,
                             grad_sums=tr.spatial.grad_sums,
                             reduce_scatters=model_axis(
                                 tr.gen).reduce_scatters,
                             g_sharded=sharded_names(tr.gen),
                             export=tr.export_state_dict())
    torch.save(rec, out)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """This file as 2 gloo ranks on a 1 data x 2 model mesh, on weights
    made here once (a file); each rank's record, and the lone steps,
    computed here while the ranks run."""
    out_dir = tmp_path_factory.mktemp("meshtrain")
    weights = {"stage2": _stage2_weights(), "stage3": _stage3_weights()}
    weights_file = os.path.join(out_dir, "weights.pt")
    torch.save(weights, weights_file)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", PYTHONPATH=ROOT)
        out = os.path.join(out_dir, f"rank{r}.pt")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, weights_file],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    logs = []
    try:
        lone = {"stage2": _stage2_step(_load(
                    _stage2_trainer(), weights["stage2"]).to(torch.float64))}
        tr = _load(_stage3_trainer(), weights["stage3"])
        lone["stage3"] = dict(_stage3_step(tr),
                              export=tr.export_state_dict())
        for p, _ in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(out, weights_only=False) for _, out in procs]
    for f in os.listdir(out_dir):      # ~100 MB of weights and records
        os.remove(os.path.join(out_dir, f))
    return ranks, lone


def _worst(got: dict, want: dict) -> tuple[float, str]:
    """(the largest |got - want| over max |want| of any tensor, its
    name)."""
    assert set(got) == set(want)
    return max((float((got[k] - w).abs().max())
                / max(float(w.abs().max()), 1e-6), k)
               for k, w in want.items())


def _metrics_match(got: dict, want: dict):
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=TOL, abs=1e-6), k


def test_gloo_stage2_step_with_sharded_decode(gloo_run):
    """Stage 2 on the 1 x 2 mesh (H-sharded decode with LPIPS and ID,
    model-sharded diffuser and frozen nets) against the lone step: the
    diffuser's gradients within 1e-5 of each one's max, the metrics;
    the backward ran its exchanges and one sum of the codes' parts."""
    ranks, lone = gloo_run
    want = lone["stage2"]
    assert want["metrics"]["percept"] > 0 and want["metrics"]["id"] > 0
    for rk in ranks:
        got = rk["stage2"]
        _metrics_match(got["metrics"], want["metrics"])
        assert len(got["grads"]) == 1
        worst, at = _worst(got["grads"][0], want["grads"][0])
        assert worst <= TOL, (worst, at)
        # forward and backward exchanges: the remat decode runs its
        # forward twice
        assert got["exchanges"] > 20 and got["grad_sums"] == 1


def test_gloo_stage3_step_with_sharded_restorenet(gloo_run):
    """Stage 3 with ADA and R1 on the 1 x 2 mesh (H-sharded embedding and
    RestoreNet, model-sharded G, D and g_ema) against the lone step: D's,
    R1's and G's gradients within 1e-5 of each one's max, the metrics;
    G's model-sharded weights in layers on rows were reduce-scattered;
    the unsharded inference export after the step."""
    ranks, lone = gloo_run
    want = lone["stage3"]
    assert want["metrics"]["r1"] > 0
    for rk in ranks:
        got = rk["stage3"]
        _metrics_match(got["metrics"], want["metrics"])
        assert len(got["d"]) == 2 and len(got["g"]) == 1   # D, R1; G
        for part in ("d", "g"):
            for g, w in zip(got[part], want[part]):
                worst, at = _worst(g, w)
                assert worst <= TOL, (part, worst, at)
        assert got["g_sharded"] and got["reduce_scatters"] > 0
        assert got["grad_sums"] >= 3    # encoder, decoder styles; params
        # the inference export after the step: the unsharded tensors, as
        # the lone trainer's: the frozen stages equal, g_ema (its EMA over
        # the slices, gathered) within (1 - decay) x the envelope of a
        # first Adam step, which moves each weight by +-lr_eff (a
        # gradient near 0 moves it by less, in either run)
        lr_eff = 0.002 * 4 / 5
        decay = 0.5 ** (32 / 10_000)
        assert list(got["export"]) == list(want["export"])
        for k, v in want["export"].items():
            if k.startswith("generator."):
                diff = float((got["export"][k] - v).abs().max())
                assert diff <= 2.05 * lr_eff * (1 - decay), k
            else:
                assert torch.equal(got["export"][k], v), k


if __name__ == "__main__":
    import datetime

    from vspbfr_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.DEFAULT_TIMEOUT = datetime.timedelta(seconds=GROUP_TIMEOUT)
    _rank(*sys.argv[1:3])
