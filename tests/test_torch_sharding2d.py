"""The port's 2-D data x model mesh (`vspbfr_tpu_torch/parallel/`) on the
CPU, at `tests/test_sharding2d.py`'s config (size 32, decoder 64, full
widths; the e4e encoder cut to its tiny stages at 64 px, as the port's
other CPU tests cut it).

In this process:
- `model_param_specs` shards exactly the parameters JAX's rule shards
  (port names of the flax leaves of the JAX pipeline's tree);
- the decoder from the JAX package's init (`state_dict_from_jax`) decodes
  as JAX's does, on the same numpy codes and noise;
- the halo logic: the decode and restore stages H-sharded over n = 2 and
  4 ranks against the unsharded port within 2e-4, with a stand-in
  exchanger (the ranks are threads of this process meeting at a barrier;
  no process group), and each shard's conv inputs hold at most H/n + its
  halo rows wherever the map or the conv's output is sharded.

With real gloo ranks, one 2 data x 2 model run (this file as the ranks'
program, launched once for the file on the pipeline this process makes;
half the widths, `GLOO_CFG`), against world 1 at the same global batch,
computed here while the ranks run: the decode and restore stages
H-sharded (2e-4), the model-sharded decoder's forward (5e-4) and
parameter gradients (1e-5 of each one's max), a stage-2 step (metrics
rtol 1e-3; the gradients Adam takes, reduced over the data axis, within
1e-5 of each one's max of the mean of the batch rows' own gradients;
updated parameters within 2.05 x lr_eff of the batch-2 step's, as
`tests/test_sharding2d.py`, with at most 5% of a tensor's elements moved
apart by more than lr_eff: 2.4% measured), Adam's moments at half a
sharded parameter's size, and the checkpoint round trip: a model-sharded
`TrainState`'s checkpoint is the unsharded one's file, byte for byte,
and loads back into shards.
"""

import contextlib
import hashlib
import importlib
import io
import os
import shutil
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.thread_ranks import run_threads  # noqa: E402
from vspbfr_tpu_torch.parallel import (  # noqa: E402
    MIN_ROWS,
    Spatial,
    model_param_specs,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ROOT)
SIZE, DEC = 32, 64
CFG = dict(size=SIZE, decoder_size=DEC, encode_size=64)
# the gloo ranks' config: half the widths (256 channels up to 64 px, so
# the 256-wide rule still shards the decoder's and RestoreNet's convs)
GLOO_CFG = dict(CFG, channel_div=2)
RANK_TIMEOUT = 240        # seconds the gloo run may take
GROUP_TIMEOUT = 120       # the process group's timeout, seconds
LR_EFF = 0.002 * (4 / 5)  # make_adam(lr, reg_every=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: its tensors are small, the lane
    runs six files at once (where an op's thread pool only contends), and
    the world-1 reference must run at the gloo ranks' one thread, so that
    equal work gives equal bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pipeline(cfg=CFG, seed=0):
    """The port pipeline at a config, seeded, noise gains 0.1 (so the
    noise rows count)."""
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    pipe = RestorationPipeline(encoder_stages=TINY_STAGES,
                               **cfg).init_from_seed(seed).eval()
    _noise_gains(pipe)
    return pipe


def _noise_gains(module, value=0.1):
    with torch.no_grad():
        for k, v in module.named_parameters():
            if k.endswith("noise.weight"):
                v.fill_(value)


def _inputs(pipe, batch=2):
    rng = np.random.default_rng(0)
    codes = rng.standard_normal((batch, pipe.psp.n_latent, 512))
    low = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3))
    lat = rng.standard_normal((batch, pipe.generator.n_latent, 512))
    return [torch.tensor(a, dtype=torch.float32) for a in (codes, low, lat)]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# -- (i) the spec rule ------------------------------------------------------

@pytest.fixture(scope="module")
def both_trees():
    """The JAX pipeline's parameter shapes (`jax.eval_shape`) and the port
    pipeline (uninitialised) at the config."""
    jax = pytest.importorskip("jax")
    from vspbfr_tpu.models.e4e import TINY_STAGES as JAX_TINY
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    jpipe = JaxPipeline(encoder_stages=JAX_TINY, **CFG)
    return (jax.eval_shape(jpipe.init_params, jax.random.key(0)),
            RestorationPipeline(encoder_stages=TINY_STAGES, **CFG))


@pytest.mark.parametrize("min_size", [256, 64])
def test_model_param_specs_match_jax_rule(both_trees, min_size):
    """The port's rule over the port pipeline's parameters shards exactly
    the flax leaves JAX's `model_param_specs` shards, on their last axis
    over "model"."""
    import jax
    from vspbfr_tpu.parallel import create_mesh_2d, model_param_specs as jspecs
    from vspbfr_tpu_torch.convert import port_key

    shapes, pipe = both_trees
    specs = jspecs(shapes, create_mesh_2d(2, 4), min_size=min_size)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    want = {port_key(tuple(k.key for k in path))
            for path, s in flat if s.spec != ()}
    assert len(want) > 10

    mesh = types.SimpleNamespace(shape=(2, 4),
                                 mesh_dim_names=("data", "model"))
    got = model_param_specs(pipe, mesh, min_size=min_size)
    assert set(got) == {port_key(tuple(k.key for k in path))
                        for path, _ in flat}
    sharded = {k for k, p in got.items() if any(x.is_shard() for x in p)}
    assert sharded == want
    for k in sharded:
        data, model = got[k]
        assert data.is_replicate() and model.dim == pipe.get_parameter(
            k).dim() - 1
    # a state_dict (optimizer moments mirror the parameters) alike
    sd_specs = model_param_specs(
        {k: pipe.get_parameter(k) for k in got}, mesh, min_size=min_size)
    assert sd_specs == got


def test_placements_match_jax_partition_specs():
    """`replicated`, `batch_sharded` and `spatial_sharded` give, axis by
    axis, the dims JAX's `PartitionSpec`s name (NHWC: batch 0, H 1)."""
    pytest.importorskip("jax")
    from torch.distributed.tensor import Replicate, Shard

    from vspbfr_tpu.parallel import (batch_sharded as jb, create_mesh_2d,
                                     replicated as jr, spatial_sharded as js)
    from vspbfr_tpu_torch.parallel import (batch_sharded, replicated,
                                           spatial_sharded)

    jmesh = create_mesh_2d(2, 4)
    mesh = types.SimpleNamespace(shape=(2, 4),
                                 mesh_dim_names=("data", "model"))

    def dims(spec):
        """mesh axis -> the array dim it shards, from a PartitionSpec."""
        return {a: d for d, a in enumerate(spec) if a is not None}

    for port, ref in ((replicated(mesh), jr(jmesh)),
                      (batch_sharded(mesh), jb(jmesh)),
                      (spatial_sharded(mesh), js(jmesh)),
                      (spatial_sharded(mesh, batch_axis=None),
                       js(jmesh, batch_axis=None))):
        want = dims(ref.spec)
        assert port == tuple(Shard(want[a]) if a in want else Replicate()
                             for a in ("data", "model"))
    assert spatial_sharded(mesh) == (Shard(0), Shard(1))


# -- (ii) the decoder from JAX's init ----------------------------------------

@pytest.fixture(scope="module")
def jax_decoder():
    """The decoder at the config from the JAX package's init (noise gains
    0.1), as a port module and JAX's (module, params)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from vspbfr_tpu.models.stylegan2 import Generator as JaxGenerator
    from vspbfr_tpu_torch.convert import state_dict_from_jax
    from vspbfr_tpu_torch.models.stylegan2 import Generator

    fm = JaxGenerator(size=DEC, packed_min_res=0)
    params = jax.jit(fm.init)(jax.random.key(0),
                              jnp.zeros((1, fm.n_latent, 512)))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if any(
            getattr(k, "key", None) == "noise" for k in p) else v, params)
    tm = Generator(size=DEC)
    tm.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), tm))
    return tm.eval(), fm, params


def _decode_noise(gen, batch, seed=5):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in gen.noise_shapes(batch)]


def test_decoder_from_jax_init_matches_jax(jax_decoder):
    import jax
    import jax.numpy as jnp

    tm, fm, params = jax_decoder
    codes = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, tm.n_latent, 512)), dtype=torch.float32)
    noise = _decode_noise(tm, 2)
    img, feats = jax.jit(lambda p, c, n: fm.apply(
        {"params": p}, c, noise=n, return_features=True))(
        params, jnp.asarray(codes.numpy()), [jnp.asarray(n.numpy())
                                             for n in noise])
    with torch.no_grad():
        got, gfeats = tm(codes, noise=noise, return_features=True)
    assert _rel(got, torch.tensor(np.asarray(img))) <= 1e-4
    for g, r in zip(gfeats, feats):
        assert _rel(g, torch.tensor(np.asarray(r))) <= 1e-4


# -- (iii) the halo logic, ranks as threads -----------------------------------

@contextlib.contextmanager
def conv_rows(record):
    """Record (input rows, input width, stride, kind) of every K1 / K2
    forward and of the strided and transposed convs."""
    # the modules (the package exports functions of the same names)
    dense_conv, dilated_conv, mc = (
        importlib.import_module(f"vspbfr_tpu_torch.ops.{m}")
        for m in ("dense_conv", "dilated_conv", "modulated_conv"))

    k1, k2, cn, ct = (dense_conv._dense_conv_forward,
                      dilated_conv._multi_forward, mc.conv_nhwc,
                      mc.conv_transpose2d)

    def k1_spy(x, *a):
        record.append((x.shape[1], x.shape[2], 1, "K1"))
        return k1(x, *a)

    def k2_spy(x, *a):
        record.append((x.shape[1], x.shape[2], 1, "K2"))
        return k2(x, *a)

    def cn_spy(x, w, stride=1, *a, **kw):
        record.append((x.shape[1], x.shape[2], stride, "conv"))
        return cn(x, w, stride, *a, **kw)

    def ct_spy(x, *a, **kw):
        record.append((x.shape[1], x.shape[2], 2, "convT"))
        return ct(x, *a, **kw)

    dense_conv._dense_conv_forward, dilated_conv._multi_forward = (k1_spy,
                                                                   k2_spy)
    mc.conv_nhwc, mc.conv_transpose2d = cn_spy, ct_spy
    try:
        yield
    finally:
        dense_conv._dense_conv_forward, dilated_conv._multi_forward = k1, k2
        mc.conv_nhwc, mc.conv_transpose2d = cn, ct


@pytest.fixture(scope="module")
def stages(jax_decoder):
    """The pipeline (its decoder from JAX's init) and the unsharded decode
    and restore stages on seeded inputs and draws."""
    pipe = _pipeline()
    pipe.psp.decoder.load_state_dict(jax_decoder[0].state_dict())
    codes, low, lat = _inputs(pipe)
    with torch.no_grad():
        img, feats = pipe.psp.decode_with_feats(
            codes, generator=torch.Generator().manual_seed(3))
        out = pipe.generator(low, feats, codes, lat, input_is_latent=True,
                             generator=torch.Generator().manual_seed(6))
    return pipe, (codes, low, lat), (img, feats, out)


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_stages_match_unsharded(stages, n):
    """Decode and RestoreNet H-sharded over n thread ranks (noise drawn
    from the generators, as the unsharded run draws it) against the
    unsharded port: 2e-4 of each output's max; every K1 / K2 / strided
    conv input at a sharded level holds at most H/n + its halo rows."""
    pipe, (codes, low, lat), (img, feats, out) = stages
    record = []

    def ranks(sp):
        im, fe = pipe.psp.decode_with_feats(
            codes, generator=torch.Generator().manual_seed(3), spatial=sp)
        o = pipe.generator(low, [f for f in feats], codes, lat,
                           input_is_latent=True, spatial=sp,
                           generator=torch.Generator().manual_seed(6))
        return (sp.gather(im), [sp.gather(f) for f in fe], sp.gather(o),
                o.shape, sp.exchanges)

    with conv_rows(record):
        got = run_threads(n, ranks)
    for g_img, g_feats, g_out, local, exchanges in got:
        assert _rel(g_img, img) <= 2e-4
        assert len(g_feats) == len(feats)
        for g, r in zip(g_feats, feats):
            assert _rel(g, r) <= 2e-4
        assert _rel(g_out, out) <= 2e-4
        assert local[1] == SIZE // n and exchanges > 0
    sp = Spatial(types.SimpleNamespace(rank=0, size=n))
    checked = transitions = 0
    for rows, width, stride, kind in record:
        halo = 2 * (8 if kind == "K2" else 3)
        if sp.sharded(width):
            assert rows <= width // n + halo, (rows, width, stride, kind)
            checked += 1
        elif rows != width or (kind == "convT" and sp.sharded(2 * width)):
            # the up-conv from the last whole level to the first sharded
            # one reads a window of its whole input
            assert sp.sharded(2 * width) and rows <= width // n + halo
            transitions += 1
    assert checked > 20 and transitions > 0
    assert SIZE // n >= MIN_ROWS


def test_spatial_threshold_and_window():
    """The threshold (MIN_ROWS rows a shard) and the window's rows: the
    neighbours' edge strips between shards, zeros at the image's edges,
    the same slice of a whole map."""
    x = torch.arange(2 * 32 * 32 * 1, dtype=torch.float32).reshape(
        2, 32, 32, 1)
    padded = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                     (0, 0, 8, 8)).permute(0, 2, 3, 1)

    def ranks(sp):
        assert sp.sharded(32) == (32 // sp.n >= MIN_ROWS)
        mine = sp.own(x)
        return sp.window(mine, 3, 8), sp.window(x[:, :8, :8], 2, 1)

    for n in (2, 4):
        for r, (win, small) in enumerate(run_threads(n, ranks)):
            h = 32 // n
            assert torch.equal(win, padded[:, 8 + r * h - 3:8 + (r + 1) * h
                                           + 8])
            assert small.shape[1] == 8 // n + 3
    with pytest.raises(ValueError, match="rows"):
        Spatial(types.SimpleNamespace(rank=0, size=2)).window(x[:, :5], 1, 1)


# -- (iv) real gloo ranks: one 2 x 2 run ------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """This file as 4 gloo ranks on a 2 data x 2 model mesh, on the
    pipeline this process makes once (its state_dict in a file): each
    rank's record, and the world-1 references (`_world1`, computed here
    while the ranks run, at the ranks' one intra-op thread: `one_thread`)."""
    out_dir = tmp_path_factory.mktemp("mesh2d")
    pipe = _pipeline(GLOO_CFG)
    state_file = os.path.join(out_dir, "pipe.pt")
    torch.save(pipe.state_dict(), state_file)
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="4", RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="4", OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", PYTHONPATH=ROOT)
        out = os.path.join(out_dir, f"rank{r}.pt")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out, state_file],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    logs = []
    try:
        world1 = _world1(pipe)
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
    # ~380 MB, which pytest would keep to the end of the session
    shutil.rmtree(out_dir)
    return ranks, world1


def _stage2_trainer(batch, pipe):
    """The stage-2 trainer on `pipe`'s psp and diffuser, the loss terms
    of JAX's test (L1 alone: its LPIPS and ID nets are built, not run, so
    not initialised)."""
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    return DiffuserTrainer(
        DiffuserTrainConfig(size=SIZE, batch=batch, percept_weight=0.0,
                            id_weight=0.0), pipe)


def _stage2_batch():
    rng = np.random.default_rng(21)
    return [torch.tensor(rng.uniform(-1, 1, (2, SIZE, SIZE, 3)),
                         dtype=torch.float32) for _ in range(2)]


def _file_bytes(tree) -> bytes:
    """The bytes `torch.save` writes for tree."""
    buf = io.BytesIO()
    torch.save(tree, buf)
    return buf.getvalue()


@contextlib.contextmanager
def reduced_grads(state, names, record):
    """Record into `record` (name -> tensor) the gradients Adam takes in
    `state`'s next update: after the data axis' reduction, before the
    step; `names` in the optimizer's parameter order."""
    def hook(opt, *_):
        params = opt.param_groups[0]["params"]
        record.update({n: p.grad.clone() for n, p in zip(names, params)})

    handle = state.opt.register_step_pre_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def _mse_grads(dec, codes, noise):
    img, _ = dec(codes, noise=noise)
    loss = img.square().mean()
    loss.backward()
    return img.detach()


def _rank(out, state_file):
    """One rank of the 2 x 2 run on the pipeline in `state_file`; writes
    its record to `out`."""
    import copy

    from vspbfr_tpu_torch.models.code_diffuser import CodeDiffuser
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.parallel import (create_mesh_2d, distributed,
                                           shard_module)
    from vspbfr_tpu_torch.parallel.model_axis import (parameters_in_order,
                                                      sharded_names)
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.state import TrainState

    rec = {}
    with distributed("cpu"):
        mesh = create_mesh_2d(2, 2)
        sp = Spatial.from_mesh(mesh)
        d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        rec["coords"] = (d, m)
        pipe = RestorationPipeline(encoder_stages=TINY_STAGES, **GLOO_CFG)
        pipe.load_state_dict(torch.load(state_file, weights_only=True))
        pipe.eval()
        codes, low, lat = _inputs(pipe)
        rows = sp.batch_rows(codes.shape[0])
        with torch.no_grad():
            img, feats = pipe.psp.decode_with_feats(
                codes[rows], generator=torch.Generator().manual_seed(3),
                spatial=sp)
            o = pipe.generator(low[rows], feats, codes[rows], lat[rows],
                               input_is_latent=True, spatial=sp,
                               generator=torch.Generator().manual_seed(6))
        rec["decode"] = (sp.gather(img), [sp.gather(f) for f in feats])
        rec["restore"] = sp.gather(o)
        rec["local_rows"] = o.shape[1]

        # the model-sharded decoder: forward and the MSE's gradients
        dec = shard_module(copy.deepcopy(pipe.psp.decoder), mesh)
        rec["dec_img"] = _mse_grads(dec, codes[:1], _decode_noise(dec, 1))
        rec["dec_grads"] = {n: p.grad.clone() for n, p in zip(
            dec._model_axis["names"], parameters_in_order(dec))}
        rec["dec_sharded"] = sharded_names(dec)

        # stage 2 on the mesh: this data rank's row of the global batch
        tr = _stage2_trainer(1, pipe).shard_model(mesh)
        lo, re = (x[tr.dp.local_rows(2)] for x in _stage2_batch())
        rec["grads"] = {}
        with reduced_grads(tr.state, tr.diffuser._model_axis["names"],
                           rec["grads"]):
            metrics = tr.train_step(lo, re, torch.Generator().manual_seed(5))
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        rec["moment_numel"] = sum(st["exp_avg"].numel()
                                  for st in tr.state.opt.state.values())
        rec["diffuser_sharded"] = sharded_names(tr.diffuser)
        ck = tr.state.state_dict()      # collective: every rank calls it
        rec["params"] = ck["params"]
        blob = _file_bytes(ck)
        rec["ckpt"] = hashlib.sha256(blob).hexdigest()
        # the same file from an unsharded state loaded with it, and back
        # into shards
        plain = TrainState(CodeDiffuser(), 0.002, 4)
        plain.load_state_dict(ck)
        again = TrainState(shard_module(CodeDiffuser(), mesh), 0.002, 4)
        again.load_state_dict(ck)
        rec["ckpt_again"] = [_file_bytes(state.state_dict()) == blob
                             for state in (plain, again)]
        rec["reloaded_slices"] = all(
            torch.equal(a, b) for a, b in zip(
                parameters_in_order(again.module),
                parameters_in_order(tr.diffuser)))
    torch.save(rec, out)


def _world1(pipe):
    """The world-1 references on `pipe` at the same global batch (its
    diffuser takes the step)."""
    codes, low, lat = _inputs(pipe)
    with torch.no_grad():
        img, feats = pipe.psp.decode_with_feats(
            codes, generator=torch.Generator().manual_seed(3))
        out = pipe.generator(low, feats, codes, lat, input_is_latent=True,
                             generator=torch.Generator().manual_seed(6))
    dec = pipe.psp.decoder
    dec_img = _mse_grads(dec, codes[:1], _decode_noise(dec, 1))
    grads = {n: p.grad.clone() for n, p in dec.named_parameters()}
    tr = _stage2_trainer(2, pipe)
    init = {k: v.clone() for k, v in tr.diffuser.state_dict().items()}
    metrics = tr.train_step(*_stage2_batch(),
                            torch.Generator().manual_seed(5))
    params = {k: v.clone() for k, v in tr.diffuser.state_dict().items()}
    tr.diffuser.load_state_dict(init)
    return dict(decode=(img, feats), restore=out, dec_img=dec_img,
                dec_grads=grads, metrics={k: float(v) for k, v in
                                          metrics.items()},
                grads=_pair_grads(tr), params=params, init=init,
                moment_numel=sum(p.numel() for p in tr.diffuser.parameters()))


def _pair_grads(tr):
    """The gradient the 2 x 2 step's data axis reduces to: the mean of
    each global batch row's own gradient, each taken at batch 1 as a data
    rank takes it (the step's gradient at batch 2 is another sum: at
    these random weights the stage-2 loss's gradients move by ~13% of a
    tensor's max between the two, unsharded)."""
    low, real = _stage2_batch()
    draws = tr.draw(2, torch.Generator().manual_seed(5))
    rows = []
    for i in range(2):
        tr.state.opt.zero_grad(set_to_none=True)
        tr.loss_and_grads(low[i:i + 1], real[i:i + 1], {
            "init_noise": draws["init_noise"][i:i + 1],
            "noise": [n[i:i + 1] for n in draws["noise"]]})
        rows.append({n: torch.zeros_like(p) if p.grad is None
                     else p.grad.clone()
                     for n, p in tr.diffuser.named_parameters()})
    tr.state.opt.zero_grad(set_to_none=True)
    return {n: (rows[0][n] + rows[1][n]) / 2 for n in rows[0]}


def _slice_of(want, name, sharded, m, n=2):
    """The model rank m's slice of a full tensor where `name` is sharded."""
    if name not in sharded:
        return want
    k = want.shape[-1] // n
    return want[..., m * k:(m + 1) * k]


def _worst_rel(got: dict, want: dict, sharded, m) -> float:
    """The largest |got - want| over each tensor's max |want| (rank m's
    slices of the sharded ones)."""
    worst = 0.0
    for name, g in got.items():
        w = _slice_of(want[name], name, sharded, m)
        assert g.shape == w.shape, name
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), 1e-6))
    return worst


def test_gloo_spatial_stages(gloo_run):
    """2 data x 2 model: each data rank decodes and restores its batch row
    H-sharded over its model group."""
    gloo_run, world1 = gloo_run
    img, feats = world1["decode"]
    for rk in gloo_run:
        d, _ = rk["coords"]
        g_img, g_feats = rk["decode"]
        assert _rel(g_img, img[d:d + 1]) <= 2e-4
        for g, r in zip(g_feats, feats):
            assert _rel(g, r[d:d + 1]) <= 2e-4
        assert _rel(rk["restore"], world1["restore"][d:d + 1]) <= 2e-4
        assert rk["local_rows"] == SIZE // 2


def test_gloo_model_sharded_decoder(gloo_run):
    """The decoder with its >= 256-wide last axes sharded over the model
    axis: the image within 5e-4, every parameter's gradient (the rank's
    slice where sharded) within 1e-5 of its max."""
    gloo_run, world1 = gloo_run
    for rk in gloo_run:
        _, m = rk["coords"]
        assert len(rk["dec_sharded"]) > 10
        assert _rel(rk["dec_img"], world1["dec_img"]) <= 5e-4
        assert _worst_rel(rk["dec_grads"], world1["dec_grads"],
                          rk["dec_sharded"], m) <= 1e-5


def test_gloo_stage2_step(gloo_run):
    """One stage-2 step on the 2 x 2 mesh (diffuser and frozen psp model-
    sharded, the batch over the data axis) against world 1 at the same
    global batch: the metrics (rtol 1e-3), the gradients Adam takes
    (reduced over the data axis; each rank's slice within 1e-5 of each
    one's max), the updated parameters (within 2.05 x lr_eff, as JAX's
    test; at most 5% of any tensor's elements off by more than lr_eff,
    where a first Adam step moves each by +-lr_eff: only gradients near
    zero may change sign); Adam's moments at half the sharded parameters'
    size."""
    gloo_run, world1 = gloo_run
    ref = world1["metrics"]
    for rk in gloo_run:
        for k, v in ref.items():
            assert rk["metrics"][k] == pytest.approx(v, rel=1e-3, abs=1e-4), k
        assert rk["diffuser_sharded"]
        assert _worst_rel(rk["grads"], world1["grads"],
                          rk["diffuser_sharded"], rk["coords"][1]) <= 1e-5
        for k, want in world1["params"].items():
            diff = (rk["params"][k] - want).abs()
            assert float(diff.max()) <= 2.05 * LR_EFF, k
            assert float((diff > LR_EFF).float().mean()) <= 0.05, k
    n_sharded = sum(world1["params"][k].numel()
                    for k in gloo_run[0]["diffuser_sharded"])
    assert gloo_run[0]["moment_numel"] == world1["moment_numel"] - (
        n_sharded // 2)
    # the ranks agree: the same step on every rank
    for rk in gloo_run[1:]:
        assert rk["metrics"] == gloo_run[0]["metrics"]


def test_gloo_checkpoint_round_trip(gloo_run):
    """The sharded TrainState's checkpoint holds the full tensors under the
    unsharded keys (the same file whether the state was sharded or not:
    saved again from an unsharded state and from a re-sharded one, byte
    for byte: the same sha256), and loads back into the same slices."""
    gloo_run, world1 = gloo_run
    for rk in gloo_run:
        assert list(rk["params"]) == list(world1["init"])
        for k, v in rk["params"].items():
            assert v.shape == world1["init"][k].shape
        assert rk["ckpt_again"] == [True, True]
        assert rk["reloaded_slices"]
    assert len({rk["ckpt"] for rk in gloo_run}) == 1


if __name__ == "__main__":
    import datetime

    from vspbfr_tpu_torch.parallel import mesh

    mesh.DEFAULT_TIMEOUT = datetime.timedelta(seconds=GROUP_TIMEOUT)
    _rank(*sys.argv[1:3])
