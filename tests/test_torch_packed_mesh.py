"""The space-to-depth packed layout on the port's 2-D mesh
(`vspbfr_tpu_torch/parallel/spatial.py` with `ops/packed.py`), the
forward, on the CPU (its gradients: `tests/test_torch_packed_mesh_grads.py`
and `tests/test_torch_packed_mesh_train.py`). The ranks are threads of
this process (`tests/thread_ranks.py`: no process group), one intra-op
thread each.

- (i) each packed form of `ops/packed.py` (and SMART's packed pair) on
  this rank's rows at n = 2 and 4 against the unsharded form, within 1e-5
  of max: the stride-1 conv at odd dilations (the assembled kernel's pads
  as the window) and even ones (grouped K2 on the window of d/2 rows), the
  1x1, both up-convs and both upsamples (an unpacked and a packed input,
  from sharded and from whole rows: the unpacked-to-packed transition),
  the down-conv to an unpacked output (the packed-to-unpacked transition)
  and the stride-2 packed-to-packed one, each with its epilogue (noise the
  output's rows) and, for the down-convs, to a whole and to a sharded
  output;
- (ii) the decode, the RestoreNet stage and `restore` at packed_min_res 32
  (the top level of RestoreNet at size 32, decoder 64) and 16 (one level
  down), H-sharded at n = 2 (packed levels from 16 px sharded) and n = 4
  (from 32 px), against the unsharded packed port within 2e-4 of each
  output's max, and every conv input of a layer on rows holds at most H/n
  + its halo rows (H the map's own rows);
- (iii) the H-sharded packed RestoreNet stage, its weights from the JAX
  package's init (`state_dict_from_jax`, noise gains 0.1) and its noise
  JAX's own packed draws, against the JAX package's unsharded
  `RestorationNet` at the same packed_min_res within 1e-3 of max (the
  models tolerance of `tests/test_torch_packed.py`; JAX's GSPMD form equals
  its unsharded one by `tests/test_sharding2d.py`);
- (iv) every packed noise map a layer of the decode and of RestoreNet
  draws on a rank, with a data axis of two, equals the rows of the lone
  run's draw of the global batch, exactly; given unpacked maps go through
  `space_to_depth` first;
- (v) the layout rule: `sharded` depends on the resolution alone, the
  same for both layouts; a packed map's window, `own`, `settle` and the
  row checks count packed rows; at the threshold a packed shard holds the
  4 rows grouped K2's d8 window needs.
"""

import contextlib
import importlib
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.thread_ranks import run_threads  # noqa: E402
from vspbfr_tpu_torch.ops import packed as pk  # noqa: E402
from vspbfr_tpu_torch.parallel import MIN_ROWS, Spatial  # noqa: E402

OPS_REL = 1e-5
STAGE_REL = 2e-4
JAX_REL = 1e-3
SIZE, DEC = 32, 64
PMRS = (SIZE, SIZE // 2)
T = torch.tensor


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a rank: the tensors are small and the lane runs
    six files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


# -- (i) the packed forms on rows ---------------------------------------------

B, GRID, CI, CO = 2, 16, 4, 4   # a packed input: 32 px as a 16-row grid
TAPS = (1, 3, 3, 1)


def _epi(gen, out_shape, packed_out):
    """An epilogue of the output's shape: out_scale, noise (one map a
    phase packed), bias, lrelu."""
    b, h, w, c = out_shape
    return dict(out_scale=1.0 + 0.1 * _rand(gen, b, c),
                noise=_rand(gen, b, h, w, 4 if packed_out else 1),
                bias=_rand(gen, c), act=True)


def _form(name, gen):
    """(x, packed_in, up, packed_out, fn(x, p, epi, spatial), epilogue or
    None, p) of a packed form on random operands: p the weights, styles
    and input scales it reads (a dict, so a caller can hand in its own
    leaves)."""
    from vspbfr_tpu_torch.ops import modulated_conv as mc

    xp = _rand(gen, B, GRID, GRID, 4 * CI)          # packed, 32 px
    w3 = _rand(gen, 3, 3, CI, CO, scale=0.3)
    isc = 1.0 + 0.1 * _rand(gen, B, 4 * CI)
    if name.startswith("s1 d"):
        dil = int(name[4:])

        def fn(x, p, epi, sp):
            return pk.conv2d_packed(x, p["w"], dilation=dil,
                                    in_scale=p["in_scale"], epi=epi,
                                    spatial=sp)
        return xp, True, 1, True, fn, True, dict(w=w3, in_scale=isc)
    if name == "s1 perm":
        perm = tuple(int(i) for i in np.random.default_rng(1).permutation(
            4 * CI))
        return xp, True, 1, True, lambda x, p, epi, sp: pk.conv2d_packed(
            x, p["w"], in_ch_perm=perm, epi=epi, spatial=sp), False, dict(
            w=w3)
    if name == "1x1":
        w1 = _rand(gen, 1, 1, CI, CO, scale=0.3)
        return xp, True, 1, True, lambda x, p, epi, sp: pk.conv1x1_packed(
            x, p["w"], in_scale=p["in_scale"], epi=epi), True, dict(
            w=w1, in_scale=isc)
    if name.startswith("upsample"):
        packed_in = name == "upsample packed"
        x = (_rand(gen, B, GRID // 2, GRID // 2, 12) if packed_in
             else _rand(gen, B, GRID, GRID, 3))
        return x, packed_in, 2, True, lambda t, p, epi, sp: (
            pk.upsample2d_packed(t, TAPS, packed_in, spatial=sp)), False, {}
    if name.startswith("up"):
        packed_in = name == "up packed"
        x = (_rand(gen, B, GRID // 2, GRID // 2, 4 * CI) if packed_in
             else _rand(gen, B, GRID, GRID, CI))    # 16 px in, 32 out
        s = isc if packed_in else isc[:, :CI]
        return x, packed_in, 2, True, lambda t, p, epi, sp: (
            pk.up_conv_blur_packed(t, p["w"], TAPS, packed_in,
                                   in_scale=p["in_scale"], epi=epi,
                                   spatial=sp)), True, dict(w=w3,
                                                            in_scale=s)
    if name == "down":
        return xp, True, 0, False, lambda x, p, epi, sp: (
            pk.blur_down_conv_packed(x, p["w"], TAPS,
                                     in_scale=p["in_scale"], epi=epi,
                                     spatial=sp)), True, dict(w=w3,
                                                              in_scale=isc)
    if name == "down packed":
        return xp, True, 0, True, lambda x, p, epi, sp: (
            pk.blur_down_conv_packed_packed(x, p["w"], TAPS,
                                            in_scale=p["in_scale"], epi=epi,
                                            spatial=sp)), True, dict(
            w=w3, in_scale=isc)
    # SMART's packed pair (ops/modulated_conv.py)
    w_b = _rand(gen, 3, 3, CI, CO, scale=0.3)
    style = 1.0 + 0.1 * _rand(gen, B, CI)
    pair = (mc.modulated_conv2d_d12_packed if name == "d12"
            else mc.modulated_conv2d_d48_packed)
    return xp, True, 1, True, lambda x, p, epi, sp: pair(
        x, p["w"], p["w_b"], p["style"], spatial=sp), False, dict(
        w=w3, w_b=w_b, style=style)


FORMS = ["s1 d1", "s1 d3", "s1 d2", "s1 d4", "s1 d8", "s1 perm", "1x1",
         "up", "up packed", "upsample", "upsample packed", "down",
         "down packed", "d12", "d48"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", FORMS)
def test_packed_form_on_rows(name, n):
    """The form on each rank's rows (the input its own rows, or whole where
    its resolution is not sharded; the epilogue's noise the output's rows,
    or this rank's block before a whole output settles) gathered, against
    the unsharded form: 1e-5 of max. The output holds its layout's rows."""
    gen = torch.Generator().manual_seed(FORMS.index(name))
    x, packed_in, up, packed_out, fn, with_epi, p = _form(name, gen)
    res = Spatial.res_of(x, packed_in)
    res_out = res * up if up else res // 2
    want_plain = fn(x, p, None, None)
    epi = _epi(gen, want_plain.shape, packed_out) if with_epi else None
    want = fn(x, p, epi, None) if with_epi else want_plain

    def rank(sp):
        e = None
        if epi is not None:
            rows = (sp.step(res_out, packed_out) if sp.sharded(res) else None)
            e = dict(epi, noise=sp.noise(epi["noise"].shape, epi["noise"],
                                         None, rows, packed=packed_out))
        out = fn(sp.own(x, packed_in), p, e, sp)
        return sp.gather(out), out.shape[1], sp.sharded(res_out)

    for got, rows, sharded in run_threads(n, rank):
        assert _rel(got, want) <= OPS_REL
        assert rows == (want.shape[1] // n if sharded else want.shape[1])
    sp = Spatial(types.SimpleNamespace(rank=0, size=n))
    # every form runs on rows somewhere: input or output sharded
    assert sp.sharded(res) or sp.sharded(res_out)


# -- (ii) the stages at packed_min_res, against the unsharded packed port ------

def _pipeline(pmr, seed=0):
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    pipe = RestorationPipeline(
        size=SIZE, decoder_size=DEC, encode_size=64,
        encoder_stages=TINY_STAGES, channel_div=8,
        packed_min_res=pmr).init_from_seed(seed).eval()
    with torch.no_grad():
        for k, v in pipe.named_parameters():
            if k.endswith("noise.weight"):
                v.fill_(0.1)
    return pipe


def _inputs(pipe, batch=2):
    rng = np.random.default_rng(0)
    codes = rng.standard_normal((batch, pipe.psp.n_latent, 512))
    low = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3))
    lat = rng.standard_normal((batch, pipe.generator.n_latent, 512))
    return [T(a, dtype=torch.float32) for a in (codes, low, lat)]


@contextlib.contextmanager
def conv_rows(record):
    """Record (input rows, input width, kind, on rows) of every K1 / K2
    forward and of the strided and transposed convs; "on rows": inside a
    `Spatial.layer` that put its layer on this rank's rows (per thread)."""
    dense_conv, dilated_conv, mc = (
        importlib.import_module(f"vspbfr_tpu_torch.ops.{m}")
        for m in ("dense_conv", "dilated_conv", "modulated_conv"))
    local = threading.local()
    layer = Spatial.layer
    k1, k2, cn, pcn, ct = (dense_conv._dense_conv_forward,
                           dilated_conv._multi_forward, mc.conv_nhwc,
                           pk.conv_nhwc, mc.conv_transpose2d)

    @contextlib.contextmanager
    def layer_spy(self, module, *resolutions):
        with layer(self, module, *resolutions) as rows:
            before = getattr(local, "rows", False)
            local.rows = rows
            try:
                yield rows
            finally:
                local.rows = before

    def spy(kind, fn):
        def call(x, *a, **kw):
            record.append((x.shape[1], x.shape[2], kind,
                           getattr(local, "rows", False)))
            return fn(x, *a, **kw)
        return call

    Spatial.layer = layer_spy
    dense_conv._dense_conv_forward = spy("K1", k1)
    dilated_conv._multi_forward = spy("K2", k2)
    mc.conv_nhwc, pk.conv_nhwc = spy("conv", cn), spy("conv", pcn)
    mc.conv_transpose2d = spy("convT", ct)
    try:
        yield
    finally:
        Spatial.layer = layer
        dense_conv._dense_conv_forward, dilated_conv._multi_forward = k1, k2
        mc.conv_nhwc, pk.conv_nhwc, mc.conv_transpose2d = cn, pcn, ct


@pytest.fixture(scope="module", params=PMRS, ids=lambda p: f"pmr{p}")
def stages(request):
    """The pipeline at a packed_min_res and its unsharded stages: the
    decode (pooled image, feature taps), RestoreNet on its features, and
    `restore` with the sample image; the decoder's own 64 px image (its
    top level's depth-to-space)."""
    pipe = _pipeline(request.param)
    codes, low, lat = _inputs(pipe)
    with torch.no_grad():
        full, _ = pipe.psp.decoder(codes,
                                   generator=torch.Generator().manual_seed(3))
        img, feats = pipe.psp.decode_with_feats(
            codes, generator=torch.Generator().manual_seed(3))
        out = pipe.generator(low, feats, codes, lat, input_is_latent=True,
                             generator=torch.Generator().manual_seed(6))
        restored, sample = pipe.restore(
            low, torch.Generator().manual_seed(7), return_sample=True)
    return pipe, (codes, low, lat), (img, feats, out, restored, sample,
                                     full)


@pytest.mark.parametrize("n", [2, 4])
def test_packed_stages_match_unsharded(stages, n):
    """The decode, RestoreNet (on the decode's local features) and
    `restore` H-sharded over n thread ranks at packed_min_res (noise drawn
    from the generators, as the unsharded run draws it), and the decoder's
    full image (its packed top level's depth-to-space on rows), against
    the unsharded packed port: 2e-4 of each output's max; at least one packed
    level sharded; every conv input of a layer on rows holds at most its
    map's H/n + its halo rows."""
    pipe, (codes, low, lat), (img, feats, out, restored, sample,
                              full) = stages
    pmr = pipe.packed_min_res
    record = []

    def ranks(sp):
        im, fe = pipe.psp.decode_with_feats(
            codes, generator=torch.Generator().manual_seed(3), spatial=sp)
        o = pipe.generator(low, fe, codes, lat, input_is_latent=True,
                           spatial=sp,
                           generator=torch.Generator().manual_seed(6))
        r, s = pipe.restore(low, torch.Generator().manual_seed(7),
                            return_sample=True, spatial=sp)
        fu, _ = pipe.psp.decoder(codes, spatial=sp,
                                 generator=torch.Generator().manual_seed(3))
        return (sp.gather(im), [sp.gather(f) for f in fe], sp.gather(o),
                o.shape, r, s, sp.gather(fu), fu.shape[1], sp.exchanges)

    with conv_rows(record):
        got = run_threads(n, ranks)
    for (g_img, g_feats, g_out, local, g_r, g_s, g_full, full_rows,
         exchanges) in got:
        assert _rel(g_img, img) <= STAGE_REL
        assert len(g_feats) == len(feats)
        for g, r in zip(g_feats, feats):
            assert _rel(g, r) <= STAGE_REL
        assert _rel(g_out, out) <= STAGE_REL
        assert _rel(g_r, restored) <= STAGE_REL
        assert _rel(g_s, sample) <= STAGE_REL
        assert _rel(g_full, full) <= STAGE_REL
        assert local[1] == SIZE // n and full_rows == DEC // n
        assert exchanges > 0
    sp = Spatial(types.SimpleNamespace(rank=0, size=n))
    assert any(sp.sharded(r) for r in (pmr, 2 * pmr, DEC) if r >= pmr)
    checked = 0
    for rows, width, kind, on_rows in record:
        if on_rows:
            halo = 2 * (8 if kind == "K2" else 3)
            assert rows <= width // n + halo, (rows, width, kind)
            checked += 1
    assert checked > 20


# -- (iii) the sharded packed RestoreNet against the JAX package ---------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_packed_restorenet_matches_jax(n):
    """RestoreNet at packed_min_res 32 (its top level), weights from the
    JAX package's init (noise gains 0.1), H-sharded over n thread ranks
    with JAX's own noise draws (packed at the packed layers), against the
    JAX package's unsharded RestorationNet: 1e-3 of max."""
    jax = pytest.importorskip("jax")
    import flax.linen as nn
    import jax.numpy as jnp
    from vspbfr_tpu.models import layers as jl
    from vspbfr_tpu.models import restorenet as jrn
    from vspbfr_tpu_torch.convert import state_dict_from_jax
    from vspbfr_tpu_torch.models import restorenet as trn
    from vspbfr_tpu_torch.models.stylegan2 import channel_dict

    pmr, b = SIZE, 1
    fm = jrn.RestorationNet(size=SIZE, channel_div=8, packed_min_res=pmr)
    tm = trn.RestorationNet(size=SIZE, channel_div=8, packed_min_res=pmr)
    rng = np.random.default_rng(3)
    ch = channel_dict(2, 8)
    feats = [rng.standard_normal(
        (b, r // 2, r // 2, 4 * ch[r]) if tm.packed(r) else (b, r, r, ch[r])
    ).astype(np.float32) * 0.2
        for r in (2 ** (f + 2) for f in range(tm.log_size - 1))]
    img = rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    pre = rng.standard_normal((b, 18, 512)).astype(np.float32)
    z = rng.standard_normal((2, b, 512)).astype(np.float32)
    args = (jnp.asarray(img), [jnp.asarray(f) for f in feats],
            jnp.asarray(pre), jnp.asarray(z))
    params = fm.init({"params": jax.random.key(0),
                      "noise": jax.random.key(1)}, *args,
                     inject_index=3)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if any(
            getattr(k, "key", None) == "noise" for k in p) else v, params)
    tm.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), tm))
    tm.eval()
    maps = []

    def rec(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if isinstance(context.module, jl.NoiseInjection):
            maps.append(out[1])
        return out

    with nn.intercept_methods(rec):
        ref = fm.apply({"params": params}, *args, inject_index=3,
                       rngs={"noise": jax.random.key(2)})
    noise = [T(np.asarray(m)) for m in maps]
    assert [tuple(t.shape) for t in noise] == tm.noise_shapes(b)
    assert noise[0].shape[-1] == 4      # the packed draw at the top

    def rank(sp):
        out = tm(T(img), [T(f) for f in feats], T(pre), T(z),
                 inject_index=3, noise=noise, spatial=sp)
        return sp.gather(out), out.shape[1]

    for got, rows in run_threads(n, rank):
        assert rows == SIZE // n
        assert _rel(got, np.array(ref)) <= JAX_REL


# -- (iv) the packed noise rows ------------------------------------------------

class _Batch:
    """A data-axis stand-in: index `rank` of `size` (only the batch rows
    it selects matter here)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@pytest.mark.parametrize("n", [2, 4])
def test_packed_noise_rows_exact(n):
    """Every noise map the decode and RestoreNet draw at pmr 16 (times its
    gain), on each rank of n model ranks x 2 data ranks (the local batch
    1), equals the lone run's draw of the global batch (2) cut to the
    rank's batch and rows, exactly; the packed maps (B, r/2, r/2, 4) are cut to packed rows.
    Given unpacked (B, r, r, 1) maps go through space_to_depth, then the
    rows."""
    from vspbfr_tpu_torch.models import layers as tl

    pipe = _pipeline(PMRS[1])
    codes, low, lat = _inputs(pipe)
    drawn = {}
    scaled = tl.NoiseInjection.scaled

    def spy(self, shape, like, noise=None, generator=None, spatial=None,
            rows=None):
        out = scaled(self, shape, like, noise, generator, spatial, rows)
        key = None if spatial is None else (spatial.batch_group.rank,
                                            spatial.rank)
        drawn.setdefault(key, []).append((out, self.packed, tuple(shape),
                                          rows))
        return out

    def stages(sp, rows=slice(None)):
        _, fe = pipe.psp.decode_with_feats(
            codes[rows], generator=torch.Generator().manual_seed(3),
            spatial=sp, return_image=False)
        pipe.generator(low[rows], fe, codes[rows], lat[rows],
                       input_is_latent=True, spatial=sp,
                       generator=torch.Generator().manual_seed(6))

    tl.NoiseInjection.scaled = spy
    try:
        with torch.no_grad():
            stages(None)
        for d in range(2):
            def rank(sp, d=d):
                sp.batch_group = _Batch(d, 2)
                stages(sp, slice(d, d + 1))
            run_threads(n, rank)
    finally:
        tl.NoiseInjection.scaled = scaled
    lone = drawn.pop(None)
    assert sum(m[1] for m in lone) >= 6     # packed draws from 16 px up
    sp = Spatial(types.SimpleNamespace(rank=0, size=n))
    for (d, r), maps in drawn.items():
        assert len(maps) == len(lone)
        sp.rank = r
        for (got, packed, shape, rows), (want, *_) in zip(maps, lone):
            res = shape[1] * (2 if packed else 1)
            want = want[d:d + 1]
            if sp.sharded(res):
                want = want[:, sp.own_rows(res, packed)]
            elif rows is not None:      # a down-conv's block, then settled
                want = want[:, r * rows:(r + 1) * rows]
            assert torch.equal(got, want), (shape, packed, d, r)
    # given maps: unpacked (B, r, r, 1) through space_to_depth, then rows
    nz = tl.NoiseInjection(packed=True)
    with torch.no_grad():
        nz.weight.fill_(1.0)
    full = torch.randn(2, 32, 32, 1, generator=torch.Generator()
                       .manual_seed(9))

    def given(sp):
        return nz.scaled((2, 16, 16, 4), full, noise=full, spatial=sp)

    for r, got in enumerate(run_threads(n, given)):
        h = 16 // n
        assert torch.equal(got, pk.space_to_depth(full)[:, r * h:(r + 1) * h])


# -- (v) the layout rule on packed maps ----------------------------------------

def test_packed_window_and_threshold():
    """`sharded` is the resolution's alone (r/n even, at least MIN_ROWS
    image rows), so both layouts of a resolution agree; a packed map at r
    (B, r/2, r/2, 4C) holds r/(2n) packed rows a shard; its window is the
    padded packed map's slice, in packed rows (the neighbours' strips
    between shards, zeros at the image's edges), a whole packed map's
    window is cut around the shard's block; a packed map with the wrong
    rows, and a halo past the shard, raise; at the threshold a packed
    shard holds the 4 rows grouped K2's d8 window reads."""
    x = torch.arange(2 * 16 * 16 * 8, dtype=torch.float32).reshape(
        2, 16, 16, 8)                               # packed, 32 px
    padded = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                     (0, 0, 4, 4)).permute(0, 2, 3, 1)
    small = x[:, :4, :4]                            # packed, 8 px

    def ranks(sp):
        assert sp.sharded(32) == (32 // sp.n >= MIN_ROWS)
        mine = sp.own(x, packed=True)
        assert mine.shape[1] == 16 // sp.n
        # the same map's rows, cut again, stay as they are
        assert sp.own(mine, packed=True) is mine
        win = sp.window(mine, 1, 4, packed=True)
        part = sp.window(small, 1, 1, packed=True)
        return win, part, sp.settle(mine, packed=True).shape[1]

    for n in (2, 4):
        for r, (win, part, kept) in enumerate(run_threads(n, ranks)):
            h = 16 // n
            assert torch.equal(win, padded[:, 4 + r * h - 1:4 + (r + 1) * h
                                           + 4])
            assert part.shape[1] == 4 // n + 2
            assert kept == h
    for n in (2, 4, 8):
        sp = Spatial(types.SimpleNamespace(rank=0, size=n))
        for res in (8, 16, 32, 64, 48, 40, 36):
            # one rule for both layouts: r/n even and >= MIN_ROWS
            want = res % (2 * n) == 0 and res // n >= MIN_ROWS
            assert sp.sharded(res) == want, (n, res)
            if want:
                assert sp.step(res, packed=True) * 2 == sp.step(res)
        # the threshold's packed shard covers grouped K2's d8 halo
        thr = MIN_ROWS * n
        assert sp.sharded(thr) and sp.step(thr, packed=True) >= 4
    sp = Spatial(types.SimpleNamespace(rank=0, size=2))
    with pytest.raises(ValueError, match="rows"):
        sp.window(x[:, :5], 1, 1, packed=True)
    with pytest.raises(ValueError, match="halo"):
        run_threads(4, lambda s: s.window(s.own(x, packed=True), 5, 5,
                                          packed=True))
