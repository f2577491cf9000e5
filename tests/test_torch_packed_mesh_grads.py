"""Gradients through the space-to-depth packed layout on the port's 2-D
mesh (`vspbfr_tpu_torch/parallel/spatial.py` with `ops/packed.py`), on
the CPU: the backward counterparts of `tests/test_torch_packed_mesh.py`'s
forward tests. The ranks are threads of this process
(`tests/thread_ranks.py`, gradients on; no process group), one intra-op
thread each.

- (i) each of the 15 packed forms of `tests/test_torch_packed_mesh.py`
  (`FORMS`) on this rank's rows at n = 2 and 4, for a fixed cotangent on
  the output's rows (the whole output where its resolution is not
  sharded), against the unsharded form's VJP within 1e-5 of each
  tensor's max: the input's gradient (each rank's rows, gathered; whole
  and equal on every rank where the input is whole), and the weights',
  styles', `in_scale`'s and the epilogue's scale and bias gradients (each
  rank's part, summed over the ranks);
- (ii) at n = 2, the H-sharded packed decode (`decode_with_feats`) and
  the packed RestoreNet stage at packed_min_res 32, their weights from the
  JAX package's init (`state_dict_from_jax`, noise gains 0.1), against the
  JAX package's unsharded `decode_with_feats` / `RestorationNet` at the
  same packed_min_res through `jax.grad`: every parameter's gradient
  (each rank's parts summed by `Spatial.sum_partial_grads`, as the
  trainers sum them) and the codes' gradient (summed once through
  `Spatial.summed`) on every rank, within 1e-3 of each gradient's max
  (`JAX_REL`, the models tolerance of `tests/test_torch_packed.py`).
"""

import copy
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_packed_mesh import (  # noqa: E402
    FORMS,
    PMRS,
    SIZE,
    T,
    _epi,
    _form,
    _rand,
)
from tests.thread_ranks import run_threads  # noqa: E402
from vspbfr_tpu_torch.parallel import Spatial  # noqa: E402

OPS_REL = 1e-5
JAX_REL = 1e-3
DEC = 64


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


def _leaves(tensors: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in tensors.items()}


# -- (i) the packed forms' gradients on rows ----------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", FORMS)
def test_packed_form_gradients_on_rows(name, n):
    """The form's VJP on each rank's rows against the unsharded form's: the
    input's gradient (its rows gathered, or whole on every rank), and the
    weights', styles', in_scale's and the epilogue's out_scale / bias
    gradients summed over the ranks, within 1e-5 of each tensor's max; the
    backward exchanged rows wherever a sharded input has a halo."""
    gen = torch.Generator().manual_seed(FORMS.index(name))
    x, packed_in, up, packed_out, fn, with_epi, p = _form(name, gen)
    res = Spatial.res_of(x, packed_in)
    res_out = res * up if up else res // 2
    with torch.no_grad():
        shape = fn(x, p, None, None).shape
    epi = _epi(gen, shape, packed_out) if with_epi else None
    probe = _rand(gen, *shape)
    params = dict(p, **({"out_scale": epi["out_scale"], "bias": epi["bias"]}
                        if epi else {}))

    def split(leaves):
        e = None if epi is None else dict(
            epi, out_scale=leaves["out_scale"], bias=leaves["bias"])
        return {k: leaves[k] for k in p}, e

    ref = _leaves(dict(params, x=x))
    pr, er = split(ref)
    (fn(ref["x"], pr, er, None) * probe).sum().backward()

    def rank(sp):
        mine = _leaves(params)
        xin = (x[:, sp.own_rows(res, packed_in)] if sp.sharded(res) else x)
        xin = xin.clone().requires_grad_(True)
        pm, e = split(mine)
        if e is not None:
            rows = (sp.step(res_out, packed_out) if sp.sharded(res)
                    else None)
            e["noise"] = sp.noise(epi["noise"].shape, epi["noise"], None,
                                  rows, packed=packed_out)
        out = fn(xin, pm, e, sp)
        cot = (probe[:, sp.own_rows(res_out, packed_out)]
               if sp.sharded(res_out) else probe)
        before = sp.exchanges
        (out * cot).sum().backward()
        return (xin.grad, {k: v.grad for k, v in mine.items()},
                sp.exchanges - before)

    got = run_threads(n, rank, grad=True)
    if Spatial(types.SimpleNamespace(rank=0, size=n)).sharded(res):
        gx = torch.cat([g[0] for g in got], dim=1)
        assert _rel(gx, ref["x"].grad) <= OPS_REL, "x"
        # the halo strips' gradients went back (the 1x1 form reads none)
        assert all(g[2] > 0 for g in got) or name == "1x1"
    else:
        for g in got:
            assert _rel(g[0], ref["x"].grad) <= OPS_REL, "x (whole)"
    for k in params:
        total = sum(g[1][k] for g in got)
        assert _rel(total, ref[k].grad) <= OPS_REL, k


# -- (ii) the sharded packed decode and RestoreNet against jax.grad -----------

def _noise_gains(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if any(
            getattr(k, "key", None) == "noise" for k in p) else v, tree)


def _grads_on_ranks(n, module, run, leaves: dict):
    """run(module copy, leaves copy, spatial) -> the loss on this rank's
    rows, on n thread ranks; after the backward each rank's row parts of
    the parameters summed (`sum_partial_grads`). Per rank: {name: grad}
    of the parameters and of the leaves."""
    def rank(sp):
        mod = copy.deepcopy(module)
        mod.zero_grad(set_to_none=True)
        mine = _leaves(leaves)
        run(mod, mine, sp).backward()
        sp.sum_partial_grads(mod)
        out = {k: v.grad for k, v in mine.items()}
        out.update({k: torch.zeros_like(v) if v.grad is None else v.grad
                    for k, v in mod.named_parameters()})
        return out, sp.exchanges, sp.grad_sums

    return run_threads(n, rank, grad=True)


def _assert_grads(got, want: dict, what):
    worst = max((_rel(got[k], w), k) for k, w in want.items())
    assert worst[0] <= JAX_REL, (what, worst)


def test_sharded_packed_decode_grads_match_jax():
    """The packed decode at pmr 32 (decoder 64: its 32 and 64 px levels
    packed, the image pooled from the packed RGB) H-sharded over two
    thread ranks, weights from the JAX package's init and unpacked noise
    maps given to both, a fixed cotangent on the image and on every
    feature tap: the codes' and every decoder parameter's gradient on each
    rank against `jax.grad` of the JAX package's unsharded
    `decode_with_feats`, 1e-3 of each one's max."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from vspbfr_tpu.models.e4e import TINY_STAGES as JAX_TINY
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline
    from vspbfr_tpu_torch.convert import state_dict_from_jax
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    pmr, b, n = PMRS[0], 1, 2
    cfg = dict(size=SIZE, decoder_size=DEC, encode_size=64, channel_div=8,
               packed_min_res=pmr)
    jpsp = JaxPipeline(encoder_stages=JAX_TINY, **cfg).psp
    psp = RestorationPipeline(encoder_stages=TINY_STAGES, **cfg).psp
    dec = psp.decoder
    rng = np.random.default_rng(5)
    codes = rng.standard_normal((b, dec.n_latent, 512)).astype(np.float32)
    params = jax.jit(lambda k: jpsp.decoder.init(
        {"params": k, "noise": k}, jnp.asarray(codes))["params"])(
        jax.random.key(0))
    params = jax.tree.map(np.asarray, _noise_gains(params))
    dec.load_state_dict(state_dict_from_jax(params, dec))
    noise = [rng.standard_normal((b, 2 * s[1], 2 * s[2], 1) if s[3] == 4
                                 else s).astype(np.float32)
             for s in dec.noise_shapes(b)]
    with torch.no_grad():
        img, feats = psp.decode_with_feats(T(codes), noise=list(map(T,
                                                                    noise)))
    probes = [_rand(torch.Generator().manual_seed(i), *t.shape)
              for i, t in enumerate([img] + list(feats))]

    def jloss(prm, c):
        im, fe = jpsp.decode_with_feats({"decoder": prm}, c,
                                        noise=list(map(jnp.asarray, noise)))
        return sum(jnp.sum(t * jnp.asarray(p.numpy()))
                   for t, p in zip([im] + list(fe), probes))

    g_prm, g_codes = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(codes))
    want = dict(state_dict_from_jax(jax.tree.map(np.asarray, g_prm), dec),
                codes=T(np.asarray(g_codes)))

    def run(mod, leaves, sp):
        im, fe = psp.decode_with_feats(leaves["codes"], decoder=mod,
                                       noise=list(map(T, noise)),
                                       spatial=sp)
        loss = 0.0
        # the image unpacked, feature i at 4 << i in its level's layout
        for t, p, (r, packed) in zip([im] + list(fe), probes, [(SIZE, False)] + [
                (4 << i, dec.packed(4 << i)) for i in range(len(fe))]):
            loss = loss + (t * (p[:, sp.own_rows(r, packed)]
                                if sp.sharded(r) else p)).sum()
        return loss

    for got, exchanges, sums in _grads_on_ranks(n, dec, run,
                                                {"codes": T(codes)}):
        _assert_grads(got, want, "decode")
        assert exchanges > 0 and sums >= 2


def test_sharded_packed_restorenet_grads_match_jax():
    """RestoreNet at pmr 32 (its top level packed) H-sharded over two
    thread ranks, weights from the JAX package's init (noise gains 0.1),
    JAX's own packed noise draws, a fixed cotangent on the output's rows:
    the codes' (pre-styles) and every parameter's gradient on each rank
    against `jax.grad` of the JAX package's unsharded `RestorationNet`,
    1e-3 of each one's max."""
    jax = pytest.importorskip("jax")
    import flax.linen as nn
    import jax.numpy as jnp
    from vspbfr_tpu.models import layers as jl
    from vspbfr_tpu.models import restorenet as jrn
    from vspbfr_tpu_torch.convert import state_dict_from_jax
    from vspbfr_tpu_torch.models import restorenet as trn
    from vspbfr_tpu_torch.models.stylegan2 import channel_dict

    pmr, b, n = PMRS[0], 1, 2
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
    probe = rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32)
    args = (jnp.asarray(img), [jnp.asarray(f) for f in feats])
    params = fm.init({"params": jax.random.key(0),
                      "noise": jax.random.key(1)}, *args, jnp.asarray(pre),
                     jnp.asarray(z), inject_index=3)["params"]
    params = jax.tree.map(np.asarray, _noise_gains(params))
    tm.load_state_dict(state_dict_from_jax(params, tm))
    maps = []

    def rec(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if isinstance(context.module, jl.NoiseInjection):
            maps.append(out[1])
        return out

    def jloss(prm, p):
        out = fm.apply({"params": prm}, *args, p, jnp.asarray(z),
                       inject_index=3, rngs={"noise": jax.random.key(2)})
        return jnp.sum(out * jnp.asarray(probe))

    with nn.intercept_methods(rec):
        jloss(params, jnp.asarray(pre))
    noise = [T(np.asarray(m)) for m in maps]
    assert [tuple(t.shape) for t in noise] == tm.noise_shapes(b)
    assert noise[0].shape[-1] == 4      # the packed draw at the top
    g_prm, g_pre = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(pre))
    want = dict(state_dict_from_jax(jax.tree.map(np.asarray, g_prm), tm),
                pre=T(np.asarray(g_pre)))
    tm.eval()

    def run(mod, leaves, sp):
        out = mod(T(img), [T(f) for f in feats], leaves["pre"], T(z),
                  inject_index=3, noise=noise, spatial=sp)
        return (out * T(probe)[:, sp.own_rows(SIZE)]).sum()

    for got, exchanges, sums in _grads_on_ranks(n, tm, run,
                                                {"pre": T(pre)}):
        _assert_grads(got, want, "restorenet")
        assert exchanges > 0 and sums >= 2
