"""The port's checkpoint-conversion tools, on the CPU at the tiny config.

`python -m vspbfr_tpu_torch.cli.convert_ckpt` runs every kind with
`--tiny` on reference-layout files that `chip_smoke.write_reference_files`
writes from seeded port modules (phase 11's writer): each output equals
its source exactly; the outputs load as the trainer CLIs load them and,
psp, diffuser and g_ema assembled as a pipeline, into `cli/infer.py
--tiny --device cpu`. `orbax_to_torch.py` converts a tiny
tree saved with `vspbfr_tpu.utils.save_checkpoint` in the JAX trainer's
`pipeline_export()` layout, and the parameters of a full training
checkpoint, to what `state_dict_from_jax` makes of the same trees.

The outputs are deleted once checked (the module's converted files, 1.3
GB, when its last test is done): pytest keeps every test's directory to
the end of the session and the last three sessions, and kept they filled
a small disk under the whole suite.
"""

import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import orbax_to_torch  # noqa: E402
from vspbfr_tpu_torch.cli.common import tiny_pipeline_kwargs  # noqa: E402
from vspbfr_tpu_torch.convert import state_dict_from_jax  # noqa: E402
from vspbfr_tpu_torch.models.layers import init_module  # noqa: E402
from vspbfr_tpu_torch.pipeline import RestorationPipeline  # noqa: E402
from vspbfr_tpu_torch.utils import load_checkpoint  # noqa: E402

SIZES = ["--tiny", "--size", "32", "--decoder_size", "32"]


def _seeded(module, seed):
    return init_module(module, torch.Generator().manual_seed(seed))


def _pipe(seed):
    return _seeded(RestorationPipeline(size=32, decoder_size=32,
                                       **tiny_pipeline_kwargs(True)), seed)


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Every kind converted from phase 11's reference files of seeded
    modules: (the modules, {kind: output file}, the working dir)."""
    from vspbfr_tpu_torch.cli import convert_ckpt
    from vspbfr_tpu_torch.losses import (
        LPIPS,
        InceptionV3Features,
        ResNet101Embedder,
    )
    from vspbfr_tpu_torch.models import Discriminator

    tmp = tmp_path_factory.mktemp("convert")
    pipe = _pipe(1)
    with torch.no_grad():
        pipe.psp.latent_avg.copy_(torch.randn(
            512, generator=torch.Generator().manual_seed(2)).expand(
            pipe.psp.n_latent, -1))
    g = _seeded(type(pipe.generator)(size=32, channel_div=8), 3)
    mods = dict(pipe=pipe, g=g,
                d=_seeded(Discriminator(size=32, channel_div=8), 4),
                arcface=_seeded(ResNet101Embedder(), 5),
                lpips=_seeded(LPIPS(), 6),
                inception=_seeded(InceptionV3Features(), 7))
    jobs = chip_smoke.write_reference_files(
        str(tmp), pipe.psp, pipe.diffuser, pipe.generator, g, mods["d"],
        mods["arcface"], mods["lpips"], mods["inception"])
    out = {}
    for kind, args in jobs.items():
        out[kind] = str(tmp / f"{kind}.pt")
        convert_ckpt.main([kind, *args, "--out", out[kind], *SIZES])
    yield mods, out, tmp
    shutil.rmtree(tmp)


def test_every_kind_converts_exactly(converted):
    mods, out, _ = converted
    pipe = mods["pipe"]
    assert_same(load_checkpoint(out["psp"]), pipe.psp.state_dict())
    diff = load_checkpoint(out["diffuser"])
    assert set(diff) == {"diffuser"}
    assert_same(diff["diffuser"], pipe.diffuser.state_dict())
    restore = load_checkpoint(out["restore"])
    assert set(restore) == {"g", "g_ema", "d"}      # no optimizer entries
    assert_same(restore["g_ema"], pipe.generator.state_dict())
    assert_same(restore["g"], mods["g"].state_dict())
    assert_same(restore["d"], mods["d"].state_dict())
    for kind in ("arcface", "lpips", "inception"):
        assert_same(load_checkpoint(out[kind]), mods[kind].state_dict())


def test_psp_mapping_mlp_is_read_only_when_the_module_has_one(tmp_path):
    """The reference decoder's mapping MLP fills `PSPFacade(mapping=True)`
    through `convert_psp_checkpoint`; the CLI's psp file (the trainer
    CLIs' PSPFacade) leaves those entries out."""
    from vspbfr_tpu_torch.cli import convert_ckpt
    from vspbfr_tpu_torch.convert import convert_psp_checkpoint
    from vspbfr_tpu_torch.models import PSPFacade

    kw = dict(out_size=32, size=32, **tiny_pipeline_kwargs(True))
    psp = _seeded(PSPFacade(mapping=True, **kw), 8)
    src = str(tmp_path / "psp_ref.pt")
    torch.save(chip_smoke.reference_state_dict(psp), src)
    assert_same(convert_psp_checkpoint(PSPFacade(mapping=True, **kw), src),
                psp.state_dict())
    convert_ckpt.main(["psp", "--torch", src, "--out",
                       str(tmp_path / "plain.pt"), *SIZES])
    assert_same(load_checkpoint(str(tmp_path / "plain.pt")),
                {k: v for k, v in psp.state_dict().items()
                 if not k.startswith("decoder.style.")})
    shutil.rmtree(tmp_path)


def _faces(d, n, size):
    """n [-1, 1] HWC `.npy` inputs for the infer CLI."""
    rng = np.random.default_rng(9)
    d.mkdir()
    for i in range(n):
        np.save(d / f"f{i}.npy", rng.uniform(-1, 1, (size, size, 3)).astype(
            np.float32))
    return str(d)


def test_outputs_load_into_the_trainer_clis_and_infer(converted):
    """The files load strictly as the trainer CLIs load them (the psp and
    diffuser files into the pipeline's modules, the loss nets through
    `cli.common.wire_loss_nets`, as `cli/train_restore.py` and
    `cli/train_diffuser.py` do), and infer serves the pipeline assembled
    from psp, diffuser and g_ema."""
    from vspbfr_tpu_torch.cli import infer
    from vspbfr_tpu_torch.cli.common import wire_loss_nets
    from vspbfr_tpu_torch.losses import LPIPS, ResNet101Embedder

    mods, out, tmp = converted
    pipe = mods["pipe"]
    fresh = RestorationPipeline(size=32, decoder_size=32,
                                **tiny_pipeline_kwargs(True))
    fresh.psp.load_state_dict(load_checkpoint(out["psp"]))
    fresh.diffuser.load_state_dict(
        load_checkpoint(out["diffuser"])["diffuser"])
    lpips, id_net = LPIPS(), ResNet101Embedder()
    wire_loss_nets(lpips, id_net, out["lpips"], out["arcface"], 0.1, 0.1)
    for got, want in ((fresh.psp, pipe.psp), (fresh.diffuser, pipe.diffuser),
                      (lpips, mods["lpips"]), (id_net, mods["arcface"])):
        assert_same(got.state_dict(), want.state_dict())

    restore = load_checkpoint(out["restore"])
    sd = {f"psp.{k}": v for k, v in load_checkpoint(out["psp"]).items()}
    sd.update({f"diffuser.{k}": v for k, v in
               load_checkpoint(out["diffuser"])["diffuser"].items()})
    sd.update({f"generator.{k}": v for k, v in restore["g_ema"].items()})
    torch.save(sd, tmp / "pipeline.pt")
    assert_same(sd, pipe.state_dict())
    lq = _faces(tmp / "lq", 2, 32)
    rep = infer.main(["--lq_dirs", lq, "--ckpt", str(tmp / "pipeline.pt"),
                      *SIZES, "--device", "cpu", "--batch", "2", "--out",
                      str(tmp / "eval")])["datasets"]["data0"]
    assert rep["n"] == 2 and len(rep["batch_seconds"]) == 1
    written = sorted(p.name for p in (tmp / "eval" / "data0").iterdir())
    assert [f for f in written if "_restore." in f] == [
        f"f{i}_restore{os.path.splitext(written[0])[1]}" for i in (0, 1)]


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)


@pytest.fixture(scope="module")
def jax_trees():
    """Random numpy trees in the JAX tiny pipeline's shapes (no init runs)
    and the D's."""
    import jax.numpy as jnp

    from vspbfr_tpu.models.e4e import TINY_STAGES
    from vspbfr_tpu.models.restorenet import Discriminator
    from vspbfr_tpu.pipeline import RestorationPipeline as JaxPipeline

    jp = JaxPipeline(size=32, decoder_size=32, encode_size=64,
                     encoder_stages=TINY_STAGES, channel_div=8,
                     packed_min_res=0)
    shapes = jax.eval_shape(jp.init_params, jax.random.key(0))
    dshapes = jax.eval_shape(lambda k: Discriminator(
        size=32, channel_div=8).init(k, jnp.zeros((1, 32, 32, 3)))["params"],
        jax.random.key(0))
    return (_random_tree(shapes, 1), _random_tree(shapes["generator"], 2),
            _random_tree(dshapes, 3))


def test_orbax_pipeline_export_converts(tmp_path, jax_trees):
    """`restore_pipeline` in `pipeline_export()`'s layout -> the pipeline
    state_dict of `cli/infer.py --ckpt`, g_ema as the generator; the psp
    export -> the PSPFacade state_dict."""
    from vspbfr_tpu.utils import save_checkpoint

    params, g_ema, _ = jax_trees
    export = {"psp": params["psp"], "diffuser": params["diffuser"],
              "generator": params["generator"], "g_ema": g_ema}
    src = str(tmp_path / "restore_pipeline")
    save_checkpoint(src, export)
    out = str(tmp_path / "pipeline.pt")
    orbax_to_torch.main([src, "--out", out, *SIZES])
    got = load_checkpoint(out)
    want = state_dict_from_jax({"psp": params["psp"],
                                "diffuser": params["diffuser"],
                                "generator": g_ema}, _pipe(0))
    assert_same(got, want)
    RestorationPipeline(size=32, decoder_size=32,
                        **tiny_pipeline_kwargs(True)).load_state_dict(got)

    src = str(tmp_path / "psp")
    save_checkpoint(src, params["psp"])
    orbax_to_torch.main([src, "--out", out, *SIZES])
    assert_same(load_checkpoint(out), {k[4:]: v for k, v in want.items()
                                       if k.startswith("psp.")})
    shutil.rmtree(tmp_path)


def test_orbax_training_checkpoint_drops_the_training_state(tmp_path,
                                                            jax_trees,
                                                            capsys):
    """A stage-3 full checkpoint gives its g / g_ema / d parameters and
    says the optimizer states, RNG and iteration stay behind; a tree with
    nothing convertible raises."""
    from vspbfr_tpu.utils import save_checkpoint
    from vspbfr_tpu_torch.models import Discriminator, RestorationNet

    params, g_ema, d = jax_trees
    opt = {"mu": np.zeros(3, np.float32)}
    src = str(tmp_path / "restore")
    save_checkpoint(src, {"g": params["generator"], "g_opt": opt,
                          "g_step": np.int32(4), "d": d, "d_opt": opt,
                          "d_step": np.int32(4), "g_ema": g_ema,
                          "rng": np.zeros(2, np.uint32), "iter": np.int32(4)})
    out = str(tmp_path / "restore.pt")
    orbax_to_torch.main([src, "--out", out, *SIZES])
    assert "not carried over" in capsys.readouterr().out
    got = load_checkpoint(out)
    assert set(got) == {"g", "g_ema", "d"}
    assert_same(got["g"], state_dict_from_jax(
        params["generator"], RestorationNet(size=32, channel_div=8)))
    assert_same(got["g_ema"], state_dict_from_jax(
        g_ema, RestorationNet(size=32, channel_div=8)))
    assert_same(got["d"], state_dict_from_jax(
        d, Discriminator(size=32, channel_div=8)))

    src = str(tmp_path / "state_only")
    save_checkpoint(src, {"opt": opt, "rng": np.zeros(2, np.uint32),
                          "iter": np.int32(4)})
    with pytest.raises(ValueError, match="nothing to convert"):
        orbax_to_torch.main([src, "--out", out, *SIZES])
    shutil.rmtree(tmp_path)
