"""Both trainers on the port's 2-D data x model mesh at packed_min_res 32,
on the CPU: the steps of `tests/test_torch_mesh_train.py` with the
space-to-depth packed layout's levels H-sharded by packed rows, so their
gradients flow back through the packed windows.

One launch of two gloo ranks for the file (this file as the ranks'
program, on a 1 data x 2 model mesh), the lone packed steps computed here
while the ranks run, at the ranks' one intra-op thread, on the same
weights, batch and draws (the weights, configs and step functions of
`tests/test_torch_mesh_train.py`; the parameters are the unpacked layout's
in either), every parameter's gradient that Adam takes (the rank's slice
of a model-sharded one, gathered) within 1e-5 of each tensor's max:

- stage 2 at the tiny config (size 32, decoder 64: its 32 and 64 px levels
  packed, both sharded at n = 2) with the LPIPS and ID terms, in float64,
  the decode rematerialised (f32's default): the diffuser's gradients and
  the metrics;
- stage 3 at half widths (`channel_div` 2), ADA at p 0.5, lazy R1 at step
  0: RestoreNet's 32 px level and the decoder's 32 / 64 px levels packed;
  D's, R1's and G's gradients, the metrics, G's reduce-scatter having
  run, and the unsharded inference export after the step.

`tests/test_torch_packed_train.py` holds the lone packed steps to the JAX
trainers.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_mesh_train import (  # noqa: E402
    GROUP_TIMEOUT,
    RANK_TIMEOUT,
    ROOT,
    TOL,
    _free_port,
    _load,
    _metrics_match,
    _stage2_step,
    _stage2_trainer,
    _stage2_weights,
    _stage3_step,
    _stage3_trainer,
    _stage3_weights,
    _whole,
    _worst,
)

PMR = 32                # the top level of the tiny pipeline (size 32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the lone steps must run at the gloo ranks' one
    thread (equal work, equal bits in the replicated parts), and the lane
    runs six files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rank(out, weights_file):
    """One rank of the 1 x 2 run: both packed steps on the mesh; writes its
    record to `out`."""
    from vspbfr_tpu_torch.parallel import create_mesh_2d, distributed
    from vspbfr_tpu_torch.parallel.model_axis import model_axis, sharded_names

    weights = torch.load(weights_file, weights_only=True)
    rec = {}
    with distributed("cpu"):
        mesh = create_mesh_2d(1, 2)
        tr = _load(_stage2_trainer(PMR), weights["stage2"]).to(
            torch.float64).shard_model(mesh)
        s2 = _stage2_step(tr)
        rec["stage2"] = dict(metrics=s2["metrics"],
                             grads=_whole(s2["grads"], tr.diffuser),
                             exchanges=tr.spatial.exchanges,
                             grad_sums=tr.spatial.grad_sums)
        tr = _load(_stage3_trainer(PMR), weights["stage3"]).shard_model(mesh)
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
    """This file as 2 gloo ranks on a 1 data x 2 model mesh at pmr 32, on
    weights made here once (a file); each rank's record, and the lone
    packed steps, computed here while the ranks run."""
    out_dir = tmp_path_factory.mktemp("packedmeshtrain")
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
        tr = _load(_stage2_trainer(PMR), weights["stage2"]).to(torch.float64)
        assert tr.psp.decoder.packed(PMR)
        lone = {"stage2": _stage2_step(tr)}
        tr = _load(_stage3_trainer(PMR), weights["stage3"])
        assert tr.gen.packed(PMR)
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


def test_gloo_packed_stage2_step(gloo_run):
    """Stage 2 on the 1 x 2 mesh at pmr 32 (the decode's packed levels
    H-sharded by packed rows, rematerialised, with LPIPS and ID) against
    the lone packed step: the diffuser's gradients within 1e-5 of each
    one's max, the metrics; the backward ran its exchanges and one sum of
    the codes' parts."""
    ranks, lone = gloo_run
    want = lone["stage2"]
    assert want["metrics"]["percept"] > 0 and want["metrics"]["id"] > 0
    for rk in ranks:
        got = rk["stage2"]
        _metrics_match(got["metrics"], want["metrics"])
        assert len(got["grads"]) == 1
        worst, at = _worst(got["grads"][0], want["grads"][0])
        assert worst <= TOL, (worst, at)
        assert got["exchanges"] > 20 and got["grad_sums"] == 1


def test_gloo_packed_stage3_step(gloo_run):
    """Stage 3 with ADA and R1 on the 1 x 2 mesh at pmr 32 (RestoreNet's
    and the embedding's packed levels H-sharded; model-sharded G, D and
    g_ema) against the lone packed step: D's, R1's and G's gradients
    within 1e-5 of each one's max, the metrics; G's model-sharded weights
    were reduce-scattered; the unsharded inference export after the step
    (the frozen stages equal, g_ema within (1 - decay) x a first Adam
    step's envelope)."""
    ranks, lone = gloo_run
    want = lone["stage3"]
    assert want["metrics"]["r1"] > 0
    lr_eff = 0.002 * 4 / 5
    decay = 0.5 ** (32 / 10_000)
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
