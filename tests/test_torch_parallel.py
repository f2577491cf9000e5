"""Data-parallel training in the port (`vspbfr_tpu_torch/parallel/`), on
the CPU.

- `local_batch_slice` against the JAX package's;
- the loaders' shards: together one epoch, each sample degraded alike on
  any shard;
- the draws: a rank of two draws the rows of the global batch's draws;
- two gloo processes at the tiny config: a stage-2 step at world 2, 2
  rows a rank, against world 1 at 4 rows (losses to 1e-6; the ranks'
  parameters bit-identical); the stage-3 CLI with ADA at world 2, 2 steps
  (step 0's reduced D, R1 and G gradients equal the mean of the two halves'
  gradients computed in one process; G, D, g_ema and the ADA state
  bit-identical across ranks after each step; only rank 0 writes the
  checkpoint, the log and the samples);
- the deviation of `minibatch_stddev`: per rank, as under the reference's
  DDP, so at world 2 it is JAX's applied to each half, not to the global
  batch.

The ranks run with one intra-op thread, and so does what they are compared
with, so the same rows give the same bits. Every spawned process has a
timeout and the process group a bounded one: a hang fails, it does not
stall the suite. Run as a script, this file is the rank's program.
"""

import contextlib
import os
import shutil
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vspbfr_tpu_torch.parallel import DataParallel, local_batch_slice  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(size=32, decoder_size=64, encode_size=64, channel_div=8)
RANK_TIMEOUT = 240        # seconds a rank may take
GROUP_TIMEOUT = 120       # the process group's timeout, seconds


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _faces(d, n=8, size=32):
    rng = np.random.default_rng(9)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(d, f"f{i}.npy"),
                (rng.random((size, size, 3)) * 255).astype(np.uint8))
    return d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(mode: str, out_dir: str, world: int = 2, *args) -> list:
    """Run this file as `world` gloo ranks of `mode`; returns each rank's
    record (torch.load of what it saved)."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", PYTHONPATH=ROOT)
        out = os.path.join(out_dir, f"rank{r}.pt")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, out, *args],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    logs = []
    try:
        for p, _ in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    recs = []
    for _, out in procs:
        recs.append(torch.load(out, weights_only=False))
        os.remove(out)
    return recs


# -- (i) the batch slice --------------------------------------------------

@pytest.mark.parametrize("global_batch,index,count",
                         [(8, 0, 1), (8, 0, 2), (8, 1, 2), (12, 2, 3),
                          (16, 3, 4), (4, 1, 4), (9, 1, 2), (32, 7, 8)])
def test_local_batch_slice_matches_jax(global_batch, index, count):
    pytest.importorskip("jax")
    from vspbfr_tpu.parallel import local_batch_slice as jax_slice

    assert local_batch_slice(global_batch, index, count) == jax_slice(
        global_batch, index, count)


def test_local_batch_slice_defaults_to_one_process():
    assert local_batch_slice(6) == slice(0, 6)
    dp = DataParallel()
    assert (dp.rank, dp.world_size, dp.is_lead) == (0, 1, True)
    assert dp.local_rows(6) == slice(0, 6)


# -- (ii) the loaders' shards ---------------------------------------------

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, idx, epoch=0):
        return (np.array([idx]),)


@pytest.mark.parametrize("n,count,batch", [(16, 2, 2), (12, 3, 2),
                                           (17, 2, 3)])
def test_shards_make_up_the_epoch(n, count, batch):
    from vspbfr_tpu_torch.data.datasets import DataLoader

    whole = DataLoader(_Indexed(n), 1, seed=3)
    for epoch in (0, 1):
        every = [int(b[0][0, 0]) for b in whole.epoch(epoch)]
        assert sorted(every) == list(range(n))
        got, nb = [], set()
        for r in range(count):
            ld = DataLoader(_Indexed(n), batch, seed=3, shard_index=r,
                            shard_count=count, num_workers=2)
            rows = [int(i) for b in ld.epoch(epoch) for i in b[0][:, 0]]
            assert len(rows) == ld.batches_per_epoch() * batch
            # shard r takes every count-th index of the epoch from r
            assert rows == every[r::count][:len(rows)]
            got += rows
            nb.add(ld.batches_per_epoch())
        assert len(nb) == 1     # the ranks turn their epochs together
        assert len(set(got)) == len(got)
        if n % (count * batch) == 0:
            assert sorted(got) == list(range(n))


def test_a_sample_degrades_alike_on_any_shard(tmp_path):
    from vspbfr_tpu_torch.data import DeviceDegradeLoader, RestoreTrainDataset

    ds = RestoreTrainDataset(_faces(str(tmp_path / "f"), n=8),
                             im_size=(32, 32), seed=4)
    whole = DeviceDegradeLoader(ds, 8, device="cpu", seed=4)
    lq, gt = next(whole.forever())
    order = whole.inner._epoch_indices(0)
    for r in range(2):
        ld = DeviceDegradeLoader(ds, 4, device="cpu", seed=4, shard_index=r,
                                 shard_count=2)
        lq_r, gt_r = next(ld.forever())
        # shard r's row i is the whole epoch's row r + 2 i
        torch.testing.assert_close(lq_r, lq[r::2], rtol=0, atol=0)
        torch.testing.assert_close(gt_r, gt[r::2], rtol=0, atol=0)
        assert list(ld.inner._epoch_indices(0)) == list(order[r::2])


# -- the draws --------------------------------------------------------------

class _RankOf(DataParallel):
    """A rank of a world without a group: what the trainers read."""

    def __init__(self, rank, world):
        super().__init__()
        self.rank, self.world_size, self.is_lead = rank, world, rank == 0


def _restore_trainer(dp, augment=True):
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    pipe = RestorationPipeline(encoder_stages=TINY_STAGES, **TINY)
    return RestoreTrainer(RestoreTrainConfig(size=32, batch=2,
                                             augment=augment), pipe, dp)


def _rows(a, b, rows, path=""):
    """b is rows `rows` of a along each per-sample axis (the batch axis:
    0, 1 for z, the last for ADA's draws); shared scalars equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _rows(a[k], b[k], rows, f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _rows(x, y, rows, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        dim = 1 if path.endswith("/z") else (a.dim() - 1 if "/ada/" in path
                                             else 0)
        assert torch.equal(a.narrow(dim, rows.start, rows.stop - rows.start),
                           b), path
    else:
        assert a == b, path


def test_ranks_draw_their_rows_of_the_global_draws():
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    one = _restore_trainer(DataParallel())
    full = one.draw(4, torch.Generator().manual_seed(3))
    for r in range(2):
        tr = _restore_trainer(_RankOf(r, 2))
        mine = tr.draw(2, torch.Generator().manual_seed(3))
        _rows(full, mine, slice(2 * r, 2 * r + 2))

    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    def stage2(dp):
        return DiffuserTrainer(DiffuserTrainConfig(size=32, batch=2),
                               RestorationPipeline(encoder_stages=TINY_STAGES,
                                                   **TINY), dp)

    full = stage2(DataParallel()).draw(6, torch.Generator().manual_seed(4))
    for r in range(3):
        mine = stage2(_RankOf(r, 3)).draw(2, torch.Generator().manual_seed(4))
        _rows(full, mine, slice(2 * r, 2 * r + 2))


# -- (iii) stage 2 at world 2 against world 1 -------------------------------

def _stage2_trainer(dp, batch):
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    pipe = RestorationPipeline(encoder_stages=TINY_STAGES, **TINY)
    return DiffuserTrainer(DiffuserTrainConfig(size=32, batch=batch,
                                               id_weight=0.0),
                           pipe, dp).init_from_seed(0)


def _stage2_batch():
    rng = np.random.default_rng(21)
    return [torch.tensor(rng.uniform(-1, 1, (4, 32, 32, 3)),
                         dtype=torch.float32) for _ in range(2)]


def _stage2_rank(out):
    """A rank's stage-2 step on its rows of the global batch."""
    from vspbfr_tpu_torch.parallel import distributed

    with distributed("cpu") as device:
        dp = DataParallel()
        tr = _stage2_trainer(dp, 2).to(device)
        dp.replicate(tr.diffuser)
        reduced, reduce = [], dp.all_reduce_grads

        def all_reduce_grads(params):
            params = list(params)
            reduced.append(sum(p.numel() * p.element_size() for p in params))
            reduce(params)

        dp.all_reduce_grads = all_reduce_grads
        low, real = (x[dp.local_rows(4)] for x in _stage2_batch())
        m = tr.train_step(low, real, torch.Generator().manual_seed(5))
        torch.save({"metrics": {k: float(v) for k, v in m.items()},
                    "params": tr.diffuser.state_dict(),
                    "reduced": reduced}, out)


def test_stage2_world2_equals_world1(tmp_path):
    ranks = run_ranks("stage2", str(tmp_path))
    with one_thread():
        tr = _stage2_trainer(DataParallel(), 4)
        low, real = _stage2_batch()
        ref = tr.train_step(low, real, torch.Generator().manual_seed(5))
    for k, v in ref.items():
        for rk in ranks:
            assert rk["metrics"][k] == pytest.approx(float(v), rel=1e-6,
                                                     abs=1e-12), k
    a, b = (rk["params"] for rk in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # one all-reduce a step, of every diffuser gradient
    n = sum(p.numel() for p in tr.diffuser.parameters())
    assert ranks[0]["reduced"] == [4 * n]


# -- (iv) the stage-3 CLI with ADA at world 2 --------------------------------

def _stage3_argv(path, out):
    return ["--path", path, "--device", "cpu", "--tiny", "--size", "32",
            "--decoder_size", "64", "--batch", "2", "--iter", "2",
            "--augment", "--ada_length", "1000", "--id_loss_weight", "0",
            "--save_inter", "1", "--show_inter", "1", "--out", out]


def _stage3_rank(out, path, run_dir):
    """The stage-3 CLI as one rank, recording its first batch, step 0's
    gradients before and after each all-reduce and its state after each
    step."""
    from vspbfr_tpu_torch.cli import train_restore
    from vspbfr_tpu_torch.parallel import mesh
    from vspbfr_tpu_torch.train import restore_train

    rec = {"batch": None, "local": [], "reduced": [], "states": []}
    reduce, step = (mesh.DataParallel.all_reduce_grads,
                    restore_train.RestoreTrainer.train_step)

    def all_reduce_grads(self, params):
        params = list(params)
        first = not rec["states"]
        if first:
            rec["local"].append([p.grad.clone() for p in params])
        reduce(self, params)
        if first:
            rec["reduced"].append([p.grad.clone() for p in params])

    def train_step(self, low, real, generator=None, draws=None):
        if rec["batch"] is None:
            rec["batch"] = (low.clone(), real.clone())
        out = step(self, low, real, generator, draws)
        rec["states"].append({
            "g": self.gen.state_dict(), "d": self.disc.state_dict(),
            "g_ema": self.g_ema.state_dict(),
            "ada": dict(self.ada_state._asdict())})
        return out

    mesh.DataParallel.all_reduce_grads = all_reduce_grads
    restore_train.RestoreTrainer.train_step = train_step
    rank = int(os.environ["RANK"])
    rec["report"] = train_restore.main(_stage3_argv(
        path, os.path.join(run_dir, f"out{rank}")))
    torch.save(rec, out)


class _Pair:
    """Two ranks in one process, as threads, meeting to exchange."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=RANK_TIMEOUT)
        self.slots = [None, None]

    def exchange(self, rank, value):
        self.slots[rank] = value
        self.barrier.wait()
        both = list(self.slots)
        self.barrier.wait()
        return both


class _PairRank(_RankOf):
    """One of two in-process ranks: the collectives through a `_Pair`;
    records the local gradients of each all-reduce."""

    def __init__(self, pair, rank):
        super().__init__(rank, 2)
        self.pair = pair
        self.local = []

    def all_reduce_grads(self, params):
        params = list(params)
        mine = [p.grad.clone() for p in params]
        self.local.append(mine)
        a, b = self.pair.exchange(self.rank, mine)
        for p, x, y in zip(params, a, b):
            p.grad.copy_((x + y) / 2)

    def sum_(self, t):
        a, b = self.pair.exchange(self.rank, t)
        return a + b

    def mean_metrics(self, metrics):
        a, b = self.pair.exchange(self.rank, dict(metrics))
        return {k: (a[k] + b[k]) / 2 for k in a}


def _halves_in_one_process(argv, batches, steps=1):
    """Both halves' step 0 in this process, two threads of one rank each:
    each one's gradients before each all-reduce."""
    from vspbfr_tpu_torch.cli import train_restore

    args = train_restore.build_parser().parse_args(argv)
    pair = _Pair()
    ranks = [_PairRank(pair, r) for r in range(2)]
    trainers = [train_restore.build_trainer(args, torch.device("cpu"), dp)
                for dp in ranks]
    errors = []

    def run(r):
        try:
            gen = torch.Generator().manual_seed(args.seed + 1)
            for _ in range(steps):
                trainers[r].train_step(*batches[r], generator=gen)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            pair.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RANK_TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return [dp.local for dp in ranks]


def _equal_states(a, b):
    for part in ("g", "d", "g_ema", "ada"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def test_stage3_cli_world2_with_ada(tmp_path):
    faces = _faces(str(tmp_path / "faces"))
    ranks = run_ranks("stage3", str(tmp_path), 2, faces, str(tmp_path))
    for rk in ranks:
        rep = rk["report"]
        assert rep["world_size"] == 2 and rep["iter"] == 2
        assert len(rk["states"]) == 2 and len(rk["reduced"]) == 3
        assert rep["steps"][0]["r1"] > 0            # R1 at step 0
    # the metrics are global means, the same on both ranks
    assert ranks[0]["report"]["steps"] == [
        {**s, "seconds": a["seconds"]} for s, a in
        zip(ranks[1]["report"]["steps"], ranks[0]["report"]["steps"])]
    # both ranks hold the same G, D, g_ema and ADA state after each step
    for a, b in zip(ranks[0]["states"], ranks[1]["states"]):
        _equal_states(a, b)
    ada = ranks[0]["states"][-1]["ada"]
    assert int(ada["steps"]) == 2 and float(ada["count"]) == 8.0
    # only rank 0 wrote the checkpoint, the log and the samples
    out0, out1 = tmp_path / "out0", tmp_path / "out1"
    assert (out0 / "checkpoint" / "restore.pt").exists()
    assert (out0 / "checkpoint" / "restore_pipeline_init.pt").exists()
    assert any((out0 / "samples").iterdir())
    assert not out1.exists() or not any(out1.rglob("*.*"))
    ck = torch.load(out0 / "checkpoint" / "restore.pt", weights_only=True)
    assert ck["iter"] == 2
    _equal_states({"g": ck["g"], "d": ck["d"], "g_ema": ck["g_ema"],
                   "ada": ck["ada"]}, ranks[1]["states"][-1])
    shutil.rmtree(out0)     # ~0.65 GB of checkpoints at the tiny config

    # step 0's reduced gradients (D, R1's D, G) against the mean of the
    # halves' gradients computed in this process
    with one_thread():
        local = _halves_in_one_process(
            _stage3_argv(faces, str(tmp_path / "unused")),
            [rk["batch"] for rk in ranks])
    for i in range(3):
        for k, (x, y) in enumerate(zip(local[0][i], local[1][i])):
            for rk in ranks:
                torch.testing.assert_close(rk["reduced"][i][k], (x + y) / 2,
                                           rtol=1e-6, atol=1e-9)
        for r in range(2):
            for a, b in zip(ranks[r]["local"][i], local[r][i]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# -- (v) minibatch_stddev: per rank -----------------------------------------

def test_minibatch_stddev_is_per_rank():
    """The port's D groups each rank's own rows (the reference's DDP). So
    at world 2 its result is JAX's `minibatch_stddev` applied to each half;
    the JAX package's sharded step applies it to the global batch, whose
    groups {j, j + b/g, ...} cross the ranks, and differs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from vspbfr_tpu.models.layers import minibatch_stddev as jax_stddev
    from vspbfr_tpu_torch.models.layers import minibatch_stddev

    x = np.random.default_rng(8).standard_normal((8, 4, 4, 16)).astype(
        np.float32)
    halves = [x[local_batch_slice(8, r, 2)] for r in range(2)]
    port = np.concatenate([minibatch_stddev(torch.tensor(h)).numpy()
                           for h in halves])
    per_rank = np.concatenate([np.asarray(jax_stddev(jnp.asarray(h)))
                               for h in halves])
    whole = np.asarray(jax_stddev(jnp.asarray(x)))
    np.testing.assert_allclose(port, per_rank, rtol=1e-5, atol=1e-6)
    assert np.abs(port[..., -1] - whole[..., -1]).max() > 1e-2


if __name__ == "__main__":
    import datetime

    from vspbfr_tpu_torch.parallel import mesh

    mesh.DEFAULT_TIMEOUT = datetime.timedelta(seconds=GROUP_TIMEOUT)
    mode, out, *rest = sys.argv[1:]
    {"stage2": _stage2_rank, "stage3": _stage3_rank}[mode](out, *rest)
