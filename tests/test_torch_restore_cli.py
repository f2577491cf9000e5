"""The stage-3 training CLI of the port, on the CPU at the tiny config.

`cli/train_restore.py --tiny` trains one step with a checkpoint; a resume
from it runs the second step, which must end where an uninterrupted
two-step run ends (losses equal to 1e-6: the same draws, the same
order); the inference export loads into `cli/infer.py`. With `--augment`
the checkpoint holds the ADA state, and a resumed second step continues
it (the same ada_p; the controller's counts of both steps). The parity
of the step itself with the JAX package is
`tests/test_torch_restore_train.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _faces(tmp_path, n=4, size=32):
    rng = np.random.default_rng(9)
    d = tmp_path / "faces"
    d.mkdir()
    for i in range(n):
        np.save(d / f"f{i}.npy",
                (rng.random((size, size, 3)) * 255).astype(np.uint8))
    return str(d)


def test_cli_trains_resumes_and_exports(tmp_path):
    from vspbfr_tpu_torch.cli import infer
    from vspbfr_tpu_torch.cli import train_restore as cli
    from vspbfr_tpu_torch.utils import load_checkpoint

    path = _faces(tmp_path)
    base = ["--path", path, "--device", "cpu", "--tiny", "--size", "32",
            "--decoder_size", "64", "--batch", "2", "--id_loss_weight", "0",
            "--show_inter", "1", "--save_inter", "1"]
    a = str(tmp_path / "a")
    rep = cli.main(base + ["--iter", "1", "--out", a])
    assert rep["start_iter"] == 0 and rep["iter"] == 1
    step = rep["steps"][0]
    assert all(np.isfinite(step[k]) for k in ("d", "r1", "g", "gan",
                                              "percept"))
    assert step["r1"] > 0                   # R1 at step 0
    ck_path = tmp_path / "a" / "checkpoint" / "restore.pt"
    ck = load_checkpoint(str(ck_path))
    assert ck["iter"] == 1 and ck["g_step"] == 1 and ck["d_step"] == 2
    assert any((tmp_path / "a" / "samples").iterdir())

    rep = cli.main(base + ["--iter", "2", "--out", a, "--ckpt",
                           str(ck_path)])
    assert rep["start_iter"] == 1 and len(rep["steps"]) == 1
    straight = cli.main(base + ["--iter", "2", "--out",
                                str(tmp_path / "b")])
    for k in ("d", "g", "percept"):
        assert straight["steps"][-1][k] == pytest.approx(
            rep["steps"][-1][k], rel=1e-6)

    lq = tmp_path / "lq"
    lq.mkdir()
    np.save(lq / "x.npy", np.random.default_rng(10).uniform(
        -1, 1, (32, 32, 3)).astype(np.float32))
    out = infer.main(["--lq_dirs", str(lq), "--ckpt",
                      str(tmp_path / "a" / "checkpoint"
                          / "restore_pipeline.pt"),
                      "--size", "32", "--decoder_size", "64", "--tiny",
                      "--device", "cpu", "--batch", "1", "--out",
                      str(tmp_path / "eval")])
    assert out["datasets"]["data0"]["n"] == 1

    aug = base + ["--augment", "--ada_length", "1000"]
    c = tmp_path / "c"
    rep = cli.main(aug + ["--iter", "1", "--out", str(c)])
    assert rep["steps"][0]["ada_p"] == 0.0
    assert np.isfinite(rep["steps"][0]["ada_rt"])
    ck_path = c / "checkpoint" / "restore.pt"
    ada = load_checkpoint(str(ck_path))["ada"]
    assert int(ada["steps"]) == 1 and float(ada["count"]) == 2.0
    # the resumed step continues the controller: its p, and the counts
    # of both steps in the checkpoint it writes
    rep = cli.main(aug + ["--iter", "2", "--out", str(c), "--ckpt",
                          str(ck_path)])
    assert rep["start_iter"] == 1
    assert rep["steps"][-1]["ada_p"] == float(ada["p"])
    ada2 = load_checkpoint(str(ck_path))["ada"]
    assert int(ada2["steps"]) == 2 and float(ada2["count"]) == 4.0
    assert float(ada2["sign_sum"]) - float(ada["sign_sum"]) == 2 * \
        rep["steps"][-1]["ada_rt"]
