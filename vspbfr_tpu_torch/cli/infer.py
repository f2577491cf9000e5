"""Batch restoration inference CLI (the `restoration_test.py` product path).

Counterpart of `vspbfr_tpu/cli/infer.py`: runs the pipeline over one or
more image directories, writes restored/low/sample/gt images, and scores
PSNR/SSIM where GT is given, LPIPS with `--lpips_ckpt` and standard FID
(InceptionV3 pool3) with `--inception_ckpt`, on the device the pipeline
runs on; each dataset's count and scores are appended to
`<out>/<name>/<name>.log` (`utils.Logger`). `--ckpt`, `--lpips_ckpt` and
`--inception_ckpt` take port state_dicts saved with `torch.save` (from the
reference's `.pt` files through `cli/convert_ckpt.py`, from JAX
checkpoints through `orbax_to_torch.py`); without `--ckpt` the pipeline's
weights are random, drawn from `--seed`.

    python -m vspbfr_tpu_torch.cli.infer --lq_dirs DIR --device cuda --bf16
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from vspbfr_tpu_torch.cli.common import (
    add_packed_min_res,
    check_packed_min_res,
    tiny_pipeline_kwargs,
)
from vspbfr_tpu_torch.data import RestoreTestDataset, save_image
from vspbfr_tpu_torch.evaluation import PairScorer
from vspbfr_tpu_torch.losses import (
    LPIPS,
    InceptionV3Features,
    make_inception_feature_fn,
)
from vspbfr_tpu_torch.pipeline import RestorationPipeline
from vspbfr_tpu_torch.utils import Logger, load_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lq_dirs", nargs="+", required=True,
                   help="low-quality input dirs (PNG/JPG or [-1,1] HWC .npy)")
    p.add_argument("--hq_dirs", nargs="+", default=None,
                   help="matching GT dirs ('None' entries allowed)")
    p.add_argument("--names", nargs="+", default=None, help="dataset names")
    p.add_argument("--ckpt", type=str, default=None,
                   help="port state_dict file (torch.save) of the pipeline")
    p.add_argument("--out", type=str, default="eval_out")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--mixing", type=float, default=0.5,
                   help="latent-mixing probability "
                        "(`restoration_test.py:214`)")
    p.add_argument("--channel_multiplier", type=int, default=2,
                   help="StyleGAN2 channel multiplier (config-f = 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decoder_size", type=int, default=1024,
                   help="frozen StyleGAN2 decoder resolution")
    add_packed_min_res(p)
    p.add_argument("--debug", action="store_true",
                   help="truncate each dataset to 10 batches")
    p.add_argument("--save_images", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--lpips_ckpt", default=None,
                   help="port LPIPS state_dict (VGG16 + lin weights): adds "
                        "LPIPS scoring")
    p.add_argument("--inception_ckpt", default=None,
                   help="port InceptionV3Features state_dict: adds standard "
                        "FID scoring")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 decoder + RestoreNet, f32 encode and DDPM")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--tiny", action="store_true",
                   help="test-size networks (as the trainer CLIs' --tiny), "
                        "for checkpoints they wrote on the CPU")
    return p


def _load(module, path, device):
    module.load_state_dict(load_checkpoint(path))
    return module.to(device).eval().requires_grad_(False)


def main(argv=None) -> dict:
    """Run the CLI; returns {"datasets": {name: {...}}} with per-batch
    seconds of `restore` and of the scoring (host clock, each ending in a
    device sync) and the scores."""
    p = build_parser()
    args = p.parse_args(argv)
    check_packed_min_res(p, args)
    device = torch.device(args.device)
    pipe = RestorationPipeline(size=args.size, decoder_size=args.decoder_size,
                               mixing_prob=args.mixing,
                               channel_multiplier=args.channel_multiplier,
                               compute_dtype=torch.bfloat16 if args.bf16
                               else None,
                               packed_min_res=args.packed_min_res,
                               **tiny_pipeline_kwargs(args.tiny))
    if args.ckpt:
        sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        pipe.load_state_dict(sd)
    else:
        print("WARNING: no --ckpt; random weights (smoke-test mode)")
        pipe.init_from_seed(args.seed)
    pipe = pipe.to(device).eval().prepare_params()
    rng = torch.Generator(device=device).manual_seed(args.seed)

    lpips_apply = feature_fn = None
    if args.lpips_ckpt:
        lpips_apply = _load(LPIPS(), args.lpips_ckpt, device)
    if args.inception_ckpt:
        feature_fn = make_inception_feature_fn(
            _load(InceptionV3Features(), args.inception_ckpt, device))

    hq_dirs = args.hq_dirs or ["None"] * len(args.lq_dirs)
    names = args.names or [f"data{i}" for i in range(len(args.lq_dirs))]
    report = {}
    for lq_root, hq_root, name in zip(args.lq_dirs, hq_dirs, names):
        out_dir = os.path.join(args.out, name)
        os.makedirs(out_dir, exist_ok=True)
        ds = RestoreTestDataset(lq_root, None if hq_root == "None" else hq_root,
                                im_size=(args.size, args.size))
        scorer = PairScorer(lpips_apply=lpips_apply, feature_fn=feature_fn)
        n, seconds, score_seconds = 0, [], []
        for bi, (low, gt, fnames) in enumerate(ds.batches(args.batch)):
            if args.debug and bi >= 10:
                break
            t0 = time.perf_counter()
            low_t = torch.as_tensor(low, device=device)
            restored, sample = pipe.restore(low_t, rng, return_sample=True)
            restored_np = restored.float().cpu().numpy()
            sample_np = sample.float().cpu().numpy()
            seconds.append(time.perf_counter() - t0)
            if args.save_images:
                for j, fname in enumerate(fnames):
                    stem = os.path.join(out_dir, fname)
                    save_image(stem + "_restore", restored_np[j])
                    save_image(stem + "_low", low[j])
                    save_image(stem + "_sample", sample_np[j])
                    if gt is not None:
                        save_image(stem + "_gt", gt[j])
            if gt is not None:
                t0 = time.perf_counter()
                scorer.update(restored, torch.as_tensor(gt, device=device))
                score_seconds.append(time.perf_counter() - t0)
            n += low.shape[0]
        entry = {"n": n, "batch_seconds": seconds}
        if n and ds.hq_files is not None:
            scores = scorer.result()
            Logger(out_dir, name).log(n, scores)
            entry.update(scores, score_seconds=score_seconds)
            print(f"{name}: n={n} " + " ".join(
                f"{k}={entry[k]:.4f}" for k in ("psnr", "ssim", "lpips",
                                                "fid") if k in entry))
        else:
            print(f"{name}: n={n} (no GT)")
        report[name] = entry
    return {"datasets": report}


if __name__ == "__main__":
    main()
