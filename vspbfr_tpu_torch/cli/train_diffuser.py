"""Stage-2 code-diffuser training CLI (the reference's
`code_diffuser_train.py`).

Counterpart of `vspbfr_tpu/cli/train_diffuser.py`. Flags
mirror `code_diffuser_train.py:249-273` upstream; the loop body is one
`DiffuserTrainer.train_step`. The data are degraded on the training
device (`--loader device`, with the JPEG round-trip there or, `--jpeg
host`, exact on the CPU) or wholly on the CPU (`--loader host`; `auto` is
the device chain unless `--device cpu`); GT files are PNG/JPG or uint8
HWC `.npy`. Without `--psp_ckpt` (a port psp state_dict)
the weights are random, drawn from `--seed`.

Data parallel under torchrun (`parallel/`): one process a rank, `--batch`
rows a rank (the global batch is `--batch` x world), NCCL with a card a
rank, gloo on the CPU or when ranks share a card. Rank 0 writes the log,
the samples and the checkpoints; every rank reads `--ckpt`.

    python -m vspbfr_tpu_torch.cli.train_diffuser --path FACES --device cuda
    torchrun --standalone --nproc_per_node 4 -m \\
        vspbfr_tpu_torch.cli.train_diffuser --path FACES
    python -m vspbfr_tpu_torch.cli.train_diffuser --path FACES --device cpu \\
        --tiny --size 32 --decoder_size 64 --batch 2 --iter 2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from vspbfr_tpu_torch.cli.common import (
    add_loader_flags,
    add_packed_min_res,
    build_loader,
    check_packed_min_res,
    tiny_pipeline_kwargs,
    train_batch,
    wire_loss_nets,
)
from vspbfr_tpu_torch.data import RestoreTrainDataset, save_image
from vspbfr_tpu_torch.parallel import (
    DataParallel,
    distributed,
    process_barrier,
)
from vspbfr_tpu_torch.pipeline import RestorationPipeline
from vspbfr_tpu_torch.train.diffuser_train import (
    DiffuserTrainConfig,
    DiffuserTrainer,
)
from vspbfr_tpu_torch.utils import (
    GracefulShutdown,
    Logger,
    load_checkpoint,
    save_checkpoint,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", type=str, required=True,
                   help="GT face directory (PNG/JPG or uint8 HWC .npy)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iter", type=int, default=200_000)
    p.add_argument("--batch", type=int, default=16,
                   help="rows a rank (per card); the global batch is this "
                        "x the world size")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--percept_loss_weight", type=float, default=0.1)
    p.add_argument("--id_loss_weight", type=float, default=0.1)
    p.add_argument("--timesteps", type=int, default=4)
    p.add_argument("--channel_multiplier", type=int, default=2,
                   help="StyleGAN2 channel multiplier (config-f = 2)")
    p.add_argument("--train_dtype", choices=("f32", "bf16"), default="f32",
                   help="bf16 = the image-space decode (forward and "
                        "backward) and the loss-net trunks in bf16; the "
                        "latent chain stays f32")
    add_loader_flags(p)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step; --batch is the "
                        "optimizer batch (--batch 16 --grad_accum 2 runs "
                        "2 x 8)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="resume from this full training checkpoint")
    p.add_argument("--psp_ckpt", type=str, default=None,
                   help="port psp state_dict (torch.save)")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="port LPIPS state_dict (VGG16 + lin weights)")
    p.add_argument("--arcface_ckpt", type=str, default=None,
                   help="port ResNet101Embedder state_dict (Arcface.pth)")
    p.add_argument("--out", type=str, default="diffuser_out")
    p.add_argument("--save_inter", type=int, default=500)
    p.add_argument("--show_inter", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decoder_size", type=int, default=1024,
                   help="frozen StyleGAN2 decoder resolution")
    add_packed_min_res(p)
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N steps (after 4 warm-up steps) with "
                        "torch.profiler into <out>/trace")
    p.add_argument("--debug", action="store_true",
                   help="400-image subset + short intervals")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    p.add_argument("--tiny", action="store_true",
                   help="test-size networks (one-unit IR-SE body, 64 px "
                        "encode, conv towers / 8) for runs on the CPU")
    return p


def full_ckpt_tree(trainer: DiffuserTrainer, gen: torch.Generator,
                   it: int) -> dict:
    """Params + optimizer state + step + RNG state + iteration: the
    reference's full resume payload (`code_diffuser_train.py:233-244`)."""
    st = trainer.state.state_dict()
    return {"diffuser": st["params"], "opt": st["opt"], "step": st["step"],
            "rng": gen.get_state(), "iter": it}


def restore_full_ckpt(path: str, trainer: DiffuserTrainer,
                      gen: torch.Generator) -> int:
    """Load a `full_ckpt_tree` checkpoint into the trainer and the
    generator; returns the iteration to continue from."""
    ck = load_checkpoint(path)
    trainer.state.load_state_dict({"params": ck["diffuser"],
                                   "opt": ck["opt"], "step": ck["step"]})
    gen.set_state(ck["rng"])
    return int(ck["iter"])


@torch.no_grad()
def _samples(trainer: DiffuserTrainer, low, real, it: int):
    """The visual checkpoint (`code_diffuser_train.py:214-231`): decodes of
    the refined latent, of the degraded-encode latent and of the GT
    inversion."""
    psp, dev = trainer.psp, low.device
    gen = torch.Generator(device=dev).manual_seed(it)
    low_lat = psp.get_w_plus(low)
    refined = trainer.pipe.diffuse_latent(
        low_lat, torch.randn(low_lat.shape, generator=gen, device=dev))
    target = psp.get_w_plus(real)
    return [psp.decode(lat, generator=gen) for lat in (refined, low_lat,
                                                       target)]


def build_trainer(args, device, dp: DataParallel) -> DiffuserTrainer:
    """The trainer the flags describe, its weights drawn from `--seed` or
    read from the checkpoints, on `device`, with rank 0's diffuser on every
    rank."""
    cfg = DiffuserTrainConfig(
        size=args.size, batch=args.batch, lr=args.lr,
        percept_weight=args.percept_loss_weight,
        id_weight=args.id_loss_weight, timesteps=args.timesteps,
        grad_accum=args.grad_accum,
        compute_dtype="bfloat16" if args.train_dtype == "bf16" else None)
    pipe = RestorationPipeline(size=args.size, timesteps=args.timesteps,
                               decoder_size=args.decoder_size,
                               channel_multiplier=args.channel_multiplier,
                               packed_min_res=args.packed_min_res,
                               **tiny_pipeline_kwargs(args.tiny))
    trainer = DiffuserTrainer(cfg, pipe, dp).init_from_seed(args.seed)
    if args.psp_ckpt:
        trainer.psp.load_state_dict(load_checkpoint(args.psp_ckpt))
    wire_loss_nets(trainer.lpips, trainer.id_net, args.lpips_ckpt,
                   args.arcface_ckpt, args.percept_loss_weight,
                   args.id_loss_weight)
    trainer.to(device)
    dp.replicate(trainer.diffuser)
    return trainer


def main(argv=None) -> dict:
    """Run the CLI; returns {"start_iter", "iter", "world_size", "steps":
    [{"it", "seconds", metric: value}]} with per-step host-clock seconds,
    each ending in a device sync (reading the metrics), the metrics
    averaged over the ranks."""
    p = build_parser()
    args = p.parse_args(argv)
    check_packed_min_res(p, args)
    if args.debug:
        args.save_inter, args.show_inter = 20, 200
    with distributed(args.device) as device:
        return _train(args, device)


def _train(args, device) -> dict:
    dp = DataParallel()
    print(f"world={dp.world_size} global_batch={args.batch * dp.world_size}",
          flush=True)
    trainer = build_trainer(args, device, dp)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    start_iter = 0
    if args.ckpt:
        start_iter = restore_full_ckpt(args.ckpt, trainer, gen)

    # stage-2 data: one degraded copy, uint8-round-tripped GT, no random
    # gray (ImageFolder_restore upstream)
    ds = RestoreTrainDataset(args.path, im_size=(args.size, args.size),
                             n_degraded=1, quantize_gt=True, gray_prob=None,
                             seed=args.seed,
                             subset=400 if args.debug else None)
    loader = build_loader(args, ds, device, dp)
    # rank 0 alone logs, samples and saves; a barrier follows each save
    logger = Logger(args.out) if dp.is_lead else None
    ckpt_dir = os.path.join(args.out, "checkpoint")
    if start_iter == 0:
        # export the frozen psp this diffuser is trained against, so stage
        # 3 and inference can load a consistent encoder and decoder
        if dp.is_lead:
            save_checkpoint(os.path.join(ckpt_dir, "psp.pt"),
                            trainer.psp.state_dict())
        process_barrier("psp export")

    stop = GracefulShutdown()
    steps, prof = [], None
    it = start_iter
    start_epoch, start_batch = divmod(start_iter, loader.batches_per_epoch())
    stopping = False
    try:
        t0 = time.perf_counter()
        for batch in loader.forever(start_epoch, start_batch):
            if it >= args.iter or stopping:
                break
            lq, gt = train_batch(batch, device)
            metrics = trainer.train_step(lq, gt, generator=gen)
            m = {k: float(v) for k, v in metrics.items()}
            it += 1
            # a signal on any rank stops every rank after this step, so
            # none waits alone in a collective
            stopping = dp.any_(stop.requested, device)
            t1 = time.perf_counter()
            steps.append({"it": it, "seconds": t1 - t0, **m})
            t0 = t1
            if args.profile:
                if it == start_iter + 4:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        *([torch.profiler.ProfilerActivity.CUDA]
                          if device.type == "cuda" else [])])
                    prof.__enter__()
                elif it == start_iter + 4 + args.profile and prof:
                    prof.__exit__(None, None, None)
                    os.makedirs(os.path.join(args.out, "trace"),
                                exist_ok=True)
                    prof.export_chrome_trace(
                        os.path.join(args.out, "trace", "trace.json"))
                    prof = None
            if it % 10 == 0 and dp.is_lead:
                logger.log(it, m)
                if it % 100 == 0:
                    print(f"[{it}] " + " ".join(f"{k}:{v:.4f}"
                                                for k, v in m.items()))
            if it % args.show_inter == 0 and dp.is_lead:
                refined, ori, real_inv = _samples(trainer, lq[:4], gt[:4], it)
                os.makedirs(os.path.join(args.out, "samples"), exist_ok=True)
                rows = [x.float().cpu().numpy() for x in
                        (lq[:4], refined, ori, real_inv, gt[:4])]
                grid = np.concatenate([np.concatenate(list(r), axis=1)
                                       for r in rows], axis=0)
                save_image(os.path.join(args.out, "samples", f"{it:06d}"),
                           grid)
            if it % args.save_inter == 0 or stopping:
                if dp.is_lead:
                    save_checkpoint(os.path.join(ckpt_dir,
                                                 "code_diffuser.pt"),
                                    full_ckpt_tree(trainer, gen, it))
                process_barrier("checkpoint")
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        stop.restore()
    if stopping:
        print(f"[shutdown] checkpoint committed at iter {it}", flush=True)
    return {"start_iter": start_iter, "iter": it,
            "world_size": dp.world_size, "steps": steps}


if __name__ == "__main__":
    main()
