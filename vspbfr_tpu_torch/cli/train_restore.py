"""Stage-3 RestoreNet GAN training CLI (the reference's
`restoration_train.py`).

Counterpart of `vspbfr_tpu/cli/train_restore.py`. Flags
mirror `restoration_train.py:310-342` upstream; the loop body is one
`RestoreTrainer.train_step` (embedding, D phase with the lazy R1, G phase,
EMA). The data are degraded on the training device (`--loader device`,
with the JPEG round-trip there or, `--jpeg host`, exact on the CPU) or
wholly on the CPU (`--loader host`: the C++ engine, no OpenCV; `auto` is
the device chain unless `--device cpu`); the host chain computes
`--n_degraded` copies a sample (the reference computes two and consumes
the first), GT in float with the 0.008 gray draw shared with the input. `--augment` turns
on ADA: adaptive toward `--ada_target` over `--ada_length` images, or at
the fixed probability `--augment_p` when that is > 0 (the reference's
flags). GT files are PNG/JPG or uint8 HWC `.npy`. Without `--psp_ckpt` /
`--diffuser_ckpt` the frozen stages are random, drawn from `--seed`.

Checkpoints, overwritten every `--save_inter` steps:
<out>/checkpoint/restore.pt (the full resume state: both optimisers, G,
D, g_ema, the ADA state, the RNG state and the iteration; `--ckpt`
resumes from it) and <out>/checkpoint/restore_pipeline.pt (the
inference-ready pipeline state_dict with g_ema as the generator, which
`cli/infer.py --ckpt` loads; `restore_pipeline_init.pt` holds the one
before the first step).

Data parallel under torchrun (`parallel/`): one process a rank, `--batch`
rows a rank (the reference's per-GPU batch; the global batch is `--batch`
x world), NCCL with a card a rank, gloo on the CPU or when ranks share a
card. Rank 0 writes the log, the samples and the checkpoints; every rank
reads `--ckpt`.

    python -m vspbfr_tpu_torch.cli.train_restore --path FACES --device cuda
    torchrun --standalone --nproc_per_node 4 -m \\
        vspbfr_tpu_torch.cli.train_restore --path FACES
    python -m vspbfr_tpu_torch.cli.train_restore --path FACES --device cpu \\
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
from vspbfr_tpu_torch.losses import ADAState
from vspbfr_tpu_torch.parallel import (
    DataParallel,
    distributed,
    process_barrier,
)
from vspbfr_tpu_torch.pipeline import RestorationPipeline
from vspbfr_tpu_torch.train.restore_train import (
    RestoreTrainConfig,
    RestoreTrainer,
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
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iter", type=int, default=500_000)
    p.add_argument("--batch", type=int, default=4,
                   help="rows a rank (per card); the global batch is this "
                        "x the world size")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--r1", type=float, default=10.0)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--mixing", type=float, default=0.5)
    p.add_argument("--train_dtype", choices=("f32", "bf16"), default="f32",
                   help="bf16 = G and D compute in bf16 with f32 params, "
                        "optimiser states, EMA, logits, losses and R1; f32 = "
                        "the reference's dtype")
    p.add_argument("--n_degraded", type=int, default=1, choices=(1, 2),
                   help="host chain: degraded copies per sample. The "
                        "reference computes 2 and consumes the first "
                        "(`dataset.py:302-303` vs `restoration_train.py:160` "
                        "upstream); 1 skips the unused chain, 2 repeats the "
                        "reference's loader. The device chain computes 1")
    add_loader_flags(p)
    p.add_argument("--percept_loss_weight", type=float, default=0.5)
    p.add_argument("--id_loss_weight", type=float, default=0.1)
    p.add_argument("--augment", action="store_true",
                   help="ADA: augment D's inputs (real, fake, R1's batch)")
    p.add_argument("--augment_p", type=float, default=0.0,
                   help="fixed augmentation probability; 0 = adaptive "
                        "(`restoration_train.py:138-141` upstream)")
    p.add_argument("--channel_multiplier", type=int, default=2,
                   help="StyleGAN2 channel multiplier (config-f = 2)")
    p.add_argument("--ada_target", type=float, default=0.6)
    p.add_argument("--ada_length", type=int, default=500 * 1000)
    p.add_argument("--ckpt", type=str, default=None,
                   help="resume from this full training checkpoint")
    p.add_argument("--psp_ckpt", type=str, default=None,
                   help="port psp state_dict (torch.save; stage 2 writes "
                        "one as checkpoint/psp.pt)")
    p.add_argument("--diffuser_ckpt", type=str, default=None,
                   help="stage-2 checkpoint (checkpoint/code_diffuser.pt)")
    p.add_argument("--lpips_ckpt", type=str, default=None,
                   help="port LPIPS state_dict (VGG16 + lin weights)")
    p.add_argument("--arcface_ckpt", type=str, default=None,
                   help="port ResNet101Embedder state_dict (Arcface.pth)")
    p.add_argument("--out", type=str, default="train_out")
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
                   help="short save/sample intervals")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    p.add_argument("--tiny", action="store_true",
                   help="test-size networks (one-unit IR-SE body, 64 px "
                        "encode, conv towers / 8) for runs on the CPU")
    return p


def full_ckpt_tree(trainer: RestoreTrainer, gen: torch.Generator,
                   it: int) -> dict:
    """Everything the reference persists (`restoration_train.py:291-305`
    upstream): G and D with both optimiser states and step counts, g_ema,
    the ADA state (with --augment), plus the RNG state and the
    iteration."""
    g, d = trainer.g_state.state_dict(), trainer.d_state.state_dict()
    tree = {"g": g["params"], "g_opt": g["opt"], "g_step": g["step"],
            "d": d["params"], "d_opt": d["opt"], "d_step": d["step"],
            "g_ema": trainer.g_ema.state_dict(), "rng": gen.get_state(),
            "iter": it}
    if trainer.ada_state is not None:
        tree["ada"] = trainer.ada_state._asdict()
    return tree


def restore_full_ckpt(path: str, trainer: RestoreTrainer,
                      gen: torch.Generator) -> int:
    """Load a `full_ckpt_tree` checkpoint into the trainer and the
    generator; returns the iteration to continue from."""
    ck = load_checkpoint(path)
    trainer.g_state.load_state_dict({"params": ck["g"], "opt": ck["g_opt"],
                                     "step": ck["g_step"]})
    trainer.d_state.load_state_dict({"params": ck["d"], "opt": ck["d_opt"],
                                     "step": ck["d_step"]})
    trainer.g_ema.load_state_dict(ck["g_ema"])
    if trainer.ada_state is not None and "ada" in ck:
        trainer.ada_state = ADAState(**ck["ada"]).to(trainer.device)
    gen.set_state(ck["rng"])
    return int(ck["iter"])


def build_trainer(args, device, dp: DataParallel) -> RestoreTrainer:
    """The trainer the flags describe, its weights drawn from `--seed` or
    read from the checkpoints, on `device`, with rank 0's trained modules
    on every rank."""
    cfg = RestoreTrainConfig(
        size=args.size, batch=args.batch, lr=args.lr, r1=args.r1,
        d_reg_every=args.d_reg_every, g_reg_every=args.g_reg_every,
        percept_weight=args.percept_loss_weight,
        id_weight=args.id_loss_weight, mixing=args.mixing,
        augment=args.augment, augment_p=args.augment_p,
        ada_target=args.ada_target, ada_length=args.ada_length,
        compute_dtype="bfloat16" if args.train_dtype == "bf16" else None)
    pipe = RestorationPipeline(size=args.size, mixing_prob=args.mixing,
                               decoder_size=args.decoder_size,
                               channel_multiplier=args.channel_multiplier,
                               packed_min_res=args.packed_min_res,
                               **tiny_pipeline_kwargs(args.tiny))
    trainer = RestoreTrainer(cfg, pipe, dp).init_from_seed(args.seed)
    if args.psp_ckpt:
        trainer.psp.load_state_dict(load_checkpoint(args.psp_ckpt))
    if args.diffuser_ckpt:
        trainer.diffuser.load_state_dict(
            load_checkpoint(args.diffuser_ckpt)["diffuser"])
    wire_loss_nets(trainer.lpips, trainer.id_net, args.lpips_ckpt,
                   args.arcface_ckpt, args.percept_loss_weight,
                   args.id_loss_weight)
    return trainer.to(device).replicate()


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

    # stage-3 data (ImageFolder_restore_free_form upstream): float GT, the
    # 0.008 gray draw applied to the input and the GT alike
    ds = RestoreTrainDataset(args.path, im_size=(args.size, args.size),
                             n_degraded=args.n_degraded, quantize_gt=False,
                             gray_prob=0.008, seed=args.seed)
    loader = build_loader(args, ds, device, dp)
    # rank 0 alone logs, samples and saves (`get_rank() == 0` upstream,
    # `restoration_train.py:258,278,291`); a barrier follows each save
    logger = Logger(args.out) if dp.is_lead else None
    ckpt_dir = os.path.join(args.out, "checkpoint")
    if start_iter == 0:
        if dp.is_lead:
            save_checkpoint(os.path.join(ckpt_dir,
                                         "restore_pipeline_init.pt"),
                            trainer.export_state_dict())
        process_barrier("init export")

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
                # visual checkpoint with the EMA generator
                # (`restoration_train.py:278-288` upstream)
                rng = torch.Generator(device=device).manual_seed(it)
                sample = trainer.pipe.restore(lq[:4], rng, gen=trainer.g_ema)
                os.makedirs(os.path.join(args.out, "samples"), exist_ok=True)
                rows = [x.float().cpu().numpy() for x in (lq[:4], sample,
                                                          gt[:4])]
                grid = np.concatenate([np.concatenate(list(r), axis=1)
                                       for r in rows], axis=0)
                save_image(os.path.join(args.out, "samples", f"{it:06d}"),
                           grid)
            if it % args.save_inter == 0 or stopping:
                if dp.is_lead:
                    save_checkpoint(os.path.join(ckpt_dir, "restore.pt"),
                                    full_ckpt_tree(trainer, gen, it))
                    save_checkpoint(os.path.join(ckpt_dir,
                                                 "restore_pipeline.pt"),
                                    trainer.export_state_dict())
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
