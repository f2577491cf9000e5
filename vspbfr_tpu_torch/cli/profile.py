"""Trace one `restore` batch, or one stage-2 or stage-3 training step, and
say where the device time goes.

The port's counterpart of `scripts/profile_stages.py`. Builds the pipeline
at full width (512 px, 1024 px decoder) from seed 0, runs `restore` on a
batch of 4 twice to warm up, then once more under `torch.profiler` with
CUDA activity; with `--train`, the stage-2 trainer at full width (256 px,
1024 px decoder, b16) and its `train_step` instead; with `--restore`, the
stage-3 trainer at full width (512 px, 1024 px decoder, b4) and its
`train_step` (D update, R1, G update, EMA), with R1 made due at every call
(the G step count is set to 0 before each). `--fused_epi` sets
`VSPBFR_FUSED_EPI=1` (K1e in place of K1 plus the torch epilogue). It
prints:

- the card's name and power limit (`nvidia-smi`);
- the traced call's wall time (host clock, ending in a device sync);
- device time by group: the hand-written kernels (K1 dense conv, K1e its
  fused epilogue form, K2 multi-dilation conv, K3 phase interleave, K4
  phase gather) with their
  launch counts, the library convs, GEMMs, elementwise, reductions, copies
  and the rest;
- the device's busy and idle share of the traced window (the union of the
  kernels' intervals over the time from the call's first host op to the
  last kernel's end);
- the 15 kernels with the most device time, so a group's contents can be
  checked.

    python -m vspbfr_tpu_torch.cli.profile                # f32
    python -m vspbfr_tpu_torch.cli.profile --bf16 --out profile_bf16.json
    python -m vspbfr_tpu_torch.cli.profile --train [--bf16]
    python -m vspbfr_tpu_torch.cli.profile --restore [--bf16] [--fused_epi]

Needs a CUDA device: a trace that holds no device kernel raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vspbfr_tpu_torch import ops
from vspbfr_tpu_torch.pipeline import RestorationPipeline
from vspbfr_tpu_torch.train.diffuser_train import (
    DiffuserTrainConfig,
    DiffuserTrainer,
)
from vspbfr_tpu_torch.train.restore_train import (
    RestoreTrainConfig,
    RestoreTrainer,
)

BATCH, SIZE, DECODER_SIZE, SEED, WARMUP = 4, 512, 1024, 0, 2
TRAIN_BATCH, TRAIN_SIZE = 16, 256
# (group, substrings of the kernel name), first match wins
GROUPS = (
    ("K1e dense_conv_epilogue", ("dense_conv_kernel<float, true>",
                                 "dense_conv_kernel<__nv_bfloat16, true>")),
    ("K1 dense_conv", ("dense_conv_kernel",)),
    ("K2 dilated_multi_conv", ("dilated_multi_kernel",)),
    ("K3 d2s", ("d2s_kernel",)),
    ("K4 s2d", ("s2d_kernel",)),
    ("library conv", ("cudnn", "fprop", "dgrad", "conv", "winograd",
                      "implicit")),
    ("gemm", ("gemm", "gemv")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce", "norm", "softmax")),
    ("copy", ("copy", "memcpy", "memset", "cat")),
)


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(events) -> dict:
    """Group the trace's device kernels; busy share over the window from
    the first host op to the last kernel's end."""
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device kernel")
    window_start_us = min(e.time_range.start for e in events
                          if e.device_type == DeviceType.CPU)
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        group = kernel_group(e.name)
        by_group[group] = by_group.get(group, 0.0) + dur
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += dur
        rec[1] += 1
    window = max(e.time_range.end for e in kernels) - window_start_us
    busy = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "device_ms_by_group": {g: us / 1e3 for g, us in
                               sorted(by_group.items(), key=lambda kv: -kv[1])},
        "device_ms_total": sum(by_group.values()) / 1e3,
        "window_ms": window / 1e3,
        "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window,
        "n_kernels": len(kernels),
        "top_kernels": [{"name": n[:120], "ms": v[0] / 1e3, "calls": v[1]}
                        for n, v in top],
    }


def profile_restore(pipe: RestorationPipeline, low: torch.Tensor) -> dict:
    """Warm up, then trace one `restore(low, return_sample=True)` (the
    infer CLI's call) on `low`'s device."""
    def run():
        rng = torch.Generator(device=low.device).manual_seed(SEED)
        return pipe.restore(low, rng, return_sample=True)

    return _profile(run)


def profile_train_step(trainer, low: torch.Tensor, real: torch.Tensor,
                       r1_every_call: bool = False) -> dict:
    """Warm up, then trace one `train_step` (forward, backward, Adam) of a
    `DiffuserTrainer` or a `RestoreTrainer`; with r1_every_call the
    latter's G step count is set to 0 before each call, so its R1 runs."""
    gen = torch.Generator(device=low.device).manual_seed(SEED)

    def run():
        if r1_every_call:
            trainer.g_state.step = 0
        return trainer.train_step(low, real, generator=gen)

    return _profile(run)


def _profile(run) -> dict:
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"wall_ms": wall * 1e3, "launches": ops.launch_counts(),
            **summarize(prof.events())}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bf16", action="store_true",
                   help="bf16 decoder (+ RestoreNet, or + loss-net trunks "
                        "with --train); encode and DDPM stay f32")
    p.add_argument("--train", action="store_true",
                   help="trace a stage-2 training step instead of restore")
    p.add_argument("--restore", action="store_true",
                   help="trace a stage-3 training step (with R1) instead")
    p.add_argument("--fused_epi", action="store_true",
                   help="VSPBFR_FUSED_EPI=1: the styled convs through K1e")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["VSPBFR_FUSED_EPI"] = "1" if args.fused_epi else "0"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    call = "restore"
    if args.restore:
        call, batch, size = "restore_train_step", BATCH, SIZE
        trainer = RestoreTrainer(
            RestoreTrainConfig(size=size, batch=batch,
                               compute_dtype="bfloat16" if args.bf16
                               else None),
            RestorationPipeline(size=size, decoder_size=DECODER_SIZE))
        trainer = trainer.init_from_seed(SEED).to("cuda")
        low, real = (torch.rand((batch, size, size, 3), generator=gen,
                                device="cuda") * 2 - 1 for _ in range(2))
        res = profile_train_step(trainer, low, real, r1_every_call=True)
    elif args.train:
        call = "train_step"
        batch, size = TRAIN_BATCH, TRAIN_SIZE
        trainer = DiffuserTrainer(
            DiffuserTrainConfig(compute_dtype="bfloat16" if args.bf16
                                else None),
            RestorationPipeline(size=size, decoder_size=DECODER_SIZE))
        trainer = trainer.init_from_seed(SEED).to("cuda")
        low, real = (torch.rand((batch, size, size, 3), generator=gen,
                                device="cuda") * 2 - 1 for _ in range(2))
        res = profile_train_step(trainer, low, real)
    else:
        batch, size = BATCH, SIZE
        pipe = RestorationPipeline(
            size=size, decoder_size=DECODER_SIZE,
            compute_dtype=torch.bfloat16 if args.bf16 else None)
        pipe = pipe.init_from_seed(SEED).cuda().eval().prepare_params()
        low = torch.rand((batch, size, size, 3), generator=gen,
                         device="cuda") * 2 - 1
        res = profile_restore(pipe, low)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    res.update(card=card.splitlines()[0].strip(), batch=batch, size=size,
               decoder_size=DECODER_SIZE, dtype="bf16" if args.bf16 else "f32",
               call=call, fused_epi=args.fused_epi,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"[{res['card']}] {res['call']} {res['dtype']} b{batch} {size}px: "
          f"wall {res['wall_ms']:.3f} ms, device busy {res['busy_ms']:.3f} "
          f"ms of a {res['window_ms']:.3f} ms window (idle share "
          f"{res['idle_share']:.4f}), launches {res['launches']}")
    for g, ms in res["device_ms_by_group"].items():
        print(f"  {g:24s} {ms:10.3f} ms")
    for k in res["top_kernels"]:
        print(f"  {k['ms']:10.3f} ms {k['calls']:5d}x  {k['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
