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
`VSPBFR_FUSED_EPI=1` (K1e in place of K1 plus K6). It prints:

- the card's name and power limit (`nvidia-smi`);
- the traced call's wall time (host clock, ending in a device sync);
- device time by group: the hand-written kernels (K1 dense conv, K1e its
  fused epilogue form, K2 multi-dilation conv, K3 phase interleave, K4
  phase gather, K5 fused SMART core, K6 styled epilogue, K7 bias + leaky
  ReLU) with their launch counts, the library convs, GEMMs, elementwise,
  reductions, copies and the rest;
- the device's busy and idle share of the traced window (the union of the
  kernels' intervals over the time from the call's first host op to the
  last kernel's end);
- the 15 kernels with the most device time, so a group's contents can be
  checked.

`--smart` is K5's entry point (the counterpart of
`scripts/exp_smart_kernel.py`): at each distinct SMART shape of RestoreNet
at full width, b4, it times K5 (`ops.smart_core`) against the composition
`SMARTLayer` runs (K2 through `modulated_conv2d_multi`, then K1 for the
fusion conv, without the epilogue): CUDA-event medians, their max
difference relative to max |composition|, K5's tile side, the bound
(operations over the taps inside the image, or bytes) and the launches.

    python -m vspbfr_tpu_torch.cli.profile                # f32
    python -m vspbfr_tpu_torch.cli.profile --bf16 --out profile_bf16.json
    python -m vspbfr_tpu_torch.cli.profile --train [--bf16]
    python -m vspbfr_tpu_torch.cli.profile --restore [--bf16] [--fused_epi]
    python -m vspbfr_tpu_torch.cli.profile --smart [--bf16]

Needs a CUDA device: a trace that holds no device kernel raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vspbfr_tpu_torch import ops
from vspbfr_tpu_torch.ops.smart import RATES, smart_tile
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
# RestoreNet's distinct SMART shapes at full width: (image side, channels)
SMART_SHAPES = ((512, 64), (256, 128), (128, 256), (64, 512), (32, 512),
                (16, 512), (8, 512), (4, 512))
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense): f32 on
# the CUDA cores, bf16 on the tensor cores, and the HBM rate
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# (group, substrings of the kernel name), first match wins
GROUPS = (
    ("K1e dense_conv_epilogue", ("dense_conv_kernel<float, true>",
                                 "dense_conv_kernel<__nv_bfloat16, true>")),
    ("K1 dense_conv", ("dense_conv_kernel",)),
    ("K2 dilated_multi_conv", ("dilated_multi_kernel",)),
    ("K3 d2s", ("d2s_kernel",)),
    ("K4 s2d", ("s2d_kernel",)),
    ("K5 smart_core", ("smart_fused_kernel",)),
    ("K6 conv_epilogue", ("epilogue_kernel",)),
    ("K7 fused_leaky_relu", ("fused_lrelu_kernel",)),
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


def bound_ms(flops: float, moved: float, dt_name: str) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    larger of the operations over the dtype's peak rate and the bytes over
    the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dt_name], moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _taps_inside(n: int, d: int) -> int:
    """(output, tap) pairs of a 3-tap dilation-d 'same' conv along an axis
    of n whose input lies inside the image."""
    return n + 2 * max(0, n - d)


def smart_work(b: int, h: int, w: int, c: int, cb: int, cout: int,
               itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of one K5 call: two per multiply-add over the
    taps that land inside the image (the four branches, then the fusion
    conv over the 4Cb branch channels), one multiply per input element for
    the style; x, style, both weight sets, the demod and y moved once."""
    mac = b * c * cb * sum(_taps_inside(h, d) * _taps_inside(w, d)
                           for d in RATES)
    mac += b * 4 * cb * cout * _taps_inside(h, 1) * _taps_inside(w, 1)
    elems = (b * h * w * c + b * c + 9 * c * 4 * cb + b * 4 * cb
             + 9 * 4 * cb * cout + b * h * w * cout)
    return 2 * mac + b * h * w * c, elems * itemsize


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smart_composition(x, style, ws, wf) -> torch.Tensor:
    """The SMART core as `SMARTLayer` computes it, with K5's inputs: K2
    through `modulated_conv2d_multi`, then K1 for the fusion conv (without
    its epilogue)."""
    scale_f = 1.0 / math.sqrt(9 * wf.shape[2])
    br = ops.modulated_conv2d_multi(x, ws, RATES, style)
    return ops.dense_conv(br, (scale_f * wf).to(x.dtype).contiguous(),
                          ((1, 1), (1, 1)))


def profile_smart(dtype: torch.dtype, device="cuda", shapes=SMART_SHAPES,
                  batch: int = BATCH, timer=cuda_ms) -> list[dict]:
    """K5 against the composition SMARTLayer runs at each (side, C) of
    `shapes`, batch `batch`, in `dtype`: times (by `timer`), the max
    difference relative to max |composition|, the bound and the launches
    of each side's timed calls (counted as differences, so the launch
    counters keep running across the call)."""
    dt_name = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + offset).to(dtype)

    rows = []
    for side, c in shapes:
        cb = c // len(RATES)
        x = rand(batch, side, side, c)
        style = rand(batch, c, scale=0.2, offset=1.0)
        ws = [rand(3, 3, c, cb) for _ in RATES]
        wf = rand(3, 3, 4 * cb, c)

        def k5():
            return ops.smart_core(x, style, ws, wf)

        def composition():
            return smart_composition(x, style, ws, wf)

        with torch.no_grad():
            ref = composition().float()
            diff = float((k5().float() - ref).abs().max()
                         / ref.abs().max().clamp_min(1e-12))
            before = ops.launch_counts()
            k5_ms = timer(k5)
            mid = ops.launch_counts()
            comp_ms = timer(composition)
            after = ops.launch_counts()
        flops, moved = smart_work(batch, side, side, c, cb, c,
                                  x.element_size())
        b_ms, b_by = bound_ms(flops, moved, dt_name)
        rows.append(dict(
            size=side, channels=c, batch=batch, dtype=dt_name,
            tile=smart_tile(side, side, cb) if dev.type == "cuda" else None,
            k5_ms=k5_ms, composition_ms=comp_ms,
            composition_over_k5=comp_ms / k5_ms, max_rel_diff=diff,
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=moved,
            k5_launches=mid["smart_core"] - before["smart_core"],
            composition_launches={k: after[k] - mid[k] for k in
                                  ("dilated_multi_conv", "dense_conv")}))
    return rows


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
    p.add_argument("--smart", action="store_true",
                   help="time K5 against the K2 + K1 composition at every "
                        "RestoreNet SMART shape instead of tracing")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["VSPBFR_FUSED_EPI"] = "1" if args.fused_epi else "0"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    call = "restore"
    if args.smart:
        call, batch, size = "smart_core", BATCH, SIZE
        res = {"rows": profile_smart(torch.bfloat16 if args.bf16
                                     else torch.float32)}
    elif args.restore:
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
    if args.smart:
        for r in res["rows"]:
            print(f"[{res['card']}] smart_core {r['dtype']} b{r['batch']} "
                  f"{r['size']}px C{r['channels']} (tile {r['tile']}): K5 "
                  f"{r['k5_ms']:.4f} ms, K2 + K1 {r['composition_ms']:.4f} "
                  f"ms (x{r['composition_over_k5']:.3f}), max rel diff "
                  f"{r['max_rel_diff']:.3e}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), launches K5 {r['k5_launches']} / "
                  f"{r['composition_launches']}")
    else:
        print(f"[{res['card']}] {res['call']} {res['dtype']} b{batch} "
              f"{size}px: wall {res['wall_ms']:.3f} ms, device busy "
              f"{res['busy_ms']:.3f} ms of a {res['window_ms']:.3f} ms "
              f"window (idle share {res['idle_share']:.4f}), launches "
              f"{res['launches']}")
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
