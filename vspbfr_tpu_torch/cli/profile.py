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
fusion conv, without the epilogue), the two in turns, both per call
(`cuda_ms`) and on the device alone (`device_ms`, cold L2): their max
difference relative to max |composition|, K5's launch plan
(`ops.smart.smart_plan`), the bound (operations over the taps inside the
image, or bytes) and the launches. `--designs` adds K5's device time
with one block a tile (cluster 1) and with one branch a block (cluster 4),
in turns.

    python -m vspbfr_tpu_torch.cli.profile                # f32
    python -m vspbfr_tpu_torch.cli.profile --bf16 --out profile_bf16.json
    python -m vspbfr_tpu_torch.cli.profile --train [--bf16]
    python -m vspbfr_tpu_torch.cli.profile --restore [--bf16] [--fused_epi]
    python -m vspbfr_tpu_torch.cli.profile --smart [--bf16] [--designs]
    python -m vspbfr_tpu_torch.cli.profile --interleave [--bf16]
    python -m vspbfr_tpu_torch.cli.profile --stripe_conv [--bf16]
    python -m vspbfr_tpu_torch.cli.profile --inkpad [--bf16]

`--interleave`, `--stripe_conv` and `--inkpad` are the counterparts of the
TPU experiments `scripts/exp_interleave.py`, `exp_pallas_conv.py` and
`exp_inkpad.py`, at their shapes, b4:

- `--interleave`: K8's two forms (`interleave_stack`, `interleave_repeat`)
  at (h, inner) (256, 128), (512, 128) and (128, 512), against their plain
  version (`d2s_plain`), K3 (`ops.d2s`) and the library's call, the
  permute copy (`d2s_library`); exact equality is required;
- `--stripe_conv`: K9 at the script's four decoder shapes against its
  plain version and cuDNN's conv (`F.conv2d`, TF32 off), the script's
  yardstick (XLA's conv there);
- `--inkpad`: K10's four variants at (4, 256, 256, 256) x (3, 3, 256,
  256), h_t 16, each against its plain version in the region where the
  variant is defined, its difference from `legacy` there, its count of
  non-finite outputs, and cuDNN's conv.

Each row holds the CUDA-event medians (`ms`, `plain_ms`, `library_ms`, "-"
where no one library call computes the function), the bound with what
bounds it, the max difference relative to max |plain| and the launches of
the timed kernel calls.

Two timers serve the rows here and in `chip_smoke.py`: `cuda_ms`, one
call on an idle stream (host included: what a call costs the stream when
the host is the limit), and `device_ms`, the device's time alone (the
stream held while the host enqueues n calls, rotating through copies of
the operands, `copies`, so that no call reads from L2 what an earlier
one left there). `in_turns` and `card_name` serve the CLIs that time a
kernel against an earlier checkout's form. `K6_CASES`, `K7_CASES`,
`k6_operands` and `k6_work` give K6's and K7's main-path shapes, operands
and bound to both `chip_smoke.py` and `cli.epilogue_turns`.

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
from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc
from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.smart import RATES, SMS, _smart_forward, smart_plan
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
# the TPU experiments' shapes: K8 (h = w, inner) with 4*inner input
# channels; K9 (x, w, pads), pads as the script derives them from KH; K10
INTERLEAVE_SHAPES = ((256, 128), (512, 128), (128, 512))
STRIPE_SHAPES = (
    ((4, 512, 512, 128), (3, 3, 128, 128), ((1, 1), (1, 1))),
    ((4, 256, 256, 256), (3, 3, 256, 256), ((1, 1), (1, 1))),
    ((4, 256, 256, 256), (2, 2, 256, 512), ((0, 1), (0, 1))),
    ((4, 256, 256, 256), (3, 3, 256, 64), ((1, 1), (1, 1))),
)
INKPAD_SHAPE, INKPAD_CO, INKPAD_ROWS = (4, 256, 256, 256), 256, 16
# the card's published peaks (NVIDIA's H100 SXM data sheet, dense): f32 on
# the CUDA cores, bf16 on the tensor cores, and the HBM rate
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# (group, substrings of the kernel name), first match wins
GROUPS = (
    ("K1e dense_conv_epilogue", ("dense_conv_kernel<float, true",
                                 "dense_conv_kernel<__nv_bfloat16, true")),
    ("K1 dense_conv", ("dense_conv_kernel",)),
    ("K2 dilated_multi_conv", ("dilated_multi_kernel",)),
    ("K3 d2s", ("d2s_kernel",)),
    ("K4 s2d", ("s2d_kernel",)),
    ("K5 smart_core", ("smart_fused_kernel",)),
    ("K6 conv_epilogue", ("epilogue_kernel",)),
    ("K7 fused_leaky_relu", ("fused_lrelu_kernel",)),
    ("K8 interleave", ("interleave_stack_kernel",
                       "interleave_repeat_kernel")),
    ("K9/K10 stripe_conv", ("stripe_conv_kernel",)),
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


def smart_grad_work(b: int, h: int, w: int, c: int, cb: int, cout: int,
                    itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of one backward of K5's Function: the K2 + K1
    forward it recomputes (`smart_work`'s operations), then dx and dw of
    K2 and of K1, each as many multiply-adds as that conv's forward over
    the taps inside the image; x, style, both weight sets and the incoming
    gradient read once, their gradients written once."""
    flops, _ = smart_work(b, h, w, c, cb, cout, itemsize)
    mac = b * c * cb * sum(_taps_inside(h, d) * _taps_inside(w, d)
                           for d in RATES)
    mac += b * 4 * cb * cout * _taps_inside(h, 1) * _taps_inside(w, 1)
    elems = 2 * (b * h * w * c + b * c + 9 * c * 4 * cb
                 + 9 * 4 * cb * cout) + b * h * w * cout
    return flops + 2 * 2 * mac, elems * itemsize


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up: the start event
    is recorded on an idle stream before fn() is called, so the time holds
    the host's work up to fn's launches too (what one call costs the stream
    when the host is the limit; `device_ms` leaves it out)."""
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


# cycles of `torch.cuda._sleep` per second on this card (measured once)
_SLEEP_RATE: list[float] = []


def _sleep_rate() -> float:
    if not _SLEEP_RATE:
        cycles = 20_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles // 10)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_RATE.append(cycles / (start.elapsed_time(end) / 1e3))
    return _SLEEP_RATE[0]


def l2_copies(moved: int, n: int = 20) -> int:
    """How many copies of a call's operands `device_ms` should rotate
    through so that every call reads them from device memory, not from
    the card's L2: one where a call alone moves twice the L2, else enough
    that the calls between two uses of a copy move that much (at most
    n). moved: the bytes one call reads and writes."""
    l2 = torch.cuda.get_device_properties(
        torch.cuda.current_device()).L2_cache_size
    if moved >= 2 * l2:
        return 1
    return min(n, math.ceil(2 * l2 / max(moved, 1)) + 1)


def device_ms(fn, n: int = 20, warmup: int = 3, repeats: int = 5) -> float:
    """Device time of one call in ms, apart from the host's: the stream is
    held by `torch.cuda._sleep` for twice the host's measured time to
    enqueue n calls, the start event is recorded, then n calls and the end
    event; (end - start) / n, the median of `repeats` such runs. fn is a
    callable or a list of callables on copies of the operands (see
    `l2_copies`), taken in turn; each call's result is kept until its
    run has ended, so every call writes fresh memory. fn must not
    synchronise. If the device reached the start event before the host
    had enqueued the n calls (the hold was too short: the calls would have
    run with gaps), the run is repeated with a hold twice as long."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]

    def run():
        return [fns[i % len(fns)]() for i in range(n)]

    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    hold_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    del out
    rate = _sleep_rate()
    times = []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_s * rate))
        start.record()
        out = run()
        early = start.query()
        end.record()
        end.synchronize()
        del out
        if early:
            hold_s *= 2
            if hold_s > 10:
                raise RuntimeError("device_ms: the host did not finish "
                                   "enqueueing within a 10 s hold (does fn "
                                   "synchronise?)")
            continue
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def copies(make, moved: int, n: int = 20) -> list:
    """`l2_copies(moved, n)` results of make(), each a call on operands of
    its own, for `device_ms` to rotate through."""
    return [make() for _ in range(l2_copies(moved, n))]


def in_turns(timer, old, new) -> tuple[list, list]:
    """timer(old), timer(new), timer(new), timer(old): ([old, old], [new,
    new]), so that a drift of the card's or the host's pace falls on both
    forms alike."""
    t = [timer(f) for f in (old, new, new, old)]
    return [t[0], t[3]], [t[1], t[2]]


def card_name() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


# K6 on the main paths at full width, b4 (x shape, pieces, label): "s"
# out_scale, "n" noise, "b" bias, "a" the activation, "p" a post-add (one
# each), "2" the second stage (noise2, bias2, act2); the SMART tail (conv
# then bias + lrelu, then the second stage) and the RestoreNet StyledConv
# with its two skips are the chain rows, one K6 pass each
K6_CASES = (
    ((4, 1024, 1024, 32), "snba", "decoder styled 1024px C32"),
    ((4, 512, 512, 64), "nba", "SMART tail stage 2 512px C64"),
    ((4, 64, 64, 512), "snba", "styled 64px C512"),
    ((4, 512, 512, 64), "b", "bias only 512px C64"),
    ((4, 512, 512, 3), "nba", "C3 512px"),
    ((4, 512, 512, 64), "ba2", "chain SMART tail 512px C64"),
    ((4, 64, 64, 512), "ba2", "chain SMART tail 64px C512"),
    ((4, 512, 512, 64), "snbapp", "chain styled 2 skips 512px C64"),
)
# K7 on the main paths (x shape, label)
K7_CASES = (
    ((4, 512, 512, 64), "LargeConv down_from_big 512px C64"),
    ((4, 512), "StyleMLP / final_linear (4, 512)"),
    ((4, 256, 256, 3), "odd C3 256px"),
)


def k6_operands(rand, dt, xs, pieces, op_dt=None) -> tuple:
    """(x, kwargs of `conv_epilogue`) for a `K6_CASES` entry: x and the
    post-adds in dt, the other operands in op_dt (default dt)."""
    b, h, w, c = xs
    op_dt = op_dt or dt
    kw = {"act": "a" in pieces}
    if "s" in pieces:
        kw["out_scale"] = rand(b, c, scale=0.2, offset=1.0).to(op_dt)
    if "n" in pieces:
        kw["noise"] = rand(b, h, w, 1, scale=0.3).to(op_dt)
    if "b" in pieces:
        kw["bias"] = rand(c, scale=0.3).to(op_dt)
    if "p" in pieces:
        kw["post_add"] = tuple(rand(*xs).to(dt)
                               for _ in range(pieces.count("p")))
    if "2" in pieces:
        kw.update(noise2=rand(b, h, w, 1, scale=0.3).to(op_dt),
                  bias2=rand(c, scale=0.3).to(op_dt), act2=True)
    return rand(*xs).to(dt), kw


def k6_work(x, kw, mask: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one K6 call: per element one operation for
    each piece (two for an activation, one for each post-add); x, every
    operand and y moved once (and the mask's byte an element)."""
    per = (sum(k in kw for k in ("out_scale", "noise", "bias", "noise2",
                                 "bias2"))
           + 2 * (bool(kw.get("act")) + bool(kw.get("act2")))
           + len(kw.get("post_add", ())))
    tensors = [x, x] + [v for k, v in kw.items() if isinstance(
        v, torch.Tensor)] + list(kw.get("post_add", ()))
    moved = sum(t.numel() * t.element_size() for t in tensors)
    return per * x.numel(), moved + (x.numel() if mask else 0)


def smart_composition(x, style, ws, wf) -> torch.Tensor:
    """The SMART core as `SMARTLayer` computes it, with K5's inputs: K2
    through `modulated_conv2d_multi`, then K1 for the fusion conv (without
    its epilogue)."""
    scale_f = 1.0 / math.sqrt(9 * wf.shape[2])
    br = ops.modulated_conv2d_multi(x, ws, RATES, style)
    return ops.dense_conv(br, (scale_f * wf).to(x.dtype).contiguous(),
                          ((1, 1), (1, 1)))


# K5's two designs (`--designs`): the cluster of blocks that shares a tile
SMART_DESIGNS = (("one block a tile", 1), ("one branch a block", 4))


def plan_label(plan: dict) -> str:
    """A K5 plan in a few words: tile, cluster, output channels a block,
    blocks and the branch tile's bytes."""
    return (f"tile {plan['TH']}x{plan['TW']}, cluster {plan['cluster']}, "
            f"co {plan['co_split']}/block, {plan['blocks']} blocks, branch "
            f"tile {plan['buf_bytes']} B")


def profile_smart(dtype: torch.dtype, device="cuda", shapes=SMART_SHAPES,
                  batch: int = BATCH, timer=cuda_ms, dev_timer=device_ms,
                  designs=()) -> list[dict]:
    """K5 against the composition SMARTLayer runs at each (side, C) of
    `shapes`, batch `batch`, in `dtype`, the two in turns (composition,
    K5, K5, composition): per call by `timer`, on the device by
    `dev_timer` (on operand copies past the L2), the max difference
    relative to max |composition|, K5's plan, the bound and the launches
    of all the timed calls (counted as differences, so the launch counters
    keep running across the call). `designs`: (label, cluster) pairs whose
    K5 device times are taken in turns too (two designs: a, b, b, a)."""
    dt_name = "bf16" if dtype == torch.bfloat16 else "f32"
    dev = torch.device(device)
    rand = _rand_fn(dtype, dev)

    rows = []
    for side, c in shapes:
        cb = c // len(RATES)

        def operands():
            return (rand(batch, side, side, c),
                    rand(batch, c, scale=0.2, offset=1.0),
                    [rand(3, 3, c, cb) for _ in RATES], rand(3, 3, 4 * cb, c))

        flops, moved = smart_work(batch, side, side, c, cb, c,
                                  dtype.itemsize)
        n = l2_copies(moved) if dev.type == "cuda" else 1
        sets = [operands() for _ in range(n)]

        def k5_calls(cluster=None):
            if cluster is None:
                return [lambda a=a: ops.smart_core(*a) for a in sets]
            return [lambda a=a: _smart_forward(*a, True, 1e-8, cluster)
                    for a in sets]

        comp_calls = [lambda a=a: smart_composition(*a) for a in sets]
        with torch.no_grad():
            ref = comp_calls[0]().float()
            diff = float((k5_calls()[0]().float() - ref).abs().max()
                         / ref.abs().max().clamp_min(1e-12))
            before = ops.launch_counts()
            comp_ms, k5_ms = in_turns(timer, comp_calls[0], k5_calls()[0])
            comp_dev, k5_dev = in_turns(dev_timer, comp_calls, k5_calls())
            after = ops.launch_counts()
            design_ms = {}
            if len(designs) == 2:
                (la, ca), (lb, cbl) = designs
                design_ms[la], design_ms[lb] = in_turns(
                    dev_timer, k5_calls(ca), k5_calls(cbl))
        del sets, ref
        b_ms, b_by = bound_ms(flops, moved, dt_name)
        plan = smart_plan(dtype == torch.bfloat16, batch, side, side, c, cb,
                          c, _build.multiprocessors(dev)
                          if dev.type == "cuda" else SMS)
        rows.append(dict(
            size=side, channels=c, batch=batch, dtype=dt_name,
            plan=plan, plan_label=plan_label(plan),
            k5_ms=statistics.mean(k5_ms), composition_ms=statistics.mean(
                comp_ms),
            k5_device_ms=statistics.mean(k5_dev),
            composition_device_ms=statistics.mean(comp_dev),
            turns=dict(k5_ms=k5_ms, composition_ms=comp_ms,
                       k5_device_ms=k5_dev, composition_device_ms=comp_dev),
            k5_over_composition=statistics.mean(k5_dev)
            / statistics.mean(comp_dev),
            designs={k: dict(cluster=dict(designs)[k], device_ms=v)
                     for k, v in design_ms.items()},
            max_rel_diff=diff, bound_ms=b_ms, bound_by=b_by, flops=flops,
            bytes=moved,
            k5_launches=after["smart_core"] - before["smart_core"],
            composition_launches={k: after[k] - before[k] for k in
                                  ("dilated_multi_conv", "dense_conv")}))
    return rows


def _rand_fn(dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + offset).to(dtype)

    return rand


def _diffs(got, ref, region=(...,)) -> dict:
    """The max difference of got from ref in `region`: absolute, and
    relative to max |ref| there."""
    got, ref = got[region].float(), ref[region].float()
    abs_err = float((got - ref).abs().max())
    return dict(max_abs_err=abs_err, max_rel_diff=abs_err / float(
        ref.abs().max().clamp_min(1e-12)))


def _timed(timer, fn, name) -> tuple[float, int]:
    """(time of fn by timer, launches of kernel `name` in those calls)."""
    before = ops.launch_counts()[name]
    ms = timer(fn)
    return ms, ops.launch_counts()[name] - before


def d2s_library(x: torch.Tensor, inner: int) -> torch.Tensor:
    """K3's (and K8's) function as one PyTorch call: the grouped phase
    interleave as a view, permuted, copied by `.contiguous()`."""
    b, h, w, _ = x.shape
    return x.view(b, h, w, 2, 2, inner).permute(0, 1, 3, 2, 4, 5).contiguous(
        ).view(b, 2 * h, 2 * w, inner)


def s2d_library(y: torch.Tensor, inner: int) -> torch.Tensor:
    """K4's function as one PyTorch call, the inverse copy."""
    b, h2, w2, _ = y.shape
    return y.view(b, h2 // 2, 2, w2 // 2, 2, inner).permute(
        0, 1, 3, 2, 4, 5).contiguous().view(b, h2 // 2, w2 // 2, 4 * inner)


def interleave_work(b: int, h: int, w: int, inner: int,
                    itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of one K8 call: no arithmetic, the input read
    once and the output, as large, written once."""
    return 0, 2 * b * h * w * 4 * inner * itemsize


def profile_interleave(dtype: torch.dtype, device="cuda",
                       shapes=INTERLEAVE_SHAPES, batch: int = BATCH,
                       timer=cuda_ms) -> list[dict]:
    """K8's two forms against their plain version and K3 at each (h,
    inner) of `shapes` (square images), batch `batch`, in `dtype`."""
    dt_name = "bf16" if dtype == torch.bfloat16 else "f32"
    rand = _rand_fn(dtype, torch.device(device))
    rows = []
    for h, inner in shapes:
        x = rand(batch, h, h, 4 * inner)
        with torch.no_grad():
            ref = ops.d2s_plain(x, inner)
            plain_ms = timer(lambda: ops.d2s_plain(x, inner))
            library_ms = timer(lambda: d2s_library(x, inner))
            k3_ms = timer(lambda: ops.d2s(x, inner))
            for form, fn in (("stack", ops.interleave_stack),
                             ("repeat", ops.interleave_repeat)):
                got = fn(x, inner)
                exact = bool(torch.equal(got, ref))
                ms, n = _timed(timer, lambda: fn(x, inner),
                               f"interleave_{form}")
                flops, moved = interleave_work(batch, h, h, inner,
                                               x.element_size())
                b_ms, b_by = bound_ms(flops, moved, dt_name)
                rows.append(dict(
                    form=form, h=h, inner=inner, batch=batch, dtype=dt_name,
                    exact=exact, **_diffs(got, ref), ms=ms,
                    plain_ms=plain_ms, k3_ms=k3_ms, library_ms=library_ms,
                    bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=moved,
                    launches=n))
                del got
        del x, ref
    return rows


def _taps_in(n: int, k: int, p0: int, out: int) -> int:
    """(output, tap) pairs of a k-tap stride-1 conv along an axis of n,
    padded by p0 before it, with `out` outputs, whose input lies inside the
    image."""
    return sum(max(0, min(out, n + p0 - t) - max(0, p0 - t))
               for t in range(k))


def stripe_work(b: int, h: int, w: int, ci: int, kh: int, kw: int, co: int,
                pads, itemsize: int) -> tuple[int, int]:
    """(operations, bytes) of one K9 / K10 call: two per multiply-add over
    the taps that land inside the image, as `smart_work` counts; x, w and y
    moved once."""
    (py0, py1), (px0, px1) = pads
    oh, ow = h + py0 + py1 - kh + 1, w + px0 + px1 - kw + 1
    flops = (2 * b * ci * co * _taps_in(h, kh, py0, oh)
             * _taps_in(w, kw, px0, ow))
    return flops, (b * h * w * ci + kh * kw * ci * co
                   + b * oh * ow * co) * itemsize


def profile_stripe_conv(dtype: torch.dtype, device="cuda",
                        shapes=STRIPE_SHAPES, timer=cuda_ms) -> list[dict]:
    """K9 against its plain version (diff against it in f32 on the same
    inputs) and cuDNN's conv at each (x, w, pads) of `shapes`."""
    dt_name = "bf16" if dtype == torch.bfloat16 else "f32"
    rand = _rand_fn(dtype, torch.device(device))
    rows = []
    for xs, ws, pads in shapes:
        x, w = rand(*xs), rand(*ws, scale=0.05)
        with torch.no_grad():
            got = ops.stripe_conv(x, w, pads)
            ref = ops.stripe_conv_plain(x.float(), w.float(), pads)
            diff = _diffs(got, ref)
            del got, ref
            ms, n = _timed(timer, lambda: ops.stripe_conv(x, w, pads),
                           "stripe_conv")
            plain_ms = timer(lambda: ops.stripe_conv_plain(x, w, pads))
            library_ms = timer(lambda: conv_nhwc(x, w, 1, pads))
        flops, moved = stripe_work(*xs, ws[0], ws[1], ws[3], pads,
                                   x.element_size())
        b_ms, b_by = bound_ms(flops, moved, dt_name)
        rows.append(dict(
            x=list(xs), w=list(ws), pads=[list(p) for p in pads],
            dtype=dt_name, **diff, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
            flops=flops, bytes=moved, launches=n))
        del x, w
    return rows


def profile_inkpad(dtype: torch.dtype, device="cuda", shape=INKPAD_SHAPE,
                   co: int = INKPAD_CO, h_t: int = INKPAD_ROWS,
                   timer=cuda_ms) -> list[dict]:
    """K10's four variants at `shape`, 3x3 to `co` channels, h_t rows a
    tile: each against its plain version where the variant is defined
    (nomemset: columns 1 .. W-2), its max difference from `legacy` there,
    its non-finite outputs, and cuDNN's pad-1 conv."""
    from vspbfr_tpu_torch.ops.stripe_conv import VARIANTS

    dt_name = "bf16" if dtype == torch.bfloat16 else "f32"
    rand = _rand_fn(dtype, torch.device(device))
    x, w = rand(*shape), rand(3, 3, shape[3], co, scale=0.05)
    pads = ((1, 1), (1, 1))
    flops, moved = stripe_work(*shape, 3, 3, co, pads, x.element_size())
    b_ms, b_by = bound_ms(flops, moved, dt_name)
    rows = []
    with torch.no_grad():
        legacy = ops.inkpad_conv(x, w, "legacy", h_t).float()
        library_ms = timer(lambda: conv_nhwc(x, w, 1, pads))
        for variant in VARIANTS:
            region = ((..., slice(1, -1), slice(None)) if variant == "nomemset"
                      else (...,))
            got = ops.inkpad_conv(x, w, variant, h_t)
            ref = ops.inkpad_conv_plain(x.float(), w.float(), variant, h_t)
            row = dict(
                variant=variant, x=list(shape), co=co, h_t=h_t,
                dtype=dt_name, **_diffs(got, ref, region),
                vs_legacy_max_abs=float((got[region].float()
                                         - legacy[region]).abs().max()),
                nonfinite=int((~torch.isfinite(got)).sum()))
            del got, ref
            ms, n = _timed(timer, lambda: ops.inkpad_conv(x, w, variant, h_t),
                           "inkpad_conv")
            plain_ms = timer(lambda: ops.inkpad_conv_plain(x, w, variant,
                                                           h_t))
            row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=b_ms, bound_by=b_by, flops=flops,
                       bytes=moved, launches=n)
            rows.append(row)
    return rows


# the main path's K1 convs at full width, b4 (x shape, w shape, pads,
# label): 3x3 StyledConvs across the decoder and RestoreNet widths, the
# subpixel up-convs, LargeConv's 1x1 fusion and rate-1 branch
_P1, _P0 = ((1, 1), (1, 1)), ((0, 0), (0, 0))
K1_CASES = (
    ((4, 32, 32, 512), (3, 3, 512, 512), _P1, "styled 32px C512"),
    ((4, 128, 128, 256), (3, 3, 256, 256), _P1, "styled 128px C256"),
    ((4, 256, 256, 128), (3, 3, 128, 128), _P1, "styled 256px C128"),
    ((4, 512, 512, 64), (3, 3, 64, 64), _P1, "styled 512px C64"),
    ((4, 1024, 1024, 32), (3, 3, 32, 32), _P1, "styled 1024px C32"),
    ((4, 256, 256, 128), (3, 3, 128, 256), _P1, "up-conv 256->512"),
    ((4, 512, 512, 64), (3, 3, 64, 128), _P1, "up-conv 512->1024"),
    ((4, 512, 512, 64), (1, 1, 64, 64), _P0, "LargeConv fusion 1x1"),
    ((4, 512, 512, 3), (1, 1, 3, 16), _P0, "LargeConv rate-1 1x1"),
)
# the SMART shapes K2 is timed at (side, C), b4
K2_SHAPES = ((8, 512), (64, 512), (128, 256), (256, 128), (512, 64))


def _print_experiment_row(card: str, entry: str, r: dict) -> None:
    if entry == "interleave":
        what = (f"{r['form']} b{r['batch']} h{r['h']} inner {r['inner']}: "
                f"exact {r['exact']}, K3 {r['k3_ms']:.4f} ms")
    elif entry == "stripe_conv":
        what = f"x {r['x']} w {r['w']} pads {r['pads']}"
    else:
        what = (f"{r['variant']:8s} x {r['x']} h_t {r['h_t']}: vs legacy "
                f"{r['vs_legacy_max_abs']:.3e}, non-finite {r['nonfinite']}")
    lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    print(f"[{card}] {entry} {r['dtype']} {what}; kernel {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max rel diff "
          f"{r['max_rel_diff']:.3e}, launches {r['launches']}")


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
    p.add_argument("--designs", action="store_true",
                   help="with --smart: also time K5 with one block a tile "
                        "and with one branch a block, in turns")
    p.add_argument("--interleave", action="store_true",
                   help="time K8's two forms against K3 and their plain "
                        "version at exp_interleave.py's shapes")
    p.add_argument("--stripe_conv", action="store_true",
                   help="time K9 against cuDNN and its plain version at "
                        "exp_pallas_conv.py's shapes")
    p.add_argument("--inkpad", action="store_true",
                   help="time K10's four stripe loads at exp_inkpad.py's "
                        "shape")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["VSPBFR_FUSED_EPI"] = "1" if args.fused_epi else "0"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    call = "restore"
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    experiments = {"interleave": profile_interleave,
                   "stripe_conv": profile_stripe_conv,
                   "inkpad": profile_inkpad}
    entry = next((k for k in experiments if getattr(args, k)), None)
    if entry:
        call, batch, size = entry, BATCH, None
        res = {"rows": experiments[entry](dtype)}
    elif args.smart:
        call, batch, size = "smart_core", BATCH, SIZE
        res = {"rows": profile_smart(
            dtype, designs=SMART_DESIGNS if args.designs else ())}
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
    res.update(card=card_name().splitlines()[0], batch=batch, size=size,
               decoder_size=DECODER_SIZE, dtype="bf16" if args.bf16 else "f32",
               call=call, fused_epi=args.fused_epi,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if entry:
        for r in res["rows"]:
            _print_experiment_row(res["card"], entry, r)
    elif args.smart:
        for r in res["rows"]:
            designs = "".join(f", {k} (cluster {v['cluster']}) "
                              f"{v['device_ms']}" for k, v in
                              r["designs"].items())
            print(f"[{res['card']}] smart_core {r['dtype']} b{r['batch']} "
                  f"{r['size']}px C{r['channels']} ({r['plan_label']}): K5 "
                  f"{r['k5_ms']:.4f} ms (device {r['k5_device_ms']:.4f}), "
                  f"K2 + K1 {r['composition_ms']:.4f} ms (device "
                  f"{r['composition_device_ms']:.4f}), device ratio "
                  f"x{r['k5_over_composition']:.3f}, max rel diff "
                  f"{r['max_rel_diff']:.3e}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), launches K5 {r['k5_launches']} / "
                  f"{r['composition_launches']}{designs}")
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
