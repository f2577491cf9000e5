#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # takes no arguments; needs one CUDA card

Phases, in order (any failed check raises, so the exit status is non-zero):

1. device  - require CUDA; print the card's name and power limit; turn TF32
             off for matmuls and cuDNN (the plain f32 convs would run in
             TF32 otherwise).
2. build   - build or load the kernels' shared library from `csrc/`;
             print ptxas's registers and spill bytes of each K9 / K10, K1 /
             K1e, K2, K5, K6 and K7 instantiation (no K5 one may spill);
             count, in the SASS of each (`cuobjdump -sass`), the
             tensor-core instructions (HMMA of mma.sync, HGMMA of wgmma)
             and TMA loads (UTMALDG): every bf16 K1 / K1e / K2 / K5 one
             must have HMMA, every bf16 K9 / K10 one (one kernel with the
             TMA and the plain-load producer) HGMMA and UTMALDG.
3. kernels - each CUDA kernel (K1 dense conv, K1e its fused styled
             epilogue, K2 multi-dilation conv, K3 phase interleave, K5 fused
             SMART core, K6 styled epilogue pass, K7 bias + leaky ReLU, K8
             the interleave's stack and repeat forms, K9 stripe conv, K10
             its four stripe loads) against its plain torch version at the
             main paths' full-width shapes (K1e also as a styled conv at
             each other K1 shape; K8-K10: the TPU experiments' shapes; K8 exact, K10 `nomemset` on columns 1 .. W-2 only,
             `nobranch` against its stripe model),
             batch 4, in f32 and bf16: error relative to max |plain|,
             median CUDA-event times of the kernel, the plain version and
             (where one call computes the same function) the library's
             call (K1: cuDNN on x * in_scale; K2 has none, and a
             composition stands beside it: cuDNN's four dilated convs and
             the concatenation), and the bound (the larger of operations over the card's
             peak rate for the dtype and bytes over its memory rate); for
             K5 also the K2 + K1 composition SMARTLayer runs and K5's
             launch plan (`ops.smart.smart_plan`). K6 (each
             row one launch, the chain rows too: the SMART tail's two
             stages, the StyledConv's two skips) and K7 also give their
             device time apart from the host's (`cli.profile.device_ms`,
             on operand copies that together exceed the card's L2)
             beside the time of one call on an idle stream.
4. slice   - the whole restoration path at a mid-size config, card
             (kernels) against CPU (plain versions), same weights and
             draws; every kernel's launch counter must rise on the card.
5. cli     - the infer CLI at full width (512 px, 1024 px decoder, IR-SE-50
             encoder, 4-step DDPM, 15-SMART RestoreNet) answering 8
             synthetic degraded faces at batch 4, in f32 and in bf16, with
             launch counts and peak memory, scoring them against their
             clean faces (PSNR, SSIM, LPIPS and FID from seeded LPIPS and
             InceptionV3 state_dicts; all finite) and timing the scoring
             per batch beside `restore` (and, at the end, its split into
             PSNR + SSIM, LPIPS, InceptionV3 and the host's float64
             statistics); then, on the same 4 inputs,
             the stage split and imgs/s from CUDA-event medians of
             `restore`, with the `VSPBFR_FUSED_EPI` switch off and on (K1
             plus K6, or K1e), and the bf16-vs-f32 PSNR.
6. grads   - the kernels' gradients against plain torch autograd on the
             card: K1's Function (dx, whose K1 launch is timed, d_in_scale
             and dw) at phase 3's nine K1 shapes, K1e's Function
             (every operand; dx a K1 launch; elements within 1e-5 of an
             activation's kink get no incoming gradient, see `kink_free`;
             the f32 reference rounds x * in_scale where the kernel does,
             see `scaled_input`),
             K2's Function (dx, the four
             branch weights, d_in_scale, d_out_scale) at the SMART shapes,
             K4 (the gradient of K3) at its two up-conv shapes, K6's and
             K7's Functions (every operand, the chain rows' post-adds and
             second stage too, the kink rule on both stages) and K6's
             double backward (R1's pattern, through one stage and through
             the SMART tail's chain), and K5's Function (every input; K2
             and K1 launch in its backward), in f32 and bf16.
7. train   - stage-2 training (the second main path): one step at the
             phase-4 config on the card (kernels) against the CPU (plain
             versions), K1 and K4 launching during backward(); then the
             train_diffuser CLI at full width (256 px, 1024 px decoder,
             IR-SE-50, b16) on synthetic uint8 faces in f32 and in bf16:
             step ms, imgs/s, peak memory, launch counts; and ten steps on
             one fixed batch, which must lower the L1 term.
8. restore - stage-3 RestoreNet GAN training (the third main path): ADA's
             augment at 512 px b4 on the card against the CPU with the same
             matrices (forward within 1e-5 of max, the input gradient and
             R1's double backward through a three-conv D within 1e-3, all
             finite) and its CUDA-event forward and forward + backward
             times; one step (D update, lazy R1, G update) at a mid-size
             config on the card against the CPU, same weights, batch,
             embedding and draws, without ADA and with ADA at the fixed p
             0.5 (each of its 13 transforms must apply to some sample);
             the launches of its forward, backward() and R1's double
             backward; then the train_restore CLI at full width (512 px,
             1024 px decoder, IR-SE-50 at 256, b4, 4 steps, R1 at step 0)
             in f32 and bf16 with the epilogue switch off, the same with
             ADA (f32 `--augment`, bf16 `--augment --augment_p 0.5`; the
             six kernels of `PATH_KERNELS["restore_ada"]` must launch) and
             in bf16 with the switch on: step ms, imgs/s, peak memory,
             launch counts; the bf16 step with the switch off and on in
             turns on one trainer, and without and with ADA (p 0.5) in
             turns on two trainers, each with and without R1.
9. smart   - K5's entry, `python -m vspbfr_tpu_torch.cli.profile --smart`,
             in process, f32 and bf16: K5 against the K2 + K1 composition
             at every RestoreNet SMART shape, b4, in turns, per call and
             on the device, with K5's plan (SMARTLayer itself runs the
             composition, as in the JAX package).
10. experiments - the entries of K8-K10 (`cli.profile --interleave`,
             `--stripe_conv`, `--inkpad`) in process, f32 and bf16, at the
             TPU experiments' shapes, b4: every row must launch its kernel
             and agree with its plain version (K8 exactly). No product path
             calls K8-K10, as none calls their scripts' kernels.

Phases 5, 7 and 8 also count the calls of K6's and K7's plain versions
on CUDA tensors (`ops.plain_cuda_calls`), which must stay 0: on the card
the main paths run the kernels.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Details also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# the card's published peaks, the bound and the CUDA-event timer are the
# profiler's (`cli/profile.py`), so both report the same numbers
from vspbfr_tpu_torch.cli.profile import bound_ms as bound
from vspbfr_tpu_torch.cli.profile import cuda_ms

PHASES = ("device", "build", "kernels", "slice", "cli", "grads", "train",
          "restore", "smart", "experiments")
HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_INFO = {
    "dense_conv": ("vspbfr_tpu_torch/csrc/dense_conv.cu",
                   "vspbfr_tpu/ops/pallas_conv.py:222"),
    "dense_conv_epilogue": ("vspbfr_tpu_torch/csrc/dense_conv.cu",
                            "vspbfr_tpu/ops/pallas_conv.py:524"),
    "dilated_multi_conv": ("vspbfr_tpu_torch/csrc/dilated_conv.cu",
                           "vspbfr_tpu/ops/pallas_dilated.py:180"),
    "d2s": ("vspbfr_tpu_torch/csrc/d2s.cu",
            "vspbfr_tpu/ops/pallas_d2s.py:75"),
    "s2d": ("vspbfr_tpu_torch/csrc/s2d.cu",
            "vspbfr_tpu/ops/pallas_d2s.py:109"),
    "smart_core": ("vspbfr_tpu_torch/csrc/smart_fused.cu",
                   "vspbfr_tpu/ops/pallas_smart.py:193"),
    "conv_epilogue": ("vspbfr_tpu_torch/csrc/epilogue.cu",
                      "vspbfr_tpu/ops/pallas_epilogue.py:96"),
    "fused_leaky_relu": ("vspbfr_tpu_torch/csrc/fused_act.cu",
                         "vspbfr_tpu/ops/fused_act.py:52"),
    "interleave_stack": ("vspbfr_tpu_torch/csrc/interleave.cu",
                         "scripts/exp_interleave.py:73"),
    "interleave_repeat": ("vspbfr_tpu_torch/csrc/interleave.cu",
                          "scripts/exp_interleave.py:87"),
    "stripe_conv": ("vspbfr_tpu_torch/csrc/stripe_conv.cu",
                    "scripts/exp_pallas_conv.py:30"),
    "inkpad_conv": ("vspbfr_tpu_torch/csrc/stripe_conv.cu",
                    "scripts/exp_inkpad.py:96"),
}
# the kernels each main path must launch: serving (phase 5), stage-2
# training (phase 7), stage-3 training (phase 8) without and with ADA and
# with the epilogue switch on, K5's entry (phase 9) and the entries of
# K8-K10 (phase 10)
PATH_KERNELS = {"serve": ("dense_conv", "dilated_multi_conv", "d2s",
                          "conv_epilogue", "fused_leaky_relu"),
                "train": ("dense_conv", "d2s", "s2d", "conv_epilogue",
                          "fused_leaky_relu"),
                "restore": ("dense_conv", "dilated_multi_conv", "d2s", "s2d",
                            "conv_epilogue", "fused_leaky_relu"),
                "restore_ada": ("dense_conv", "dilated_multi_conv", "d2s",
                                "s2d", "conv_epilogue", "fused_leaky_relu"),
                "restore_fused": ("dense_conv_epilogue", "dense_conv",
                                  "dilated_multi_conv", "d2s", "s2d",
                                  "conv_epilogue", "fused_leaky_relu"),
                "smart": ("smart_core",),
                "experiments": ("interleave_stack", "interleave_repeat",
                                "stripe_conv", "inkpad_conv")}
TOL = {"f32": 1e-4, "bf16": 2e-2}
REPORT: dict = {}
CARD = ""


def say(*parts) -> None:
    print(f"[{CARD}]", *parts, flush=True)


@contextlib.contextmanager
def no_plain_on_card(phase: str):
    """Require that the block makes no call of K6's or K7's plain version
    on a CUDA tensor (the main paths run the kernels on the card)."""
    from vspbfr_tpu_torch import ops

    ops.reset_plain_cuda_calls()
    yield
    calls = ops.plain_cuda_calls()
    say(f"{phase}: plain versions called on CUDA tensors: {calls}")
    REPORT.setdefault("plain_cuda_calls", {})[phase] = calls
    if any(calls.values()):
        raise AssertionError(f"{phase}: a plain version ran on the card: "
                             f"{calls}")


@contextlib.contextmanager
def fused_epi(flag: str):
    """Set the JAX package's epilogue switch, `VSPBFR_FUSED_EPI`, which the
    port reads at each call, for the duration of the block."""
    before = os.environ.get("VSPBFR_FUSED_EPI")
    os.environ["VSPBFR_FUSED_EPI"] = flag
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("VSPBFR_FUSED_EPI")
        else:
            os.environ["VSPBFR_FUSED_EPI"] = before


# --- phase 1 ----------------------------------------------------------------

def phase_device():
    global CARD
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    CARD = smi.splitlines()[0].strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the epilogue switch stays off unless a phase turns it on
    os.environ["VSPBFR_FUSED_EPI"] = "0"
    say("torch", torch.__version__, "cuda", torch.version.cuda,
        "devices", torch.cuda.device_count())
    say("cudnn.allow_tf32 =", torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32 =", torch.backends.cuda.matmul.allow_tf32)
    REPORT["device"] = {"nvidia_smi": smi,
                        "name": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count()}


# --- phase 2 ----------------------------------------------------------------

# the SASS instructions every bf16 instantiation of each kernel must hold:
# K9 / K10 wgmma (HGMMA) fed by TMA (UTMALDG), K1 and K1e (one template),
# K2 and K5 mma.sync (HMMA)
SASS_REQUIRED = {"stripe_conv_kernel": ("HGMMA", "UTMALDG"),
                 "dense_conv_kernel": ("HMMA",),
                 "dilated_multi_kernel": ("HMMA",),
                 "smart_fused_kernel": ("HMMA",)}
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")
# kernels none of whose instantiations may spill
NO_SPILLS = ("smart_fused_kernel",)


def phase_build():
    from vspbfr_tpu_torch.ops import _build

    lib = _build.load_library()
    say(f"kernel library {lib.path} built/loaded in "
        f"{lib.build_seconds:.2f} s")
    regs = ptxas_report(lib.log, (*SASS_REQUIRED, "epilogue_kernel",
                                  "fused_lrelu_kernel"))
    for fn, r in sorted(regs.items()):
        say(f"  ptxas: {r['registers']:3d} registers, spill stores "
            f"{r['spill_stores']} B, loads {r['spill_loads']} B: "
            f"{demangle(fn)}")
    REPORT["build_seconds"] = lib.build_seconds
    REPORT["ptxas"] = {demangle(fn): r for fn, r in regs.items()}
    for kernel in NO_SPILLS:
        spills = {demangle(fn): r for fn, r in regs.items()
                  if kernel in fn and (r["spill_stores"] or r["spill_loads"])}
        if spills or not any(kernel in fn for fn in regs):
            raise AssertionError(f"{kernel}: spills or no ptxas report: "
                                 f"{spills}")
    REPORT["tensor_core_lines"] = {}
    for kernel, required in SASS_REQUIRED.items():
        counts = sass_counts(lib.path, kernel)
        for fn, c in sorted(counts.items()):
            say("  " + " ".join(f"{op} {c[op]:4d}" for op in SASS_OPS)
                + f" lines in {demangle(fn)}")
        bf16 = {fn: c for fn, c in counts.items() if "nv_bfloat16" in fn}
        missing = [fn for fn, c in bf16.items()
                   if min(c[op] for op in required) == 0]
        if not bf16 or missing:
            raise AssertionError(f"{kernel}: a bf16 instantiation lacks "
                                 f"{required}: {missing or counts}")
        REPORT["tensor_core_lines"][kernel] = {
            demangle(fn): c for fn, c in counts.items()}


def demangle(name: str) -> str:
    """The C++ name of a mangled symbol (c++filt), or the symbol as it is
    where c++filt is missing."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True,
                              text=True, timeout=30,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name


def ptxas_report(log: str, kernels) -> dict[str, dict]:
    """Registers and spill bytes that `ptxas -v` reported in the build log
    for each entry function whose (mangled) name holds one of `kernels`."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if any(k in m.group(1) for k in kernels) else None
            if fn:
                out[fn] = {"registers": 0, "spill_stores": 0,
                           "spill_loads": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            fn = None
    return out


def sass_counts(so, kernel: str) -> dict[str, dict[str, int]]:
    """Lines of each of SASS_OPS (HMMA: mma.sync; HGMMA: wgmma; UTMALDG: a
    TMA load) in the SASS of each function of the library whose (mangled)
    name holds `kernel`."""
    from vspbfr_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn in counts:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


# --- phase 3 ----------------------------------------------------------------

def _k1_cases():
    # (x shape, w shape, pads, label): the profiler's K1_CASES
    from vspbfr_tpu_torch.cli.profile import K1_CASES

    return list(K1_CASES)


def _k2_cases():
    from vspbfr_tpu_torch.cli.profile import K2_SHAPES

    return [((4, h, h, c), "SMART %dpx C%d" % (h, c)) for h, c in K2_SHAPES]


def _k3_cases():
    return [((4, 256, 256, 256), 64, "decoder/RestoreNet 512px C64"),
            ((4, 512, 512, 128), 32, "decoder 1024px C32")]


def _k1e_cases():
    """(x shape, w shape, epilogue pieces, label) of the K1e convs on the
    stage-3 path at full width, b4, then K1e as a styled conv at each
    other shape of `_k1_cases`: "s" in_scale + out_scale (a styled conv),
    "n" noise, "b" bias + lrelu, "p" one post-activation add, "2" the
    second noise / bias / lrelu stage."""
    own = [
        ((4, 512, 512, 64), (3, 3, 64, 64), "b2",
         "SMART fusion 512px C64 +stage2"),
        ((4, 1024, 1024, 32), (3, 3, 32, 32), "snb", "styled 1024px C32"),
        ((4, 512, 512, 64), (3, 3, 64, 64), "b", "ResBlock.conv1 512px C64"),
        ((4, 4, 4, 513), (3, 3, 513, 512), "b", "final_conv 4px Ci513"),
        ((4, 128, 128, 256), (3, 3, 256, 256), "snb", "styled 128px C256"),
    ]
    seen = {case[:3] for case in own}
    return own + [(xs, ws, "snb", label) for xs, ws, _, label in _k1_cases()
                  if (xs, ws, "snb") not in seen]


def _k6_cases():
    """(x shape, epilogue pieces, label) of K6 on the main paths at full
    width, b4 (the profiler's K6_CASES, with the chain rows: the SMART
    tail's two stages and the StyledConv's two skips in one pass)."""
    from vspbfr_tpu_torch.cli.profile import K6_CASES

    return list(K6_CASES)


def _k7_cases():
    from vspbfr_tpu_torch.cli.profile import K7_CASES

    return list(K7_CASES)


def _k5_cases():
    return [((4, h, h, c), "SMART %dpx C%d" % (h, c))
            for h, c in ((512, 64), (64, 512), (4, 512))]


def k5_operands(rand, dt, xs) -> tuple:
    """(x, style, ws, wf) of a SMART layer at x's shape, in dt: Cb = C / 4,
    Cout = C, unscaled N(0, 1) weights (K5 scales them by 1/sqrt(fan_in))."""
    b, _, _, c = xs
    return (rand(*xs).to(dt), rand(b, c, scale=0.2, offset=1.0).to(dt),
            [rand(3, 3, c, c // 4).to(dt) for _ in range(4)],
            rand(3, 3, c, c).to(dt))


def k1e_operands(rand, dt, xs, ws, pieces) -> tuple:
    """(x, w, pads, kwargs of `dense_conv_epilogue`) for a `_k1e_cases`
    entry; every tensor in dt."""
    b, h, wd, ci = xs
    kh, _, _, co = ws
    p = kh // 2
    x = rand(*xs).to(dt)
    w = (rand(*ws) / (kh * kh * ci) ** 0.5).to(dt)
    kw = {}
    if "s" in pieces:
        kw.update(in_scale=rand(b, ci, scale=0.2, offset=1.0).to(dt),
                  out_scale=rand(b, co, scale=0.2, offset=1.0).to(dt))
    if "n" in pieces:
        kw["noise"] = rand(b, h, wd, 1, scale=0.3).to(dt)
    if "b" in pieces:
        kw.update(bias=rand(co, scale=0.3).to(dt), act=True)
    if "p" in pieces:
        kw["post_add"] = (rand(b, h, wd, co).to(dt),)
    if "2" in pieces:
        kw.update(noise2=rand(b, h, wd, 1, scale=0.3).to(dt),
                  bias2=rand(co, scale=0.3).to(dt), act2=True)
    return x, w, ((p, p), (p, p)), kw


def epi_work(x, w, kw, y) -> tuple[int, int]:
    """(operations, bytes) of one K1e call: the conv's, the input scale's
    multiply per input element, and per output element one operation for
    each other epilogue piece (two for an activation)."""
    tensors = [v for v in kw.values() if torch_is_tensor(v)]
    tensors += list(kw.get("post_add", ()))
    per = (sum(k in kw for k in ("out_scale", "noise", "bias", "noise2",
                                 "bias2"))
           + 2 * (bool(kw.get("act")) + bool(kw.get("act2")))
           + len(kw.get("post_add", ())))
    flops = (conv_flops(x.shape, w.shape, y.shape) + per * y.numel()
             + (x.numel() if "in_scale" in kw else 0))
    return flops, nbytes(x, w, y, *tensors)


def torch_is_tensor(v) -> bool:
    import torch

    return isinstance(v, torch.Tensor)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def conv_flops(x_shape, w_shape, y_shape) -> int:
    """Multiply-adds x 2 of a dense conv: per output element KH*KW*Ci."""
    kh, kw, ci, _ = w_shape
    return 2 * int(np.prod(y_shape)) * kh * kw * ci


def _check(name, label, dt_name, got, ref, ms, plain_ms, rows, flops=0,
           moved=0, library_ms=None, **extra):
    ref = ref.float()
    scale = float(ref.abs().max().clamp_min(1e-12))
    abs_err = float((got.float() - ref).abs().max())
    b_ms, b_by = bound(flops, moved, dt_name)
    _record(rows, dict(kernel=name, case=label, dtype=dt_name,
                       rel_err=abs_err / scale, max_abs_err=abs_err, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=b_ms, bound_by=b_by, flops=flops,
                       bytes=moved, **extra))


def _record(rows, r, exact=True):
    """Print a phase-3 row and keep it; raise if it missed its dtype's TOL,
    or was not `exact`."""
    name, label = r["kernel"], r["case"]
    dt_name, rel = r["dtype"], r["rel_err"]
    ok = rel <= TOL[dt_name] and exact
    lib = ("" if r["library_ms"] is None
           else f" library {r['library_ms']:.4f} ms")
    dev = ("" if "device_ms" not in r
           else f" (device {r['device_ms']:.4f} ms)")
    say(f"{name:20s} {label:28s} {dt_name:4s} rel_err {rel:.3e} "
        f"(abs {r['max_abs_err']:.3e}) kernel {r['ms']:.4f} ms{dev} plain "
        f"{r['plain_ms']:.4f} ms{lib} bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}) {'ok' if ok else 'FAIL'}")
    rows.append(r)
    if not ok:
        raise AssertionError(f"{name} {label} {dt_name}: rel err {rel:.3e} "
                             f"(limit {TOL[dt_name]}), exact {exact}")


def phase_kernels():
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli.profile import (copies, device_ms,
                                              k6_operands, k6_work,
                                              smart_composition, smart_work)
    from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc
    from vspbfr_tpu_torch.cli.profile import plan_label
    from vspbfr_tpu_torch.ops import _build
    from vspbfr_tpu_torch.ops.smart import smart_plan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, offset=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + offset

    def f32(kw):
        return {k: (tuple(t.float() for t in v) if k == "post_add" else
                    v.float() if torch_is_tensor(v) else v)
                for k, v in kw.items()}

    rows = []
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for xs, ws, pads, label in _k1_cases():
            x = rand(*xs).to(dt)
            w = (rand(*ws) / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dt)
            s = rand(xs[0], xs[3], scale=0.2, offset=1.0).to(dt)
            got = ops.dense_conv(x, w, pads, in_scale=s)
            ref = ops.dense_conv_plain(x.float(), w.float(), pads, s.float())
            ms = cuda_ms(lambda: ops.dense_conv(x, w, pads, in_scale=s))
            pms = cuda_ms(lambda: ops.dense_conv_plain(x, w, pads, s))
            # the library's conv (cuDNN) on the same input, scaled first
            xs_ = x * s[:, None, None, :]
            lms = cuda_ms(lambda: conv_nhwc(xs_, w, 1, pads))
            _check("dense_conv", label, dt_name, got, ref, ms, pms, rows,
                   flops=conv_flops(x.shape, w.shape, got.shape) + x.numel(),
                   moved=nbytes(x, w, s, got), library_ms=lms)
            del x, w, s, got, ref, xs_
        for xs, ws, pieces, label in _k1e_cases():
            x, w, pads, kw = k1e_operands(rand, dt, xs, ws, pieces)
            got = ops.dense_conv_epilogue(x, w, pads, **kw)
            ref = ops.dense_conv_epilogue_plain(x.float(), w.float(), pads,
                                                **f32(kw))
            ms = cuda_ms(lambda: ops.dense_conv_epilogue(x, w, pads, **kw))
            pms = cuda_ms(lambda: ops.dense_conv_epilogue_plain(x, w, pads,
                                                                **kw))
            # no one library call computes conv + epilogue: cuDNN's conv
            # alone is timed as the yardstick
            isc = kw.get("in_scale")
            xs_ = x if isc is None else x * isc[:, None, None, :]
            cms = cuda_ms(lambda: conv_nhwc(xs_, w, 1, pads))
            flops, moved = epi_work(x, w, kw, got)
            _check("dense_conv_epilogue", label, dt_name, got, ref, ms, pms,
                   rows, flops=flops, moved=moved, cudnn_conv_ms=cms)
            del x, w, kw, got, ref, xs_
        for xs, label in _k2_cases():
            c = xs[3]
            x = rand(*xs).to(dt)
            wl = [(rand(3, 3, c, c // 4) / (9 * c) ** 0.5).to(dt)
                  for _ in range(4)]
            s = rand(xs[0], c, scale=0.2, offset=1.0).to(dt)
            o = rand(xs[0], c, scale=0.2, offset=1.0).to(dt)
            dils = (1, 2, 4, 8)
            got = ops.dilated_multi_conv(x, wl, dils, in_scale=s, out_scale=o)
            ref = ops.dilated_multi_conv_plain(
                x.float(), [w.float() for w in wl], dils, s.float(), o.float())
            ms = cuda_ms(lambda: ops.dilated_multi_conv(
                x, wl, dils, in_scale=s, out_scale=o))
            pms = cuda_ms(lambda: ops.dilated_multi_conv_plain(
                x, wl, dils, s, o))
            # no one library call computes K2: the yardstick is a
            # composition, cuDNN's four dilated convs on x * in_scale and
            # the concatenation (out_scale left out)
            xs_ = x * s[:, None, None, :]
            cms = cuda_ms(lambda: torch.cat(
                [conv_nhwc(xs_, w, 1, ((d, d), (d, d)), dilation=d)
                 for w, d in zip(wl, dils)], dim=-1))
            _check("dilated_multi_conv", label, dt_name, got, ref, ms, pms,
                   rows, flops=2 * got.numel() * 9 * c,
                   moved=nbytes(x, *wl, s, o, got), composition_ms=cms)
            say(f"{'':20s} {label:28s} {dt_name:4s} cuDNN 4 dilated convs + "
                f"cat (composition) {cms:.4f} ms")
            del x, wl, s, o, got, ref, xs_
        for xs, inner, label in _k3_cases():
            x = rand(*xs).to(dt)
            got = ops.d2s(x, inner)
            ref = ops.d2s_plain(x.float(), inner)
            if not torch.equal(got.float(), ref):
                raise AssertionError(f"d2s {label} {dt_name}: not exact")
            ms = cuda_ms(lambda: ops.d2s(x, inner))
            pms = cuda_ms(lambda: ops.d2s_plain(x, inner))
            _check("d2s", label, dt_name, got, ref, ms, pms, rows,
                   moved=nbytes(x, got))
            del x, got, ref
        # K6 and K7: `ms` is one call's time on an idle stream (host
        # included, as the plain version's), `device_ms` the device's alone
        for xs, pieces, label in _k6_cases():
            x, kw = k6_operands(rand, dt, xs, pieces)
            before = ops.launch_counts()["conv_epilogue"]
            got = ops.conv_epilogue(x, **kw)
            if ops.launch_counts()["conv_epilogue"] != before + 1:
                raise AssertionError(f"conv_epilogue {label}: not one launch")
            ref = ops.epilogue_plain_chain(x.float(), **f32(kw))
            ms = cuda_ms(lambda: ops.conv_epilogue(x, **kw))
            flops, moved = k6_work(x, kw)

            def k6_call(xs=xs, pieces=pieces):
                x2, kw2 = k6_operands(rand, dt, xs, pieces)
                return lambda: ops.conv_epilogue(x2, **kw2)
            dms = device_ms(copies(k6_call, moved))
            pms = cuda_ms(lambda: ops.epilogue_plain_chain(x, **kw))
            _check("conv_epilogue", label, dt_name, got, ref, ms, pms, rows,
                   flops=flops, moved=moved, device_ms=dms)
            del x, kw, got, ref
        for xs, label in _k7_cases():
            x = rand(*xs).to(dt)
            bias = rand(xs[-1], scale=0.3).to(dt)
            got = ops.fused_leaky_relu(x, bias)
            ref = ops.fused_leaky_relu_plain(x.float(), bias.float())
            ms = cuda_ms(lambda: ops.fused_leaky_relu(x, bias))

            def k7_call(xs=xs):
                x2, b2 = rand(*xs).to(dt), rand(xs[-1], scale=0.3).to(dt)
                return lambda: ops.fused_leaky_relu(x2, b2)
            dms = device_ms(copies(k7_call, nbytes(x, bias, got)))
            pms = cuda_ms(lambda: ops.fused_leaky_relu_plain(x, bias))
            _check("fused_leaky_relu", label, dt_name, got, ref, ms, pms,
                   rows, flops=3 * x.numel(), moved=nbytes(x, bias, got),
                   device_ms=dms)
            del x, bias, got, ref
        for xs, label in _k5_cases():
            b, h, w, c = xs
            x, style, wl, wf = k5_operands(rand, dt, xs)
            got = ops.smart_core(x, style, wl, wf)
            ref = ops.smart_core_plain(x.float(), style.float(),
                                       [t.float() for t in wl], wf.float())
            ms = cuda_ms(lambda: ops.smart_core(x, style, wl, wf))
            pms = cuda_ms(lambda: ops.smart_core_plain(x, style, wl, wf))
            comp_ms = cuda_ms(lambda: smart_composition(x, style, wl, wf))
            flops, moved = smart_work(b, h, w, c, c // 4, c,
                                      x.element_size())
            plan = smart_plan(dt == torch.bfloat16, b, h, w, c, c // 4, c,
                              _build.multiprocessors(dev))
            _check("smart_core", label, dt_name, got, ref, ms, pms, rows,
                   flops=flops, moved=moved, composition_ms=comp_ms,
                   plan=plan)
            say(f"{'':20s} {label:28s} {dt_name:4s} K2 + K1 composition "
                f"{comp_ms:.4f} ms ({plan_label(plan)})")
            del x, style, wl, wf, got, ref
        torch.cuda.empty_cache()
        _experiment_kernels(rows, dt_name, dt)
        torch.cuda.empty_cache()
    REPORT["kernels"] = rows


def _experiment_kernels(rows, dt_name, dt):
    """K8, K9 and K10 at the TPU experiments' full shapes, b4, in dt,
    measured by the functions of their `cli.profile` entries: K8 exactly
    (K3's time beside it), K9 and K10 against their plain versions in the
    region each defines (`nomemset`: columns 1 .. W-2), cuDNN's conv as
    their library call."""
    from vspbfr_tpu_torch.cli import profile

    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "flops", "bytes")

    def record(name, label, r, exact=True, **extra):
        _record(rows, dict(kernel=name, case=label, dtype=dt_name,
                           rel_err=r["max_rel_diff"],
                           **{k: r[k] for k in keys}, **extra), exact)

    for r in profile.profile_interleave(dt):
        record(f"interleave_{r['form']}",
               f"b{r['batch']} h{r['h']} inner {r['inner']}", r, r["exact"],
               k3_ms=r["k3_ms"])
    for r in profile.profile_stripe_conv(dt):
        xs, ws = r["x"], r["w"]
        record("stripe_conv", f"{xs[1]}px C{xs[3]} {ws[0]}x{ws[1]}->{ws[3]}",
               r)
    for r in profile.profile_inkpad(dt):
        record("inkpad_conv", f"{r['variant']} h_t {r['h_t']}", r)


# --- phase 4 ----------------------------------------------------------------

def _condition_diffuser(pipe, factor: float = 4.0):
    """Sharpen the random-init diffuser's spatial-attention softmax (q/k
    kernels x4): at init it is almost uniform over 512 features and the
    LayerNorm after it amplifies f32 rounding by ~1e4, which would make any
    two devices disagree. tests/test_torch_pipeline.py does the same."""
    import torch

    with torch.no_grad():
        for blk in pipe.diffuser.block:
            blk.attention_layer.q.kernel.mul_(factor)
            blk.attention_layer.k.kernel.mul_(factor)


def _draws(pipe, batch, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    n_lat = pipe.psp.n_latent
    idx = (int(rng.integers(1, pipe.generator.n_latent))
           if rng.uniform() < pipe.mixing_prob else pipe.generator.n_latent)
    return {"init_noise": torch.tensor(rng.standard_normal(
                (batch, n_lat, 512)).astype(np.float32), device=device),
            "z": torch.tensor(rng.standard_normal(
                (2, batch, pipe.style_dim)).astype(np.float32),
                device=device),
            "inject_index": idx}


def synthetic_faces(n: int, size: int, seed: int, clean: bool = False):
    """n degraded face-like (size, size, 3) images in [-1, 1]: an ellipse
    face with eyes and mouth over a background, colour blotches, 4x
    box-downsampled and re-upsampled, plus noise. With `clean`, returns
    (degraded, clean): the clean faces are the same images before the
    downsampling and the noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[-1:1:size * 1j, -1:1:size * 1j]
    out, gt = [], []
    for _ in range(n):
        img = np.broadcast_to(rng.uniform(-1, 0, 3), (size, size, 3)).copy()
        face = (xx / rng.uniform(0.5, 0.7)) ** 2 + (yy / 0.8) ** 2 < 1
        img[face] = rng.uniform(-0.2, 0.6, 3)
        for ex in (-0.25, 0.25):
            img[(xx - ex) ** 2 + (yy + 0.2) ** 2 < 0.01] = -0.8
        img[(np.abs(xx) < 0.25) & (np.abs(yy - 0.4) < 0.04)] = -0.5
        coarse = rng.standard_normal((size // 32, size // 32, 3)) * 0.15
        img += np.kron(coarse, np.ones((32, 32, 1)))
        gt.append(np.clip(img, -1, 1).astype(np.float32))
        low = img.reshape(size // 4, 4, size // 4, 4, 3).mean(axis=(1, 3))
        img = np.kron(low, np.ones((4, 4, 1)))
        img += rng.standard_normal(img.shape) * 0.05
        out.append(np.clip(img, -1, 1).astype(np.float32))
    return (np.stack(out), np.stack(gt)) if clean else np.stack(out)


def phase_slice():
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    cfg = dict(size=128, decoder_size=256, encode_size=64,
               encoder_stages=TINY_STAGES, channel_div=4)
    cpu = RestorationPipeline(**cfg).init_from_seed(1).eval()
    _condition_diffuser(cpu)
    card = RestorationPipeline(**cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    low = torch.tensor(synthetic_faces(1, 128, seed=2))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_g, smp_g = card.restore(
        low.cuda(), torch.Generator(device="cuda").manual_seed(0),
        return_sample=True, draws=_draws(card, 1, 3, "cuda"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    out_c, smp_c = cpu.restore(low, torch.Generator().manual_seed(0),
                               return_sample=True,
                               draws=_draws(cpu, 1, 3, "cpu"))
    t_cpu = time.perf_counter() - t0
    say(f"slice (size 128, decoder 256, channel_div 4, b1): card "
        f"{t_card:.3f} s (first call), CPU {t_cpu:.3f} s; launches {counts}")
    res = {"launches": counts}
    for name, g, c in (("restored", out_g, out_c), ("sample", smp_g, smp_c)):
        g, c = g.float().cpu(), c.float()
        if g.shape != c.shape or not torch.isfinite(g).all():
            raise AssertionError(f"slice {name}: shape {tuple(g.shape)} "
                                 f"vs {tuple(c.shape)} or non-finite")
        rng_ = float(c.max() - c.min())
        err = (g - c).abs()
        mean_r, max_r = float(err.mean()) / rng_, float(err.max()) / rng_
        say(f"slice {name}: range {rng_:.4f} mean|err|/range {mean_r:.3e} "
            f"max|err|/range {max_r:.3e}")
        res[name] = dict(range=rng_, mean_rel=mean_r, max_rel=max_r)
        if mean_r > 1e-3 or max_r > 1e-2:
            raise AssertionError(f"slice {name}: card vs CPU out of bounds")
    missing = [k for k in PATH_KERNELS["serve"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"slice: kernels never launched: {missing}")
    REPORT["slice"] = res


# --- phase 5 ----------------------------------------------------------------

def phase_cli():
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli import infer
    from vspbfr_tpu_torch.evaluation import psnr
    from vspbfr_tpu_torch.losses import LPIPS, InceptionV3Features
    from vspbfr_tpu_torch.models.layers import init_module
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    faces, clean = synthetic_faces(8, 512, seed=5, clean=True)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        lq, hq = os.path.join(tmp, "lq"), os.path.join(tmp, "hq")
        os.makedirs(lq)
        os.makedirs(hq)
        for i, (f, g) in enumerate(zip(faces, clean)):
            np.save(os.path.join(lq, f"face{i}.npy"), f)
            np.save(os.path.join(hq, f"face{i}.npy"), g)
        # the scorers' weights: seeded, written where the flags read them
        nets = {}
        for name, net, seed in (("lpips", LPIPS(), 41),
                                ("inception", InceptionV3Features(), 42)):
            nets[name] = os.path.join(tmp, f"{name}.pt")
            torch.save(init_module(net, torch.Generator().manual_seed(
                seed)).state_dict(), nets[name])
        for mode in ("f32", "bf16"):
            out = os.path.join(tmp, f"out_{mode}")
            argv = ["--lq_dirs", lq, "--hq_dirs", hq, "--out", out,
                    "--batch", "4", "--device", "cuda", "--seed", "0",
                    "--lpips_ckpt", nets["lpips"],
                    "--inception_ckpt", nets["inception"]]
            if mode == "bf16":
                argv.append("--bf16")
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rep = infer.main(argv)["datasets"]["data0"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            files = sorted(os.listdir(os.path.join(out, "data0")))
            restored = [f for f in files if "_restore" in f]
            if rep["n"] != 8 or len(restored) != 8:
                raise AssertionError(f"cli {mode}: {rep['n']} answered, "
                                     f"{len(restored)} written")
            for f in restored:
                if f.endswith(".npy"):
                    a = np.load(os.path.join(out, "data0", f))
                    if a.shape != (512, 512, 3) or not np.isfinite(a).all():
                        raise AssertionError(f"cli {mode}: bad output {f}")
            secs = rep["batch_seconds"]
            ips = 4 * (len(secs) - 1) / sum(secs[1:])
            scores = {k: rep[k] for k in ("psnr", "ssim", "lpips", "fid")}
            if not all(np.isfinite(v) for v in scores.values()):
                raise AssertionError(f"cli {mode}: non-finite scores "
                                     f"{scores}")
            say(f"cli {mode}: 8 requests at b4, batch seconds "
                f"{[round(s, 4) for s in secs]}, {ips:.3f} imgs/s "
                f"(one batch, first excluded: a smoke figure), peak "
                f"{peak:.3f} GiB, wall {wall:.1f} s incl. init; launches "
                f"{counts}")
            say(f"cli {mode} scoring against GT (seeded LPIPS and "
                f"InceptionV3): {scores}; scoring seconds per batch "
                f"{[round(x, 4) for x in rep['score_seconds']]} beside "
                f"restore seconds {[round(x, 4) for x in secs]}")
            missing = [k for k in PATH_KERNELS["serve"] if counts[k] == 0]
            if missing:
                raise AssertionError(f"cli {mode}: kernels never launched: "
                                     f"{missing}")
            res[mode] = dict(batch_seconds=secs, imgs_per_s=ips,
                             score_seconds=rep["score_seconds"],
                             scores=scores, peak_gib=peak, launches=counts,
                             output_format=os.path.splitext(restored[0])[1])
    torch.cuda.empty_cache()

    # stage split and bf16-vs-f32 on the same inputs and draws
    base = RestorationPipeline().init_from_seed(0).eval()
    p32 = RestorationPipeline()
    p32.load_state_dict(base.state_dict())
    p32 = p32.cuda().eval()
    p16 = RestorationPipeline(compute_dtype=torch.bfloat16)
    p16.load_state_dict(base.state_dict())
    p16 = p16.cuda().eval().prepare_params()
    del base
    low = torch.tensor(faces[:4], device="cuda")

    def run(p, upto="full", sample=False):
        return p.restore(low, torch.Generator(device="cuda").manual_seed(0),
                         upto=upto, return_sample=sample)

    for mode, p in (("f32", p32), ("bf16", p16)):
        ms = {u: cuda_ms(lambda: run(p, u), iters=5, warmup=1)
              for u in ("encode", "ddpm", "decode", "full")}
        ms_sample = cuda_ms(lambda: run(p, "full", True), iters=10, warmup=1)
        split = {"encode": ms["encode"], "ddpm": ms["ddpm"] - ms["encode"],
                 "decode": ms["decode"] - ms["ddpm"],
                 "restore": ms["full"] - ms["decode"]}
        say(f"stage split {mode} b4 (ms, median of 5): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items())
            + f"; full {ms['full']:.3f}")
        # the CLI's call (restore with the sample image), median of 10
        ips = 4e3 / ms_sample
        say(f"restore with sample image {mode} b4: {ms_sample:.3f} ms "
            f"(median of 10 CUDA-event runs) = {ips:.3f} imgs/s")
        # the epilogue switch: K1 + the torch epilogue (off) against K1e
        # (on), in turns off, on, on, off, median of 5 each
        ab = {"0": [], "1": []}
        for flag in ("0", "1", "1", "0"):
            with fused_epi(flag):
                ab[flag].append(cuda_ms(lambda: run(p, "full", True),
                                        iters=5, warmup=1))
        with fused_epi("1"):
            ops.reset_launch_counts()
            out_on = run(p).float()
            on_counts = ops.launch_counts()
        out_off = run(p).float()
        if on_counts["dense_conv_epilogue"] == 0 or not torch.isfinite(
                out_on).all():
            raise AssertionError(f"cli {mode}: switch on, K1e launches "
                                 f"{on_counts}, or non-finite output")
        on_off_psnr = float(psnr(out_on, out_off, data_range=max(
            2 * float(out_off.abs().max()), 2.0)).mean())
        say(f"restore {mode} b4, VSPBFR_FUSED_EPI off / on (ms, medians of 5 "
            f"in turns off, on, on, off): {ab['0']} / {ab['1']}; switch on "
            f"launches {on_counts}; on vs off PSNR {on_off_psnr:.3f} dB")
        res[mode].update(prefix_ms=ms, stage_ms=split,
                         full_with_sample_ms=ms_sample,
                         imgs_per_s_median=ips,
                         fused_epi_ab_ms={"off": ab["0"], "on": ab["1"]},
                         fused_epi_launches=on_counts,
                         fused_epi_on_vs_off_psnr_db=on_off_psnr)
    out32 = run(p32).float()
    out16 = run(p16).float()
    if not (torch.isfinite(out32).all() and torch.isfinite(out16).all()):
        raise AssertionError("cli: non-finite pipeline output")
    data_range = max(2 * float(out32.abs().max()), 2.0)
    p = float(psnr(out16, out32, data_range=data_range).mean())
    say(f"bf16 vs f32 PSNR on the same 4 inputs and draws: {p:.3f} dB "
        f"(data range {data_range:.3f})")
    res["bf16_vs_f32_psnr_db"] = p
    del p32, p16
    torch.cuda.empty_cache()
    res["scoring_split"] = _scoring_split(faces[:4], clean[:4])
    REPORT["cli"] = res


def _scoring_split(restored, gt):
    """Where the infer CLI's scoring time goes on one b4 batch at 512 px
    (seeded scorers): CUDA-event medians of PSNR + SSIM, LPIPS, and the
    InceptionV3 features of both images, and the host-clock time of the
    two float64 FeatureStats updates."""
    import torch

    from vspbfr_tpu_torch.evaluation import FeatureStats, psnr, ssim
    from vspbfr_tpu_torch.losses import (LPIPS, InceptionV3Features,
                                         make_inception_feature_fn)
    from vspbfr_tpu_torch.models.layers import init_module

    r, g = (torch.tensor(x, device="cuda") for x in (restored, gt))
    lp = init_module(LPIPS(), torch.Generator().manual_seed(41))
    lp = lp.cuda().eval().requires_grad_(False)
    inc = init_module(InceptionV3Features(),
                      torch.Generator().manual_seed(42))
    feat = make_inception_feature_fn(inc.cuda().eval().requires_grad_(False))
    with torch.no_grad():
        ms = {"psnr_ssim": cuda_ms(lambda: (psnr(r, g), ssim(r, g)), 5, 1),
              "lpips": cuda_ms(lambda: lp(r, g), 5, 1),
              "inception_both": cuda_ms(lambda: (feat(r), feat(g)), 5, 1)}
        fr, fg = feat(r).cpu(), feat(g).cpu()
    stats = (FeatureStats(fr.shape[1]), FeatureStats(fg.shape[1]))
    t0 = time.perf_counter()
    for _ in range(5):
        stats[0].update(fr)
        stats[1].update(fg)
    ms["feature_stats_host"] = (time.perf_counter() - t0) / 5 * 1e3
    say("scoring split, one b4 batch at 512 px (ms; CUDA-event medians of "
        "5, FeatureStats host clock): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()))
    return ms


# --- phase 6 ----------------------------------------------------------------

def _k1_grad_cases():
    # every K1 shape of phase 3: the 3x3 StyledConvs, the assembled
    # subpixel up-convs (K1 + K3 in the forward, K4 + K1's dx in the
    # backward) and LargeConv's two 1x1 convs
    return _k1_cases()


def _timed_grads(fn, leaves, g):
    """Median CUDA-event ms of the backward of fn(*leaves) (the forward
    runs once, outside the timing)."""
    import torch

    out = fn(*leaves)
    ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                             retain_graph=True))
    del out
    return ms


def _grads_vs_plain(kernel_fn, plain_fn, leaves, g):
    """(kernel's gradients, plain autograd's in f32 on the same inputs,
    kernel backward ms, plain backward ms in the same dtype)."""
    import torch

    got = torch.autograd.grad(kernel_fn(*leaves), leaves, g)
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    ref = torch.autograd.grad(plain_fn(*ref_leaves), ref_leaves, g.float())
    ms = _timed_grads(kernel_fn, leaves, g)
    same = [t.detach().requires_grad_() for t in leaves]
    pms = _timed_grads(plain_fn, same, g)
    return got, ref, ms, pms


def scaled_input(x, s, dt):
    """x * in_scale rounded to dt where x is wider (its gradient unchanged):
    K1 and K1e, like the TPU kernel and the plain version at the working
    dtype, round the scaled input to x's dtype before the products. The f32
    references of the K1e gradient checks round there too: where the
    rounding moves a pre-activation across 0, the slope changes by 5x in
    that element."""
    xs = x * s[:, None, None, :]
    if xs.dtype == dt:
        return xs
    return xs + (xs.to(dt).to(xs.dtype) - xs).detach()


def kink_free(x, w, pads, kw, band: float = 1e-5):
    """The output elements where each activation's input (from the plain
    version in f32) lies more than band x its max |.| away from 0. The
    slope of lrelu jumps by 5x at 0, so where two correct computations
    round a value there to opposite signs their gradients differ by O(1)
    in that element (the max-error check sees it at full width); the K1e
    gradient checks give those elements (a few in 1e5) no incoming
    gradient."""
    import torch

    from vspbfr_tpu_torch import ops

    def f32(t):
        return None if t is None else t.float()

    xs = x.float()
    if kw.get("in_scale") is not None:
        xs = scaled_input(xs, kw["in_scale"].float(), x.dtype)
    u = ops.epilogue_plain_chain(
        ops.dense_conv_plain(xs, w.float(), pads),
        f32(kw.get("out_scale")), f32(kw.get("noise")), f32(kw.get("bias")),
        act=False)
    keep = torch.ones_like(u, dtype=torch.bool)
    if kw.get("act"):
        keep &= u.abs() > band * u.abs().max()
    if kw.get("act2"):
        t = ops.epilogue_plain_chain(u, act=kw.get("act", False),
                               post_add=tuple(f32(p) for p in
                                              kw.get("post_add", ())),
                               noise2=f32(kw.get("noise2")),
                               bias2=f32(kw.get("bias2")))
        keep &= t.abs() > band * t.abs().max()
    return keep


def phase_grads():
    import torch

    from vspbfr_tpu_torch import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, scale=1.0, offset=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + offset

    rows = []
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for xs, ws, pads, label in _k1_grad_cases():
            x = rand(*xs).to(dt).requires_grad_()
            w = (rand(*ws) / (ws[0] * ws[1] * ws[2]) ** 0.5).to(
                dt).requires_grad_()
            s = rand(xs[0], xs[3], scale=0.2, offset=1.0).to(
                dt).requires_grad_()
            out = ops.dense_conv(x, w, pads, in_scale=s)
            g = rand(*out.shape).to(dt)
            before = ops.launch_counts()["dense_conv"]
            got = torch.autograd.grad(out, (x, s, w), g)
            if ops.launch_counts()["dense_conv"] != before + 1:
                raise AssertionError(f"dense_conv grad {label}: dx did not "
                                     "launch K1 once")
            leaves = [t.detach().float().requires_grad_() for t in (x, s, w)]
            ref_out = ops.dense_conv_plain(leaves[0], leaves[2], pads,
                                           leaves[1])
            ref = torch.autograd.grad(ref_out, leaves, g.float())
            del ref_out
            # the timed backward is the training one: dx and d_in_scale (w is
            # frozen), kernel vs plain autograd on the same dtype
            wd = w.detach()
            out_k = ops.dense_conv(x, wd, pads, in_scale=s)
            ms = cuda_ms(lambda: torch.autograd.grad(out_k, (x, s), g,
                                                     retain_graph=True))
            del out_k
            xp, sp = x.detach().requires_grad_(), s.detach().requires_grad_()
            out_p = ops.dense_conv_plain(xp, wd, pads, sp)
            pms = cuda_ms(lambda: torch.autograd.grad(out_p, (xp, sp), g,
                                                      retain_graph=True))
            del out_p
            # the library's dx: cuDNN's dgrad of the conv on the same
            # gradient (the in_scale multiply aside)
            gn, wn = g.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1)
            xn_shape = (xs[0], xs[3], xs[1], xs[2])
            lms = cuda_ms(lambda: torch.nn.grad.conv2d_input(
                xn_shape, wn, gn, padding=(pads[0][0], pads[1][0])))
            # dx is a conv of the same size as the forward; d_in_scale one
            # multiply-add per input element
            work = dict(flops=conv_flops(x.shape, w.shape, g.shape)
                        + 2 * x.numel(), moved=nbytes(g, w, x, s, x, s),
                        library_ms=lms)
            for name, a, b in zip(("dx", "d_in_scale", "dw"), got, ref):
                timed = name == "dx"
                _check(f"dense_conv_grad {name}", label, dt_name, a, b,
                       ms if timed else float("nan"),
                       pms if timed else float("nan"), rows,
                       **(work if timed else {}))
            del x, w, s, g, got, ref, leaves
        for xs, ws, pieces, label in _k1e_cases()[:4]:
            # K1e's Function: every operand's gradient, dx a K1 launch
            x, w, pads, kw = k1e_operands(rand, dt, xs, ws, pieces)
            names = [k for k, v in kw.items() if torch_is_tensor(v)]
            flags = {k: v for k, v in kw.items() if not torch_is_tensor(v)}
            leaves = [x, w] + [kw[k] for k in names]
            for t in leaves:
                t.requires_grad_()

            def k1e(x_, w_, *ops_, fn=ops.dense_conv_epilogue):
                return fn(x_, w_, pads, **dict(zip(names, ops_)), **flags)

            def plain(x_, w_, *ops_):
                kw_ = dict(zip(names, ops_))
                s_ = kw_.pop("in_scale", None)
                if s_ is not None:
                    x_ = scaled_input(x_, s_, dt)
                return ops.dense_conv_epilogue_plain(x_, w_, pads, **kw_,
                                                     **flags)

            out = k1e(*leaves)
            keep = kink_free(x, w, pads, kw)
            g = (rand(*out.shape) * keep).to(dt)
            kinks = 1.0 - float(keep.float().mean())
            work = epi_work(x, w, kw, out)
            del out, keep
            before = ops.launch_counts()["dense_conv"]
            got, ref, ms, pms = _grads_vs_plain(k1e, plain, leaves, g)
            # the timed backward: dx and dw, each a conv of the forward's
            # size, plus the epilogue's elementwise work again
            work = dict(flops=2 * work[0], moved=2 * work[1])
            if ops.launch_counts()["dense_conv"] == before:
                raise AssertionError(f"dense_conv_epilogue grad {label}: dx "
                                     "did not launch K1")
            for i, (name, a, b) in enumerate(zip(["dx", "dw", *names], got,
                                                 ref)):
                _check(f"dense_conv_epilogue_grad {name}", label, dt_name,
                       a, b, ms if i == 0 else float("nan"),
                       pms if i == 0 else float("nan"), rows,
                       kink_share=kinks, **(work if i == 0 else {}))
            del x, w, kw, leaves, g, got, ref
        for xs, label in _k2_cases()[1:4]:
            # K2's Function: dx, the four branch weights, d_in_scale and
            # d_out_scale (cuDNN's convs in its backward, as XLA's in JAX)
            c, dils = xs[3], (1, 2, 4, 8)
            leaves = [rand(*xs).to(dt)] + [
                (rand(3, 3, c, c // 4) / (9 * c) ** 0.5).to(dt)
                for _ in range(4)] + [
                rand(xs[0], c, scale=0.2, offset=1.0).to(dt)
                for _ in range(2)]
            for t in leaves:
                t.requires_grad_()

            def k2(x_, *rest, fn=ops.dilated_multi_conv):
                return fn(x_, list(rest[:4]), dils, in_scale=rest[4],
                          out_scale=rest[5])

            def plain(x_, *rest):
                return k2(x_, *rest, fn=ops.dilated_multi_conv_plain)

            g = rand(*xs).to(dt)
            before = ops.launch_counts()["dilated_multi_conv"]
            got, ref, ms, pms = _grads_vs_plain(k2, plain, leaves, g)
            if ops.launch_counts()["dilated_multi_conv"] == before:
                raise AssertionError(f"dilated_multi_conv grad {label}: the "
                                     "forward did not launch K2")
            work = dict(flops=2 * 2 * g.numel() * 9 * c,
                        moved=nbytes(*leaves, g, *leaves))
            names = ["dx", "dw1", "dw2", "dw4", "dw8", "d_in_scale",
                     "d_out_scale"]
            for i, (name, a, b) in enumerate(zip(names, got, ref)):
                _check(f"dilated_multi_conv_grad {name}", label, dt_name, a,
                       b, ms if i == 0 else float("nan"),
                       pms if i == 0 else float("nan"), rows,
                       **(work if i == 0 else {}))
            del leaves, g, got, ref
        for xs, inner, label in _k3_cases():
            # K4 gathers what K3 interleaved: its input is K3's output
            b, h, w, _ = xs
            y = rand(b, 2 * h, 2 * w, inner).to(dt)
            got = ops.s2d(y, inner)
            ref = ops.s2d_plain(y, inner)
            if not torch.equal(got, ref):
                raise AssertionError(f"s2d {label} {dt_name}: not exact")
            ms = cuda_ms(lambda: ops.s2d(y, inner))
            pms = cuda_ms(lambda: ops.s2d_plain(y, inner).contiguous())
            _check("s2d", label, dt_name, got, ref, ms, pms, rows,
                   moved=nbytes(y, got))
            del y, got, ref
        _elementwise_grads(rows, rand, dt_name, dt)
        _smart_grads(rows, rand, dt_name, dt)
        torch.cuda.empty_cache()
    REPORT["grads"] = rows


def _kink_keep(u, band: float = 1e-5):
    """Where an activation's input u (from the plain version in f32) lies
    more than band x max |u| away from the kink (see `kink_free`)."""
    return u.abs() > band * u.abs().max()


def _elementwise_grads(rows, rand, dt_name, dt):
    """K6's and K7's Functions (every operand, the chain rows' post-adds
    and second stage too; the activations' kink elements get no incoming
    gradient) against plain autograd, and K6's double backward in R1's
    pattern (D's strided ConvLayers, bias + lrelu; and the SMART tail's
    chain): the bias gradient of |dL/dx|^2."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli.profile import k6_operands

    def f32(t):
        return None if t is None else t.float()

    for xs, pieces, label in _k6_cases():
        x, kw = k6_operands(rand, dt, xs, pieces)
        flags = {k: kw.pop(k) for k in ("act", "act2") if k in kw}
        post = kw.pop("post_add", ())
        names = list(kw)
        leaves = [x, *kw.values(), *post]
        for t in leaves:
            t.requires_grad_()

        def k6(x_, *o, fn=ops.conv_epilogue):
            return fn(x_, **dict(zip(names, o)),
                      post_add=tuple(o[len(names):]), **flags)

        def plain(x_, *o):
            return k6(x_, *o, fn=ops.epilogue_plain_chain)

        # the pre-activations of both stages, from the plain chain in f32
        keep = torch.ones(xs, dtype=torch.bool, device=x.device)
        ops32 = {k: f32(v.detach()) for k, v in kw.items()}
        stage1 = {k: v for k, v in ops32.items() if not k.endswith("2")}
        u = ops.epilogue_plain(x.detach().float(), act=False, **stage1)
        if flags.get("act"):
            keep &= _kink_keep(u)
        if flags.get("act2"):
            u2 = ops.epilogue_plain_chain(
                u, act=flags["act"], post_add=tuple(
                    p.detach().float() for p in post),
                noise2=ops32.get("noise2"), bias2=ops32.get("bias2"))
            keep &= _kink_keep(u2)
            del u2
        del u
        g = (rand(*xs) * keep).to(dt)
        kinks = 1.0 - float(keep.float().mean())
        del keep
        got, ref, ms, pms = _grads_vs_plain(k6, plain, leaves, g)
        # the timed backward reads g and y (or x) and writes dx
        work = dict(flops=2 * x.numel(), moved=nbytes(g, x, x))
        grad_names = ["dx", *names, *(f"post{i}" for i in range(len(post)))]
        for i, (name, a, b) in enumerate(zip(grad_names, got, ref)):
            _check(f"conv_epilogue_grad {name}", label, dt_name, a, b,
                   ms if i == 0 else float("nan"),
                   pms if i == 0 else float("nan"), rows, kink_share=kinks,
                   **(work if i == 0 else {}))
        del x, kw, leaves, g, got, ref

    # R1 through K6: D's ConvLayer at 512 px C64 (bias + lrelu), and the
    # SMART tail's chain at the same shape (bias + lrelu, then noise2,
    # bias2 + lrelu), one K6 pass each
    x = rand(4, 512, 512, 64).to(dt)
    bias = rand(64, scale=0.3).to(dt)
    tail = dict(noise2=rand(4, 512, 512, 1, scale=0.3).to(dt),
                bias2=rand(64, scale=0.3).to(dt), act2=True)

    def r1(fn, x_, b_, **kw):
        x_ = x_.detach().requires_grad_()
        b_ = b_.detach().requires_grad_()
        (gx,) = torch.autograd.grad((fn(x_, bias=b_, **kw).float() ** 2).sum(),
                                    x_, create_graph=True)
        return torch.autograd.grad((gx.float() ** 2).sum(), b_)[0]

    for label, kw in (("D ConvLayer 512px C64", {}),
                      ("chain SMART tail 512px C64", tail)):
        kw32 = {k: (v.float() if torch_is_tensor(v) else v)
                for k, v in kw.items()}
        got = r1(ops.conv_epilogue, x, bias, **kw)
        ref = r1(ops.epilogue_plain_chain, x.float(), bias.float(), **kw32)
        ms = cuda_ms(lambda: r1(ops.conv_epilogue, x, bias, **kw), iters=5)
        pms = cuda_ms(lambda: r1(ops.epilogue_plain_chain, x, bias, **kw),
                      iters=5)
        _check("conv_epilogue_grad r1 d_bias", label, dt_name, got, ref, ms,
               pms, rows)
        del got, ref
    del x, bias, tail

    for xs, label in _k7_cases():
        x = rand(*xs).to(dt).requires_grad_()
        bias = rand(xs[-1], scale=0.3).to(dt).requires_grad_()
        keep = _kink_keep(x.detach().float() + bias.detach().float())
        g = (rand(*xs) * keep).to(dt)
        kinks = 1.0 - float(keep.float().mean())
        got, ref, ms, pms = _grads_vs_plain(
            ops.fused_leaky_relu, ops.fused_leaky_relu_plain, [x, bias], g)
        work = dict(flops=2 * x.numel(), moved=nbytes(g, x, x))
        for i, (name, a, b) in enumerate(zip(["dx", "d_bias"], got, ref)):
            _check(f"fused_leaky_relu_grad {name}", label, dt_name, a, b,
                   ms if i == 0 else float("nan"),
                   pms if i == 0 else float("nan"), rows, kink_share=kinks,
                   **(work if i == 0 else {}))
        del x, bias, g, got, ref


def _smart_grads(rows, rand, dt_name, dt):
    """K5's Function (its backward recomputes the K2 + K1 composition, so
    both launch in it) against plain autograd, every input."""
    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli.profile import smart_grad_work

    for xs, label in _k5_cases():
        x, style, wl, wf = k5_operands(rand, dt, xs)
        leaves = [x, style, *wl, wf]
        for t in leaves:
            t.requires_grad_()

        def k5(x_, s_, w1, w2, w4, w8, f_, fn=ops.smart_core):
            return fn(x_, s_, [w1, w2, w4, w8], f_)

        def plain(*a):
            return k5(*a, fn=ops.smart_core_plain)

        g = rand(*xs).to(dt)
        before = ops.launch_counts()
        got, ref, ms, pms = _grads_vs_plain(k5, plain, leaves, g)
        after = ops.launch_counts()
        if any(after[k] == before[k] for k in ("dilated_multi_conv",
                                               "dense_conv")):
            raise AssertionError(f"smart_core grad {label}: K2 and K1 did "
                                 "not launch in the backward")
        names = ["dx", "d_style", "dw1", "dw2", "dw4", "dw8", "dwf"]
        # the bound of the whole backward stands on the dx row, with its time
        flops, moved = smart_grad_work(xs[0], xs[1], xs[2], xs[3],
                                       xs[3] // 4, xs[3], x.element_size())
        for i, (name, a, b) in enumerate(zip(names, got, ref)):
            _check(f"smart_core_grad {name}", label, dt_name, a, b,
                   ms if i == 0 else float("nan"),
                   pms if i == 0 else float("nan"), rows,
                   flops=flops if i == 0 else 0,
                   moved=moved if i == 0 else 0)
        del x, style, wl, wf, leaves, g, got, ref


# --- phase 7 ----------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _train_step_card_vs_cpu(res):
    """One stage-2 step at the phase-4 config, card vs CPU, same weights,
    batch and draws. The random-init chain amplifies rounding (see
    tests/test_torch_train.py), so the card is held to the CPU as closely
    as the CPU agrees with itself when its inputs move by +-1e-6: error
    <= 10 x that spread + 1e-5, per metric and over the diffuser's
    gradients (worst tensor)."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    pcfg = dict(size=128, decoder_size=256, encode_size=64,
                encoder_stages=TINY_STAGES, channel_div=4)
    tcfg = DiffuserTrainConfig(size=128, batch=2)
    cpu = DiffuserTrainer(tcfg, RestorationPipeline(**pcfg)).init_from_seed(1)
    _condition_diffuser(cpu.pipe)
    card = DiffuserTrainer(tcfg, RestorationPipeline(**pcfg))
    for name, m in cpu.modules.items():
        card.modules[name].load_state_dict(m.state_dict())
    card.to("cuda")
    low = torch.tensor(synthetic_faces(2, 128, seed=11))
    real = torch.tensor(synthetic_faces(2, 128, seed=12))
    draws = cpu.draw(2, torch.Generator().manual_seed(13))

    def run(tr, lo, re, dr):
        tr.state.opt.zero_grad(set_to_none=True)
        loss, m = tr.losses(lo, re, dr)
        return loss, {k: v.detach() for k, v in m.items()}

    cuda_draws = {"init_noise": draws["init_noise"].cuda(),
                  "noise": [n.cuda() for n in draws["noise"]]}
    ops.reset_launch_counts()
    loss_g, m_g = run(card, low.cuda(), real.cuda(), cuda_draws)
    torch.cuda.synchronize()
    fwd = ops.launch_counts()
    loss_g.backward()
    torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in ops.launch_counts().items()}
    say(f"train step card: launches in the forward {fwd}, in backward() "
        f"{bwd}")
    for k in ("dense_conv", "s2d"):
        if bwd[k] == 0:
            raise AssertionError(f"train: {k} never launched in backward()")
    grads_g = [p.grad for p in card.diffuser.parameters()]

    outs = []
    for f in (1.0, 1 + 1e-6, 1 - 1e-6):
        loss_c, m_c = run(cpu, low * f, real, draws)
        loss_c.backward()
        outs.append((m_c, [p.grad.clone() for p in cpu.diffuser.parameters()]))
    (m_c, grads_c), *pert = outs
    for k in ("l1", "kl", "percept", "id"):
        err = _rel(m_g[k], m_c[k])
        spread = max(_rel(p[0][k], m_c[k]) for p in pert)
        say(f"train step {k}: card {float(m_g[k]):.6f} CPU "
            f"{float(m_c[k]):.6f} rel err {err:.3e} (CPU spread "
            f"{spread:.3e})")
        res[f"step_{k}"] = dict(card=float(m_g[k]), cpu=float(m_c[k]),
                                rel_err=err, cpu_spread=spread)
        if not (torch.isfinite(m_g[k]) and err <= 10 * spread + 1e-5):
            raise AssertionError(f"train step {k}: card vs CPU {err:.3e}, "
                                 f"CPU spread {spread:.3e}")
    err = max(_rel(a, b) for a, b in zip(grads_g, grads_c))
    spread = max(_rel(a, b) for p in pert for a, b in zip(p[1], grads_c))
    say(f"train step diffuser grads: worst-tensor rel err {err:.3e} (CPU "
        f"spread {spread:.3e})")
    res["step_grads"] = dict(rel_err=err, cpu_spread=spread,
                             launches_forward=fwd, launches_backward=bwd)
    if err > 10 * spread + 1e-5:
        raise AssertionError(f"train step grads: card vs CPU {err:.3e}, CPU "
                             f"spread {spread:.3e}")
    del cpu, card


def _train_cli(res, faces_dir, mode, batch, iters):
    """The stage-2 CLI at full width, b16 in one pass (f32 peaks at 34 GiB
    of the card's 80, so no gradient accumulation is needed)."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli import train_diffuser

    with tempfile.TemporaryDirectory() as out:
        argv = ["--path", faces_dir, "--out", out, "--size", "256",
                "--decoder_size", "1024", "--batch", str(batch),
                "--iter", str(iters),
                "--device", "cuda", "--seed", "0", "--save_inter", "100000",
                "--show_inter", "100000", "--train_dtype", mode]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = train_diffuser.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = rep["steps"]
    if len(steps) != iters:
        raise AssertionError(f"train cli {mode}: {len(steps)} steps")
    for st in steps:
        if not all(np.isfinite(st[k]) for k in ("loss", "l1", "kl",
                                                  "percept", "id")):
            raise AssertionError(f"train cli {mode}: non-finite loss {st}")
    secs = [st["seconds"] for st in steps]
    med = statistics.median(secs[1:])
    ips = batch / med
    say(f"train cli {mode} b{batch}: step seconds "
        f"{[round(x, 4) for x in secs]}, median (first excluded) "
        f"{med * 1e3:.1f} ms = {ips:.3f} imgs/s, peak {peak:.3f} GiB, wall "
        f"{wall:.1f} s incl. init; launches {counts}; last losses "
        + ", ".join(f"{k} {steps[-1][k]:.4f}" for k in ("l1", "kl",
                                                         "percept", "id")))
    missing = [k for k in PATH_KERNELS["train"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"train cli {mode}: kernels never launched: "
                             f"{missing}")
    res[mode] = dict(batch=batch, step_seconds=secs,
                     median_step_ms=med * 1e3, imgs_per_s=ips, peak_gib=peak,
                     launches=counts, wall_s=wall,
                     last_losses={k: steps[-1][k] for k in
                                  ("loss", "l1", "kl", "percept", "id")})


def _fixed_batch_l1(res, gt_u8):
    """Ten bf16 steps at full width on one fixed degraded batch: the L1
    term must fall."""
    import torch

    from vspbfr_tpu_torch.data.degradations import DegradationConfig
    from vspbfr_tpu_torch.data.device_degrade import (DeviceDegrader,
                                                      sample_params)
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    tr = DiffuserTrainer(DiffuserTrainConfig(compute_dtype="bfloat16"),
                         RestorationPipeline(size=256)).init_from_seed(3)
    tr.to("cuda")
    b = gt_u8.shape[0]
    p = sample_params(np.random.default_rng(4), b, 256, DegradationConfig())
    low, real = DeviceDegrader(256).degrade_all(
        torch.tensor(gt_u8, device="cuda"), p, np.arange(b), True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    l1 = [float(tr.train_step(low, real, generator=gen)["l1"])
          for _ in range(10)]
    say(f"fixed batch (b{b}, bf16, full width), L1 over ten steps: "
        f"{[round(x, 5) for x in l1]}")
    res["fixed_batch_l1"] = l1
    if not (np.all(np.isfinite(l1)) and l1[-1] < l1[0]):
        raise AssertionError(f"fixed batch: L1 did not fall: {l1}")
    del tr


def phase_train():
    import torch

    res = {}
    _train_step_card_vs_cpu(res)
    torch.cuda.empty_cache()
    faces = synthetic_faces(16, 256, seed=7)
    gt_u8 = np.round((faces + 1.0) * 127.5).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        for i, f in enumerate(gt_u8):
            np.save(os.path.join(d, f"face{i}.npy"), f)
        for mode in ("f32", "bf16"):
            _train_cli(res, d, mode, 16, iters=4)
            torch.cuda.empty_cache()
    _fixed_batch_l1(res, gt_u8)
    torch.cuda.empty_cache()
    REPORT["train"] = res


# --- phase 8 ----------------------------------------------------------------

def _to(tree, device):
    """The draws' nested dicts and lists of tensors, moved to device."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree


def _restore_step(tr, low, real, clean, feats, draws) -> dict:
    """One stage-3 step on given embedding and draws: the D phase (with R1
    at G step 0), then the G phase. Returns the metrics and the gradients
    Adam kept (beta1 = 0, so exp_avg is the last update's gradient: D's is
    R1's, G's the G loss's; D's exp_avg_sq mixes both D updates)."""
    m = {**tr.d_phase(low, real, clean, feats, draws["gen_d"]),
         **tr.g_phase(low, real, clean, feats, draws["gen_g"])}

    def moments(state, key):
        return [state.opt.state[p][key].detach().clone()
                for p in state.module.parameters()]

    return {"metrics": {k: v.detach() for k, v in m.items()},
            "grads": {"d_r1": moments(tr.d_state, "exp_avg"),
                      "d_sq": moments(tr.d_state, "exp_avg_sq"),
                      "g": moments(tr.g_state, "exp_avg")}}


def _restore_launches(tr, low, real, clean, feats, draws) -> dict:
    """Where the kernels launch in a stage-3 step on the card: the step's
    pieces, as the trainer's d_phase and g_phase run them, with the counts
    read after each: the D forward and its backward(), R1's forward (D's
    forward and the input gradient, create_graph) and its double backward,
    the G forward and its backward() (K2's Function: every SMART branch
    weight must get its gradient through it)."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.losses import d_logistic_loss, r1_penalty

    out = {}

    def mark(name):
        torch.cuda.synchronize()
        out[name] = ops.launch_counts()
        ops.reset_launch_counts()

    ops.reset_launch_counts()
    with torch.no_grad():
        fake = tr.generate(low, feats, clean, draws["gen_d"])
    mark("generate (no grad)")
    loss = d_logistic_loss(tr.disc_logits(real), tr.disc_logits(fake))
    mark("D forward")
    loss.backward()
    mark("D backward()")
    pen = r1_penalty(tr.disc_logits, real)
    mark("R1 forward + input gradient")
    pen.backward()
    mark("R1 double backward")
    loss, _ = tr.g_loss(low, real, clean, feats, draws["gen_g"])
    mark("G forward")
    loss.backward()
    mark("G backward()")
    branch = [p for n, p in tr.gen.named_parameters() if ".dilated." in n]
    if not branch or any(p.grad is None or not torch.isfinite(p.grad).all()
                         for p in branch):
        raise AssertionError("restore: a SMART branch weight got no finite "
                             "gradient through K2's Function")
    for m in (tr.gen, tr.disc):
        m.zero_grad(set_to_none=True)
    need = (("D forward", "conv_epilogue"), ("D backward()", "dense_conv"),
            ("R1 double backward", "dense_conv"),
            ("G forward", "dilated_multi_conv"),
            ("G forward", "conv_epilogue"), ("G forward", "fused_leaky_relu"),
            ("G backward()", "dense_conv"))
    for part, k in need:
        if out[part][k] == 0:
            raise AssertionError(f"restore: {k} never launched in {part}")
    out["smart_branch_weights_with_grad"] = len(branch)
    return out


def _ada_card_vs_cpu(res):
    """ADA's augment at 512 px b4 on the card against the CPU, on the same
    images and the same G and C matrices (built on the CPU at p = 1 from
    seeded draws): the forward within 1e-5 of max |CPU|; the input gradient
    of sum(D(augment(x))) and R1's parameter gradient (a double backward
    through the augment) for a three-conv D within 1e-3 of max, all
    finite; CUDA-event medians of the forward and of the forward with the
    input gradient."""
    import torch

    from vspbfr_tpu_torch.losses import ada

    b, size = 4, 512
    x_cpu = torch.tensor(synthetic_faces(b, size, seed=51))
    draws = ada.draw_augment(b, torch.Generator().manual_seed(52), "cpu")
    one = torch.tensor(1.0)
    g = ada.affine_from_draws(draws["affine"], one, size, size)
    c = ada.color_from_draws(draws["color"], one)
    rng = np.random.default_rng(53)
    ws = [torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.2)
          for s in ((3, 3, 3, 8), (3, 3, 8, 8), (3, 3, 8, 1))]

    def d_net(y, params):
        for i, w in enumerate(params):
            y = torch.nn.functional.conv2d(
                y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                stride=1 + (i > 0), padding=1).permute(0, 2, 3, 1)
            if i < len(params) - 1:
                y = torch.nn.functional.leaky_relu(y, 0.2)
        return y.mean(dim=(1, 2, 3))

    def run(dev):
        x = x_cpu.to(dev).requires_grad_(True)
        params = [w.to(dev).requires_grad_(True) for w in ws]
        gd, cd = g.to(dev), c.to(dev)
        out = ada.apply_color(ada.apply_affine(x, gd), cd)
        (gx,) = torch.autograd.grad(d_net(out, params).sum(), x,
                                    create_graph=True)
        gx.square().sum(dim=(1, 2, 3)).mean().backward()
        return {"forward": out.detach(), "input_grad": gx.detach(),
                **{f"r1_grad_{i}": p.grad for i, p in enumerate(params)}}

    card, cpu = run("cuda"), run("cpu")
    out = {}
    for k, ref in cpu.items():
        got = card[k].float().cpu()
        err = float((got - ref).abs().max() / ref.abs().max())
        tol = 1e-5 if k == "forward" else 1e-3
        out[k] = dict(rel_err=err, tol=tol)
        say(f"ada {k}: card vs CPU rel err {err:.3e} (bound {tol:g})")
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"ada {k}: card vs CPU {err:.3e}")

    xg = x_cpu.cuda()
    gd, cd = g.cuda(), c.cuda()
    wgt = torch.randn(xg.shape, device="cuda")

    def fwd():
        return ada.apply_color(ada.apply_affine(xg, gd), cd)

    def fwd_bwd():
        xr = xg.detach().requires_grad_(True)
        (ada.apply_color(ada.apply_affine(xr, gd), cd) * wgt).sum().backward()

    t_f = cuda_ms(fwd, iters=10, warmup=2)
    t_fb = cuda_ms(fwd_bwd, iters=10, warmup=2)
    say(f"ada augment 512 px b4 f32: forward {t_f:.3f} ms, forward + input "
        f"gradient {t_fb:.3f} ms (CUDA-event medians of 10)")
    res["ada_augment"] = dict(errors=out, forward_ms=t_f,
                              forward_backward_ms=t_fb)


def _restore_step_card_vs_cpu(res, augment_p: float = 0.0):
    """One stage-3 step at the phase-4 config (size 128, decoder 256,
    channel_div 4, b2; LPIPS and ID at full width), card vs CPU, same
    weights, batch, embedding (computed once on the CPU and handed to both:
    the random-init DDPM chain is not what this compares) and draws (with
    `augment_p` > 0 the ADA draws too, ADA at that fixed p). Held as the
    stage-2 step is: error <= 10 x the CPU's own spread under +-1e-6 input
    changes + 1e-5, per metric and over each gradient set (worst
    tensor)."""
    import copy

    import torch

    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    pcfg = dict(size=128, decoder_size=256, encode_size=64,
                encoder_stages=TINY_STAGES, channel_div=4)
    tcfg = RestoreTrainConfig(size=128, batch=2, augment=augment_p > 0,
                              augment_p=augment_p)
    tag = "ada_" if augment_p > 0 else ""
    cpu = RestoreTrainer(tcfg, RestorationPipeline(**pcfg)).init_from_seed(1)
    card = RestoreTrainer(tcfg, RestorationPipeline(**pcfg))
    for name, m in cpu.modules.items():
        card.modules[name].load_state_dict(m.state_dict())
    card.to("cuda")
    low = torch.tensor(synthetic_faces(2, 128, seed=21))
    real = torch.tensor(synthetic_faces(2, 128, seed=22))
    draws = cpu.draw(2, torch.Generator().manual_seed(23))
    clean, feats = cpu.embedding(low, draws["embed"])
    cuda_args = _to([low, real, clean, feats, draws], "cuda")

    t0 = time.perf_counter()
    got = _restore_step(card, *cuda_args)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    outs = []
    for f in (1.0, 1 + 1e-6, 1 - 1e-6):
        outs.append(_restore_step(copy.deepcopy(cpu), low * f, real, clean,
                                  feats, draws))
    ref, *pert = outs
    name = f"restore step{' with ADA at p ' + str(augment_p) if tag else ''}"
    say(f"{name} (size 128, b2): card {t_card:.3f} s (first call)")
    if tag:
        # each of the 13 transforms must apply to some sample of some
        # augment call (the two rotations gate at p_rot = 1 - sqrt(1 - p))
        p_rot = 1 - (1 - augment_p) ** 0.5
        cut = {"affine": torch.tensor([augment_p] * 4 + [p_rot, augment_p,
                                                         p_rot, augment_p]),
               "color": torch.full((5,), augment_p)}
        calls = [dd for aug in (draws["gen_d"]["ada"], draws["gen_g"]["ada"])
                 for dd in aug.values()]
        fired = {part: [int(n) for n in sum(
            (c[part]["gates"] < cut[part][:, None]).sum(dim=1)
            for c in calls)] for part in cut}
        say(f"{name}: samples each transform applied to, over the step's "
            f"{len(calls)} augment calls: {fired}")
        res["ada_transforms_fired"] = fired
        if min(min(v) for v in fired.values()) == 0:
            raise AssertionError(f"{name}: a transform never applied")
    for k, v in ref["metrics"].items():
        err = _rel(got["metrics"][k], v)
        spread = max(_rel(p["metrics"][k], v) for p in pert)
        say(f"{name} {k}: card {float(got['metrics'][k]):.6f} CPU "
            f"{float(v):.6f} rel err {err:.3e} (CPU spread {spread:.3e})")
        res[f"{tag}step_{k}"] = dict(card=float(got["metrics"][k]),
                                     cpu=float(v), rel_err=err,
                                     cpu_spread=spread)
        if not (torch.isfinite(got["metrics"][k]) and
                err <= 10 * spread + 1e-5):
            raise AssertionError(f"{name} {k}: card vs CPU {err:.3e}, "
                                 f"CPU spread {spread:.3e}")
    for k, ts in ref["grads"].items():
        err = max(_rel(a, b) for a, b in zip(got["grads"][k], ts))
        spread = max(_rel(a, b) for p in pert
                     for a, b in zip(p["grads"][k], ts))
        say(f"{name} grads {k}: worst-tensor rel err {err:.3e} (CPU "
            f"spread {spread:.3e})")
        res[f"{tag}step_grads_{k}"] = dict(rel_err=err, cpu_spread=spread)
        if err > 10 * spread + 1e-5:
            raise AssertionError(f"{name} grads {k}: card vs CPU "
                                 f"{err:.3e}, CPU spread {spread:.3e}")
    if not tag:
        res["launches_by_part"] = _restore_launches(card, *cuda_args)
        say(f"restore step launches by part: {res['launches_by_part']}")
    del cpu, card


def _restore_cli(res, faces_dir, mode, fused, iters=4, ada=()):
    """The stage-3 CLI at full width, the reference's per-GPU batch 4;
    `ada`: extra ADA flags (`--augment`, `--augment_p`)."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli import train_restore

    key = f"{mode}_fused" if fused == "1" else mode
    if ada:
        key = f"{mode}_{'augment_p' if '--augment_p' in ada else 'augment'}"
    with tempfile.TemporaryDirectory() as out, fused_epi(fused):
        argv = ["--path", faces_dir, "--out", out, "--size", "512",
                "--decoder_size", "1024", "--batch", "4",
                "--iter", str(iters), "--device", "cuda", "--seed", "0",
                "--save_inter", "100000", "--show_inter", "100000",
                "--train_dtype", mode, *ada]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = train_restore.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = rep["steps"]
    names = ("d", "r1", "real_score", "fake_score", "g", "gan", "percept",
             "id") + (("ada_rt", "ada_p") if ada else ())
    if len(steps) != iters:
        raise AssertionError(f"restore cli {key}: {len(steps)} steps")
    for st in steps:
        if not all(np.isfinite(st[k]) for k in names):
            raise AssertionError(f"restore cli {key}: non-finite loss {st}")
    if not steps[0]["r1"] > 0:
        raise AssertionError(f"restore cli {key}: no R1 at step 0")
    secs = [st["seconds"] for st in steps]
    med = statistics.median(secs[1:])
    say(f"restore cli {key} b4: step seconds {[round(x, 4) for x in secs]}, "
        f"median (first excluded) {med * 1e3:.1f} ms = {4 / med:.3f} imgs/s, "
        f"peak {peak:.3f} GiB, wall {wall:.1f} s incl. init; launches "
        f"{counts}; first losses " + ", ".join(
            f"{k} {steps[0][k]:.4f}" for k in names))
    if "--augment_p" in ada and not all(st["ada_p"] == 0.5 for st in steps):
        raise AssertionError(f"restore cli {key}: ada_p not the fixed 0.5")
    path = ("restore_fused" if fused == "1" else
            "restore_ada" if ada else "restore")
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"restore cli {key}: kernels never launched: "
                             f"{missing}")
    res[key] = dict(batch=4, step_seconds=secs, median_step_ms=med * 1e3,
                    imgs_per_s=4 / med, peak_gib=peak, launches=counts,
                    wall_s=wall, losses=steps)


def _restore_ada_ab(res):
    """The stage-3 bf16 step at full width, b4, without ADA and with ADA at
    the fixed p 0.5, on two trainers from one seed and one batch: CUDA-event
    medians of 3 steps each, in turns off, on, on, off, after one warm-up
    step each; the steps without R1 (the G step count set to 1) and, the
    same way, with R1 (set to 0)."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    trs = {}
    for key, kw in (("off", {}), ("on", dict(augment=True, augment_p=0.5))):
        trs[key] = RestoreTrainer(
            RestoreTrainConfig(compute_dtype="bfloat16", **kw),
            RestorationPipeline()).init_from_seed(4).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    low, real = (torch.tensor(synthetic_faces(4, 512, seed=s),
                              device="cuda") for s in (31, 32))
    out = {}
    for r1, g_step in (("no_r1", 1), ("r1", 0)):
        ab = {"off": [], "on": []}
        for key in ("off", "on", "on", "off"):
            tr = trs[key]

            def step():
                tr.g_state.step = g_step
                return tr.train_step(low, real, gen)

            ab[key].append(cuda_ms(step, iters=3, warmup=1))
        out[r1] = ab
        say(f"restore step bf16 b4 ({r1.replace('_', ' ')}), ADA off / on "
            f"at p 0.5 (ms, medians of 3 in turns off, on, on, off): "
            f"{ab['off']} / {ab['on']}")
    res["bf16_ada_ab_ms"] = out
    del trs


def _restore_fused_ab(res):
    """The stage-3 bf16 step at full width, b4, with the epilogue switch
    off and on, on one trainer and one batch: CUDA-event medians of 3
    steps each, in turns off, on, on, off, after one warm-up step each.
    The steps are the 15 in 16 without R1 (the G step count is set to 1
    before each)."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    tr = RestoreTrainer(RestoreTrainConfig(compute_dtype="bfloat16"),
                        RestorationPipeline()).init_from_seed(4).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    low, real = (torch.tensor(synthetic_faces(4, 512, seed=s),
                              device="cuda") for s in (31, 32))
    def step():
        tr.g_state.step = 1     # R1 stays off
        return tr.train_step(low, real, gen)

    ab = {"0": [], "1": []}
    for flag in ("0", "1", "1", "0"):
        with fused_epi(flag):
            ab[flag].append(cuda_ms(step, iters=3, warmup=1))
    say(f"restore step bf16 b4 (no R1), VSPBFR_FUSED_EPI off / on (ms, "
        f"medians of 3 in turns off, on, on, off): {ab['0']} / {ab['1']}")
    res["bf16_fused_ab_ms"] = {"off": ab["0"], "on": ab["1"]}
    del tr


def phase_restore():
    import torch

    res = {}
    _ada_card_vs_cpu(res)
    _restore_step_card_vs_cpu(res)
    torch.cuda.empty_cache()
    _restore_step_card_vs_cpu(res, augment_p=0.5)
    torch.cuda.empty_cache()
    faces = synthetic_faces(8, 512, seed=8)
    gt_u8 = np.round((faces + 1.0) * 127.5).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        for i, f in enumerate(gt_u8):
            np.save(os.path.join(d, f"face{i}.npy"), f)
        for mode, fused, ada in (
                ("f32", "0", ()), ("f32", "0", ("--augment",)),
                ("bf16", "0", ()),
                ("bf16", "0", ("--augment", "--augment_p", "0.5")),
                ("bf16", "1", ())):
            _restore_cli(res, d, mode, fused, ada=ada)
            torch.cuda.empty_cache()
    say("restore cli median step ms, without / with ADA (same call): f32 "
        f"{res['f32']['median_step_ms']:.1f} / "
        f"{res['f32_augment']['median_step_ms']:.1f} (--augment), bf16 "
        f"{res['bf16']['median_step_ms']:.1f} / "
        f"{res['bf16_augment_p']['median_step_ms']:.1f} (--augment_p 0.5)")
    _restore_fused_ab(res)
    torch.cuda.empty_cache()
    _restore_ada_ab(res)
    torch.cuda.empty_cache()
    REPORT["restore"] = res


# --- phase 9 ----------------------------------------------------------------

def phase_smart():
    """K5's entry point in process, f32 and bf16: K5 against the K2 + K1
    composition at every RestoreNet SMART shape, b4."""
    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli import profile

    res = {}
    for mode in ("f32", "bf16"):
        ops.reset_launch_counts()
        rows = profile.main(["--smart"] + (["--bf16"] if mode == "bf16"
                                           else []))["rows"]
        counts = ops.launch_counts()
        for r in rows:
            if r["k5_launches"] == 0 or r["max_rel_diff"] > TOL[mode]:
                raise AssertionError(f"smart {mode} {r['size']}px: K5 "
                                     f"launches {r['k5_launches']}, rel "
                                     f"diff {r['max_rel_diff']:.3e}")
        res[mode] = dict(rows=rows, launches=counts)
    REPORT["smart"] = res


# --- phase 10 ---------------------------------------------------------------

def phase_experiments():
    """The entries of K8-K10 in process, f32 and bf16, with the launch
    counts set to 0 before the first and read after the last: each row
    must launch its kernel and agree with its plain version."""
    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli import profile

    res = {}
    ops.reset_launch_counts()
    for entry in ("interleave", "stripe_conv", "inkpad"):
        for mode in ("f32", "bf16"):
            rows = profile.main([f"--{entry}"] + (["--bf16"] if mode == "bf16"
                                                  else []))["rows"]
            for r in rows:
                if (r["launches"] == 0 or r["max_rel_diff"] > TOL[mode]
                        or not r.get("exact", True)):
                    raise AssertionError(f"{entry} {mode}: {r}")
            res[f"{entry}_{mode}"] = rows
    res["launches"] = ops.launch_counts()
    say(f"experiments: launches {res['launches']}")
    REPORT["experiments"] = res


# --- main -------------------------------------------------------------------

def main() -> None:
    import torch

    for name in PHASES:
        t0 = time.perf_counter()
        # the path phases: no plain K6 / K7 on the card
        with (no_plain_on_card(name) if name in ("slice", "cli", "train",
                                                 "restore")
              else contextlib.nullcontext()):
            globals()[f"phase_{name}"]()
        say(f"phase {name} done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    launches = {"serve": REPORT["cli"]["f32"]["launches"],
                "train": REPORT["train"]["f32"]["launches"],
                "restore": REPORT["restore"]["f32"]["launches"],
                "restore_ada": REPORT["restore"]["f32_augment"]["launches"],
                "restore_fused": REPORT["restore"]["bf16_fused"]["launches"],
                "smart": REPORT["smart"]["f32"]["launches"],
                "experiments": REPORT["experiments"]["launches"]}
    for name, (src, replaces) in KERNEL_INFO.items():
        rows = [r for r in REPORT["kernels"] + REPORT["grads"]
                if r["kernel"] == name and r["dtype"] == "f32"]
        big = max(rows, key=lambda r: r["plain_ms"])
        path = next(p for p, ks in PATH_KERNELS.items() if name in ks)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[path][name],
                        "max_abs_err": big["max_abs_err"],
                        "ms": big["ms"], "plain_ms": big["plain_ms"],
                        "bound_ms": big["bound_ms"],
                        "bound_by": big["bound_by"],
                        "library_ms": big["library_ms"],
                        "case": big["case"], "path": path,
                        "launches_by_path": {p: c[name]
                                             for p, c in launches.items()},
                        **{k: big[k] for k in ("composition_ms",
                                               "device_ms") if k in big}})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    print(CARD, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
