#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # takes no arguments; needs one CUDA card

(`chip_smoke.py --rank ...` is one process of phase 13 or 16, which
those phases start themselves.)

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
             1024 px decoder, IR-SE-50 at 256, b4, 3 steps, R1 at step 0)
             in f32 and bf16 with the epilogue switch off, the same with
             ADA (f32 `--augment`, bf16 `--augment --augment_p 0.5`; the
             six kernels of `PATH_KERNELS["restore_ada"]` must launch) and
             in bf16 with the switch on: step ms, imgs/s, peak memory,
             launch counts; the bf16 step with the switch off and on in
             turns on one trainer, and without and with ADA (p 0.5) in
             turns on two trainers, each with and without R1 (one step a
             turn after a warm-up step; the CLI runs were cut from 4 steps
             and the turns from 3 steps, then 2, for the script's time).
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

11. convert - checkpoint conversion without JAX: phase 5's seeded
             full-width pipeline (its decoder's 1-D `latent_avg`), a seeded
             D at 512 px and ArcFace ResNet-101, and phase 5's LPIPS and
             InceptionV3, written in the reference's layouts
             (`reference_state_dict`, with entries the converters must
             ignore), then `python -m vspbfr_tpu_torch.cli.convert_ckpt`
             for each of its six kinds in its own process, where `jax` and
             `vspbfr_tpu` cannot be imported; every output equals its
             source bit for bit; each kind's seconds and file size. Then
             the converted pipeline (g_ema as the generator) restores
             phase 5's 4 faces on the card in f32 and bf16 identically
             (max |diff| 0, under cuDNN's deterministic algorithms: with
             its defaults the f32 path varies call to call) to the seeded
             one on the same draws, timed in turns with it under the
             defaults, the serve kernels launching; the converted LPIPS
             and InceptionV3 score as the seeded ones.
12. sample  - truncated sampling at full width on the card against the
             CPU (phase 4's gate): `mean_latent` over 4096 z,
             `noise_mapping` of two style draws for b4 with an inject
             index, `truncate_styles` at 0.7, the 1024 px decode (K1, K3,
             K6 and K7 must launch); the pSp `GradualStyleEncoder` at 256
             px b4; CUDA-event medians of the f32 and bf16 sampling and of
             the encoder.
13. parallel - data-parallel training (`vspbfr_tpu_torch/parallel/`), each
             run a process of its own with a timeout: (a) the stage-3 CLI
             at full width, b4, bf16, 3 steps (R1 at step 0) alone and
             under torchrun at world size 1 (NCCL), in turns alone,
             torchrun, alone: per-step losses within 10x the lone runs'
             spread (equal where it is 0), the restore kernels launching,
             both step-time medians, the gradient all-reduce's CUDA-event
             ms and bytes a step; (b) two gloo ranks on the one card:
             stage 2 at phase 7's config, b8 each, against this process at
             b16 on the same rows and draws (losses and updated diffuser
             within phase 7's f32 gate, the ranks bit-identical), and the
             stage-3 CLI at b2 each, bf16, 2 steps with ADA (G, D, g_ema
             and the ADA state bit-identical across the ranks after each
             step). NCCL across cards needs a machine with more than one.
14. hostdata - the host degradation chain (`data/host_jpeg.py`,
             `data/degradations.py`, the C++ engine of `data/native.py`):
             (a) the stage-3 CLI at full width, bf16, b4, 3 steps (R1 at
             step 0) with `--loader host --n_degraded 2`, and the stage-2
             CLI at 256 px, bf16, b16, 3 steps with `--loader device
             --jpeg host`, each in its own process where cv2, PIL, JAX and
             the JAX package cannot be imported: the path's kernels
             launch, every loss is finite; step medians and the seconds
             each step waited on the loader; (b) images a second at 512 px
             b4 over 8 batches of the numpy host chain, the C++ engine
             (the host loader's threads, and alone on `os.cpu_count()`
             threads), `--jpeg host` and the device chain; (c) on one
             full-width stage_a batch from the card: the device JPEG's
             mean and 99th-percentile |diff| against `host_jpeg.py`, the
             C++ JPEG equal to `host_jpeg.py`, and stage_a / stage_b at
             sigma 0 against the numpy chain on the same parameters.
15. packed - the space-to-depth layout at packed_min_res 512 (the JAX
             CLIs' default): (a) K1 at the assembled packed shapes, K1e
             and K6 with nc = 4 noise (one value a phase) and the grouped
             K2 (groups 4) against their plain versions in f32 and bf16,
             with the library's call (cuDNN; for K2 cuDNN's grouped
             dilated convs + cat) and the bound, then their gradients
             against plain autograd and K6's double backward with nc = 4;
             (b) phase 5's seeded modules (noise gains 0.1) on 4 faces at
             512 against 0 with explicit equal noise: f32 under the
             serving gate; bf16 as close to the f32 output as bf16 at 0 is
             (within 1.5x); launches (the new forms' counters too, and
             with `VSPBFR_FUSED_EPI=1`), peak memory, `restore` in turns
             0, 512, 512, 0 with the `upto=` split; (c) phase 4's config
             at packed_min_res 64 card vs CPU under the serving gate; (d)
             the stage-3 CLI (512 px, bf16, b4, 3 steps, R1 at step 0) and
             the stage-2 CLI (256 px, bf16, b16, 3 steps) at 512 in their
             own processes (`NO_CV_TRAIN`): finite losses, the paths'
             kernels and forms launching, step medians beside phases 8's
             and 7's, the backward calls of the kernels' Functions.
16. mesh2d - the 2-D data x model mesh (`parallel/`): two gloo ranks on
             the one card (a 1 data x 2 model mesh, `--rank mesh2d`
             under torchrun) against this process's lone runs, phase 5's
             full-width pipeline (seeded, noise gains 0.1): (a) the decode
             stage (1024 px decoder, b2) H-sharded with halo exchanges,
             f32 and bf16, image and feature taps; (b) RestoreNet's stage
             on them; (c) `restore` end to end (encode and DDPM
             replicated), f32 under the serving gate, bf16 held to the
             f32 output as closely as the lone bf16 run is (phase 15's
             rule), peak memory per rank beside the lone run's; (d) the decoder with its weights
             model-sharded (gathered at use): image within 5e-4, the
             gradients of mean(image^2) within 1e-5 of each one's max
             (f32, cuDNN deterministic); (e) one stage-2 step at phase 7's
             config (b8, f32) placed by `shard_model` (weights
             model-sharded, the decode H-sharded) against the lone step:
             losses in phase 7's gate, Adam's gradients within 1e-5 + 10x
             the lone step's own spread of the lone step that took the
             ranks' decoded image (`_whole_images`), the updated diffuser
             within 2.05 x lr_eff (flips a minority), Adam's bytes per rank
             beside the lone run's; launch counts of each sub-phase, no
             plain K6 / K7 on
             either rank; (f) `conv2d_semipacked` at (4, 512, 256, 128),
             3x3: K1 at the assembled kernel against its plain version,
             timed beside the unpacked K1 and cuDNN at 512 px C64 and the
             2x2-packed K1; (g) the packed layout on the same ranks:
             (a)-(c) at packed_min_res 512 (the 1024 px decode's 512 and
             1024 levels and RestoreNet's 512 level packed and H-sharded)
             against this process's lone packed run, f32 under the
             serving gate, bf16 by (a)-(c)'s rule; the f32 run again with
             each planted fault in the packed windows (`_packed_trap`: the
             exchange's rows zeros; the top and bottom strips swapped),
             which must fail the f32 gate; launches per rank (K1, K2, K2
             grouped, K3, K4, K6, K6 nc = 4, K7 each at least once) beside
             the lone run's; peak GiB per rank, halo exchanges per batch
             and the ranks' seconds beside the lone run's.
17. meshtrain - training on the 2-D mesh: two gloo ranks on the card (1
             data x 2 model, `--rank meshtrain`; one such mesh a dtype, the
             two at once) against this process's
             lone steps, full width, seeded, each trainer placed by its
             `shard_model(mesh)` (weights model-sharded, maps H-sharded
             forward and backward): (a) one stage-2 step at phase 7's
             config (b8, LPIPS and ID on) and (b) one stage-3 step at 512
             px b4 with ADA at p 0.5 and R1, each in f32 and bf16 and
             held to the lone step: f32 losses within phases 7 / 8's
             gate, gradients within 1e-5 + 10x the lone step's own spread
             of the lone step that took the ranks' whole images (the
             whole-image nets grow the sharded decode's rounding), flips
             <= 5%, and the f32 ranks' step without each model-axis sum
             (the codes' sum in stage 2; the replicated parameters' sum
             and the reduce-scatter in stage 3) must fail that gate;
             bf16 as close to the lone f32 step as the lone bf16, loss by
             loss (`_mt_gates`); (c) peak GiB and Adam's bytes per rank,
             halo exchanges and model-axis sums of the first step,
             launches of K1, K1 dx, K2, K2 bwd, K3, K4, K6 and K7 per rank
             and the step's seconds (one step a run), each beside the lone
             run's; (d) training on the packed mesh: (a)-(c) again in the
             same rank processes, after the unpacked steps, at
             packed_min_res 512 (the 1024 px decoder's 512 and 1024
             levels and RestoreNet's 512 level packed and sharded by
             packed rows, their gradients back through the packed
             windows), held to this process's lone packed steps by the
             same gates; the f32 packed step on ranks with each planted
             fault in the packed windows' backward (`_strip_fault`: the
             strips' gradients dropped; swapped, the top strip's to the
             lower neighbour and the bottom one's to the upper; run by
             the bf16 mesh's ranks in f32 after their own steps, so the
             two meshes take about as long) must fail the f32 gradient
             gate with its losses unchanged; grouped K2, its
             backward Function, K6 at nc = 4, K3 and K4 launch on every
             rank as often as in the lone packed step.

Phases 5, 7, 8, 11, 12, 13, 14, 15 (b)-(d), 16 and 17 (on both ranks too)
also count the calls of K6's and K7's plain versions on CUDA tensors
(`ops.plain_cuda_calls`), which must stay 0: on the card the main paths
run the kernels.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Details also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
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
from vspbfr_tpu_torch.cli.profile import d2s_library, s2d_library

PHASES = ("device", "build", "kernels", "slice", "cli", "grads", "train",
          "restore", "smart", "experiments", "convert", "sample", "parallel",
          "hostdata", "packed", "mesh2d", "meshtrain")
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
    # the space-to-depth layout's forms (counted apart, `ops.form_counts`)
    "dilated_multi_conv_grouped": ("vspbfr_tpu_torch/csrc/dilated_conv.cu",
                                   "vspbfr_tpu/ops/pallas_dilated.py:180"),
    "conv_epilogue_nc4": ("vspbfr_tpu_torch/csrc/epilogue.cu",
                          "vspbfr_tpu/ops/pallas_epilogue.py:96"),
    "dense_conv_epilogue_nc4": ("vspbfr_tpu_torch/csrc/dense_conv.cu",
                                "vspbfr_tpu/ops/pallas_conv.py:524"),
    "interleave_stack": ("vspbfr_tpu_torch/csrc/interleave.cu",
                         "scripts/exp_interleave.py:73"),
    "interleave_repeat": ("vspbfr_tpu_torch/csrc/interleave.cu",
                          "scripts/exp_interleave.py:87"),
    "stripe_conv": ("vspbfr_tpu_torch/csrc/stripe_conv.cu",
                    "scripts/exp_pallas_conv.py:30"),
    "inkpad_conv": ("vspbfr_tpu_torch/csrc/stripe_conv.cu",
                    "scripts/exp_inkpad.py:96"),
}
# the kernels each main path must launch: serving (phases 5 and 11),
# stage-2 training (phase 7), stage-3 training (phase 8) without and with
# ADA and with the epilogue switch on, K5's entry (phase 9), the entries of
# K8-K10 (phase 10) and truncated sampling from the decoder (phase 12)
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
                                "stripe_conv", "inkpad_conv"),
                "sample": ("dense_conv", "d2s", "conv_epilogue",
                           "fused_leaky_relu"),
                "parallel": ("dense_conv", "dilated_multi_conv", "d2s",
                             "s2d", "conv_epilogue", "fused_leaky_relu"),
                # phase 15, packed_min_res 512: serving, serving with the
                # switch on, the stage-3 and stage-2 CLIs
                "packed": ("dense_conv", "dilated_multi_conv", "d2s", "s2d",
                           "conv_epilogue", "fused_leaky_relu",
                           "dilated_multi_conv_grouped", "conv_epilogue_nc4"),
                "packed_fused": ("dense_conv_epilogue",
                                 "dense_conv_epilogue_nc4", "dense_conv",
                                 "dilated_multi_conv_grouped", "d2s",
                                 "conv_epilogue", "fused_leaky_relu"),
                "packed_restore": ("dense_conv", "dilated_multi_conv", "d2s",
                                   "s2d", "conv_epilogue",
                                   "fused_leaky_relu",
                                   "dilated_multi_conv_grouped",
                                   "conv_epilogue_nc4"),
                "packed_train": ("dense_conv", "d2s", "s2d", "conv_epilogue",
                                 "fused_leaky_relu", "conv_epilogue_nc4"),
                # phase 16: restore H-sharded over two gloo ranks (f32)
                "mesh2d": ("dense_conv", "dilated_multi_conv", "d2s",
                           "conv_epilogue", "fused_leaky_relu"),
                # phase 17: the stage-3 step on two gloo ranks (f32)
                "meshtrain": ("dense_conv", "dilated_multi_conv", "d2s",
                              "s2d", "conv_epilogue", "fused_leaky_relu"),
                # phase 17 (d): the same at packed_min_res 512
                "meshtrain_packed": ("dense_conv", "dilated_multi_conv",
                                     "d2s", "s2d", "conv_epilogue",
                                     "fused_leaky_relu",
                                     "dilated_multi_conv_grouped",
                                     "conv_epilogue_nc4")}
TOL = {"f32": 1e-4, "bf16": 2e-2}
REPORT: dict = {}
# phase 5's seeded full-width modules and faces, which phases 11 and 12
# reuse
SEEDED: dict = {"nets": {}}
CARD = ""
T0 = time.perf_counter()    # the seconds each `say` line shows


def say(*parts) -> None:
    print(f"[{CARD} +{time.perf_counter() - T0:.0f}s]", *parts, flush=True)


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
    by_kernel = sass_counts(lib.path, tuple(SASS_REQUIRED))
    for kernel, required in SASS_REQUIRED.items():
        counts = by_kernel[kernel]
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


def sass_counts(so, kernels) -> dict[str, dict[str, dict[str, int]]]:
    """For each of `kernels`: lines of each of SASS_OPS (HMMA: mma.sync;
    HGMMA: wgmma; UTMALDG: a TMA load) in the SASS of each function of the
    library whose (mangled) name holds it, from one disassembly."""
    from vspbfr_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {k: {} for k in kernels}
    cur = None    # the function's counts, when it is one of the kernels'
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            kernel = next((k for k in kernels if k in fn), None)
            cur = None
            if kernel is not None:
                cur = counts[kernel][fn] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None:
            for op in SASS_OPS:
                if op in line and re.search(rf"\b{op}\b", line):
                    cur[op] += 1
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
            # the library's call: the permute copy (`.contiguous()`)
            lms = cuda_ms(lambda: d2s_library(x, inner))
            _check("d2s", label, dt_name, got, ref, ms, pms, rows,
                   moved=nbytes(x, got), library_ms=lms)
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
            SEEDED["nets"][name] = init_module(
                net, torch.Generator().manual_seed(seed))
            torch.save(net.state_dict(), nets[name])
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
    # phases 11 and 12 start from these seeded modules and inputs
    SEEDED.update(pipe=base, faces=faces[:4], clean=clean[:4])
    low = torch.tensor(faces[:4], device="cuda")

    def run(p, upto="full", sample=False):
        return p.restore(low, torch.Generator(device="cuda").manual_seed(0),
                         upto=upto, return_sample=sample)

    for mode, p in (("f32", p32), ("bf16", p16)):
        ms = {u: cuda_ms(lambda: run(p, u), iters=3, warmup=1)
              for u in ("encode", "ddpm", "decode", "full")}
        ms_sample = cuda_ms(lambda: run(p, "full", True), iters=10, warmup=1)
        split = {"encode": ms["encode"], "ddpm": ms["ddpm"] - ms["encode"],
                 "decode": ms["decode"] - ms["ddpm"],
                 "restore": ms["full"] - ms["decode"]}
        say(f"stage split {mode} b4 (ms, median of 3): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items())
            + f"; full {ms['full']:.3f}")
        # the CLI's call (restore with the sample image), median of 10
        ips = 4e3 / ms_sample
        say(f"restore with sample image {mode} b4: {ms_sample:.3f} ms "
            f"(median of 10 CUDA-event runs) = {ips:.3f} imgs/s")
        # the epilogue switch: K1 + the torch epilogue (off) against K1e
        # (on), in turns off, on, on, off, median of 3 each
        ab = {"0": [], "1": []}
        for flag in ("0", "1", "1", "0"):
            with fused_epi(flag):
                ab[flag].append(cuda_ms(lambda: run(p, "full", True),
                                        iters=3, warmup=1))
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
        say(f"restore {mode} b4, VSPBFR_FUSED_EPI off / on (ms, medians of 3 "
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
            lms = cuda_ms(lambda: s2d_library(y, inner))
            _check("s2d", label, dt_name, got, ref, ms, pms, rows,
                   moved=nbytes(y, got), library_ms=lms)
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


def _restore_cli(res, faces_dir, mode, fused, iters=3, ada=()):
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


def _restore_ada_ab(res, off):
    """The stage-3 bf16 step at full width, b4, without ADA and with ADA at
    the fixed p 0.5, on two trainers with one seed's weights (`off`, the
    trainer `_restore_fused_ab` made, and one with ADA loaded from it) and
    one batch: one step's CUDA-event ms each, in turns off, on, on, off,
    after one warm-up step each; the steps without R1 (the G step
    count set to 1) and, the same way, with R1 (set to 0)."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    on = RestoreTrainer(RestoreTrainConfig(compute_dtype="bfloat16",
                                           augment=True, augment_p=0.5),
                        RestorationPipeline())
    for name, m in off.modules.items():
        on.modules[name].load_state_dict(m.state_dict())
    trs = {"off": off, "on": on.to("cuda")}
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

            ab[key].append(cuda_ms(step, iters=1, warmup=1))
        out[r1] = ab
        say(f"restore step bf16 b4 ({r1.replace('_', ' ')}), ADA off / on "
            f"at p 0.5 (ms, one step a turn, off, on, on, off): "
            f"{ab['off']} / {ab['on']}")
    res["bf16_ada_ab_ms"] = out
    del trs, on


def _restore_fused_ab(res):
    """The stage-3 bf16 step at full width, b4, with the epilogue switch
    off and on, on one trainer and one batch: one step's CUDA-event ms
    each, in turns off, on, on, off, after one warm-up step each.
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
            ab[flag].append(cuda_ms(step, iters=1, warmup=1))
    say(f"restore step bf16 b4 (no R1), VSPBFR_FUSED_EPI off / on (ms, "
        f"one step a turn, off, on, on, off): {ab['0']} / {ab['1']}")
    res["bf16_fused_ab_ms"] = {"off": ab["0"], "on": ab["1"]}
    return tr


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
    # the ADA A/B's trainer without ADA is the fused A/B's (one seed's
    # weights; its steps only moved them)
    tr = _restore_fused_ab(res)
    torch.cuda.empty_cache()
    _restore_ada_ab(res, tr)
    del tr
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


# --- phase 11 ---------------------------------------------------------------

def _owners(module) -> dict:
    """Port state_dict key -> (the module that holds it, its name there)."""
    out = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = (m, pname)
    return out


def _flat_in_ref(w, c: int, h: int, wd: int):
    """Inverse of `torch_import._nchw_flat_in`: port (h*w*c, out) -> the
    reference's (out, c*h*w) over an NCHW flatten."""
    out = w.shape[1]
    return w.T.reshape(out, h, wd, c).permute(0, 3, 1, 2).reshape(out, -1)


def reference_state_dict(module) -> dict:
    """A port module's weights as the reference stores them: each entry
    under its reference key (the port's own key maps, `convert.
    torch_import`) in torch's layouts (linear (out, in), conv OIHW,
    modulated conv (1, O, I, k, k), NCHW buffers, the 4x4 heads over an
    NCHW flatten, a 1-D `latent_avg` when its rows are equal). The
    inverse of the converters, used to write reference-layout files."""
    import torch

    from vspbfr_tpu_torch.convert import torch_import as ti
    from vspbfr_tpu_torch.losses import (
        LPIPS,
        InceptionV3Features,
        ResNet101Embedder,
    )
    from vspbfr_tpu_torch.models import (
        CodeDiffuser,
        Discriminator,
        Generator,
        PSPFacade,
        RestorationNet,
    )
    from vspbfr_tpu_torch.models.e4e import _IRSEBackbone
    from vspbfr_tpu_torch.models.layers import ModulatedConv2d, ToRGB

    if isinstance(module, PSPFacade):
        out = {f"encoder.{k}": v for k, v in
               reference_state_dict(module.encoder).items()}
        out.update({f"decoder.{k}": v for k, v in
                    reference_state_dict(module.decoder).items()})
        lat = module.latent_avg.detach().cpu()
        out["latent_avg"] = lat[0].clone() if bool(
            (lat == lat[:1]).all()) else lat.clone()
        return out
    key_fn = {Generator: ti._generator_key,
              RestorationNet: ti._restorenet_key,
              CodeDiffuser: ti._code_diffuser_key,
              ResNet101Embedder: ti._resnet101_key,
              LPIPS: ti._lpips_key,
              InceptionV3Features: ti._inception_key}.get(type(module))
    if isinstance(module, _IRSEBackbone):
        key_fn = ti._e4e_key
    elif isinstance(module, Discriminator):
        key_fn = (lambda n, ls=module.log_size:
                  ti._discriminator_key(n, ls))
    owners = _owners(module)
    out = {}
    for k, v in module.state_dict().items():
        m, pname = owners[k]
        v = v.detach().cpu()
        if isinstance(m, ModulatedConv2d):
            v = v.permute(3, 2, 0, 1)[None]          # (k,k,I,O) -> (1,O,I,k,k)
        elif v.ndim == 4 and isinstance(m, Generator):
            v = v.permute(0, 3, 1, 2)                # const input, NCHW
        elif v.ndim == 4:
            v = v.permute(3, 2, 0, 1)                # HWIO -> OIHW
        elif isinstance(m, LPIPS) or (isinstance(m, ToRGB)
                                      and pname == "bias"):
            v = v.reshape(1, -1, 1, 1)               # lin heads, rgb bias
        elif v.ndim == 2:
            v = v.T                                  # (in, out) -> (out, in)
        out[key_fn(tuple(k.split(".")))] = v.contiguous()
    sd = module.state_dict()
    if isinstance(module, RestorationNet):
        ch4 = sd["final_transfer.bias"].shape[0] // 16
        out["final_linear.0.weight"] = _flat_in_ref(
            sd["final_linear.weight"], ch4, 4, 4).contiguous()
        w, b = sd["final_transfer.weight"], sd["final_transfer.bias"]
        out["final_transfer.weight"] = w.T.reshape(4, 4, ch4, -1).permute(
            2, 0, 1, 3).reshape(16 * ch4, -1).contiguous()
        out["final_transfer.bias"] = b.reshape(4, 4, ch4).permute(
            2, 0, 1).reshape(-1).contiguous()
    elif isinstance(module, Discriminator):
        out["final_linear.0.weight"] = _flat_in_ref(
            sd["final_linear0.weight"], sd["final_linear0.bias"].shape[0],
            4, 4).contiguous()
    return out


def write_reference_files(d: str, psp, diffuser, g_ema, g, disc, arcface,
                          lpips, inception) -> dict:
    """Write the reference's released files of the given port modules into
    `d`, with entries the converters must ignore (noise buffers, a blur
    kernel, optimizer states, Inception's fc / AuxLogits, VGG16's
    classifier); returns {kind: the `cli.convert_ckpt` arguments}."""
    import torch

    def path(name):
        return os.path.join(d, name)

    extra = torch.zeros(1, 1, 4, 4)
    ref = reference_state_dict(psp)
    ref.update({"decoder.noises.noise_0": extra,
                "decoder.convs.0.conv.blur.kernel": torch.ones(4, 4)})
    torch.save(ref, path("style_encoder_decoder.pt"))
    torch.save({"att_mapper": reference_state_dict(diffuser)},
               path("code_diffuser.pt"))
    optim = {"state": {0: {"exp_avg": extra}}, "param_groups": [{"lr": 2e-3}]}
    torch.save({"g": reference_state_dict(g),
                "g_ema": reference_state_dict(g_ema),
                "d": reference_state_dict(disc), "g_optim": optim,
                "d_optim": optim}, path("restoration_net.pt"))
    torch.save(reference_state_dict(arcface), path("Arcface.pth"))
    ref = reference_state_dict(lpips)
    torch.save({**{k: v for k, v in ref.items() if k.startswith("features")},
                "classifier.0.weight": extra}, path("vgg16.pth"))
    torch.save({k: v for k, v in ref.items() if k.startswith("lin")},
               path("vgg_lin.pth"))
    torch.save({**reference_state_dict(inception), "fc.weight": extra,
                "AuxLogits.conv0.conv.weight": extra},
               path("inception_v3.pth"))
    return {"psp": ["--torch", path("style_encoder_decoder.pt")],
            "diffuser": ["--torch", path("code_diffuser.pt")],
            "restore": ["--torch", path("restoration_net.pt")],
            "arcface": ["--torch", path("Arcface.pth")],
            "lpips": ["--torch", path("vgg16.pth"), "--lin",
                      path("vgg_lin.pth")],
            "inception": ["--torch", path("inception_v3.pth")]}


# runs `cli.convert_ckpt` with JAX and the JAX package made unimportable,
# and prints the seconds of its `main`
NO_JAX_CONVERT = (
    "import runpy, sys, time\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['vspbfr_tpu'] = None\n"
    "import torch\n"
    "sys.argv = ['convert_ckpt'] + sys.argv[1:]\n"
    "t0 = time.perf_counter()\n"
    "runpy.run_module('vspbfr_tpu_torch.cli.convert_ckpt',"
    " run_name='__main__')\n"
    "print('seconds', time.perf_counter() - t0)\n")


def run_conversions(jobs: dict, out_dir: str, extra=()) -> dict:
    """Every kind of `jobs` through `python -m vspbfr_tpu_torch.cli.
    convert_ckpt`, each in its own process (all started together, no CUDA
    device visible, JAX unimportable); returns {kind: (file, seconds)}."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    for kind, args in jobs.items():
        out = os.path.join(out_dir, f"{kind}.pt")
        procs[kind] = (out, subprocess.Popen(
            [sys.executable, "-c", NO_JAX_CONVERT, kind, *args, "--out", out,
             *extra], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    res = {}
    for kind, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"convert_ckpt {kind} failed:\n{stderr}")
        res[kind] = (out, float(stdout.split("seconds")[-1]))
    return res


def _assert_equal_sd(name: str, got: dict, want: dict) -> None:
    import torch

    if set(got) != set(want):
        raise AssertionError(f"convert {name}: keys differ: "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"convert {name}: not bit-identical: {bad[:5]}")


def phase_convert():
    """The reference's files of phase 5's seeded full-width modules (and a
    seeded D and ArcFace net) through `cli.convert_ckpt` without JAX, each
    output equal bit for bit to its source; then the converted pipeline
    (g_ema as the generator) restoring phase 5's faces on the card, f32
    and bf16, identically to the seeded one, with the serve kernels
    launching, and the converted scorers scoring identically."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.losses import (
        LPIPS,
        InceptionV3Features,
        ResNet101Embedder,
        make_inception_feature_fn,
    )
    from vspbfr_tpu_torch.models import Discriminator
    from vspbfr_tpu_torch.models.layers import init_module
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    if not torch.cuda.is_available():
        raise RuntimeError("phase convert needs CUDA")
    base, nets = SEEDED["pipe"], SEEDED["nets"]
    disc = init_module(Discriminator(), torch.Generator().manual_seed(52))
    arcface = init_module(ResNet101Embedder(),
                          torch.Generator().manual_seed(53))
    # the non-EMA generator: distinct weights, so a mix-up shows
    g = type(base.generator)()
    g.load_state_dict({k: v + 0.5 for k, v in
                       base.generator.state_dict().items()})
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        jobs = write_reference_files(tmp, base.psp, base.diffuser,
                                     base.generator, g, disc, arcface,
                                     nets["lpips"], nets["inception"])
        say(f"convert: reference files written in "
            f"{time.perf_counter() - t0:.1f} s")
        del g
        t0 = time.perf_counter()
        done = run_conversions(jobs, tmp)
        say(f"convert: six conversions (six processes at once, JAX "
            f"unimportable) in {time.perf_counter() - t0:.1f} s")
        loaded = {k: torch.load(f, map_location="cpu", weights_only=True)
                  for k, (f, _) in done.items()}
        for kind, (f, secs) in done.items():
            res[kind] = {"seconds": secs, "bytes": os.path.getsize(f),
                         "reference_bytes": os.path.getsize(
                             jobs[kind][1])}
            say(f"convert {kind}: {secs:.2f} s, {os.path.getsize(f)} "
                f"bytes written from {res[kind]['reference_bytes']} bytes")
    _assert_equal_sd("psp", loaded["psp"], base.psp.state_dict())
    _assert_equal_sd("diffuser", loaded["diffuser"]["diffuser"],
                     base.diffuser.state_dict())
    _assert_equal_sd("restore g_ema", loaded["restore"]["g_ema"],
                     base.generator.state_dict())
    _assert_equal_sd("restore d", loaded["restore"]["d"], disc.state_dict())
    _assert_equal_sd("arcface", loaded["arcface"], arcface.state_dict())
    _assert_equal_sd("lpips", loaded["lpips"], nets["lpips"].state_dict())
    _assert_equal_sd("inception", loaded["inception"],
                     nets["inception"].state_dict())
    if torch.equal(loaded["restore"]["g"]["conv1.noise.weight"],
                   loaded["restore"]["g_ema"]["conv1.noise.weight"]):
        raise AssertionError("convert restore: g and g_ema coincide")
    del disc, arcface

    # the converted pipeline, as a serving checkpoint: psp, diffuser and
    # g_ema as the generator
    pipe_sd = {f"psp.{k}": v for k, v in loaded["psp"].items()}
    pipe_sd.update({f"diffuser.{k}": v
                    for k, v in loaded["diffuser"]["diffuser"].items()})
    pipe_sd.update({f"generator.{k}": v
                    for k, v in loaded["restore"]["g_ema"].items()})
    low = torch.tensor(SEEDED["faces"], device="cuda")
    gt = torch.tensor(SEEDED["clean"], device="cuda")

    def build(sd, dt):
        p = RestorationPipeline(compute_dtype=dt)
        p.load_state_dict(sd)
        return p.cuda().eval().prepare_params()

    def run(p):
        return p.restore(low, torch.Generator(device="cuda").manual_seed(0),
                         draws=_draws(p, 4, 11, "cuda"))

    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        seeded = build(base.state_dict(), dt)
        conv = build(pipe_sd, dt)
        # the identity needs a reproducible path: with cuDNN's default
        # algorithms the f32 decode differs call to call (~1e-5, which
        # RestoreNet's random init amplifies), so compare under
        # deterministic ones
        with cudnn_deterministic():
            out_s = run(seeded)
            ops.reset_launch_counts()
            out_c = run(conv)
            counts = ops.launch_counts()
        diff = float((out_c.float() - out_s.float()).abs().max())
        # speed as the CLIs run it (cuDNN's defaults), in turns
        ms = {"seeded": [], "converted": []}
        for name in ("seeded", "converted", "converted", "seeded"):
            m = seeded if name == "seeded" else conv
            ms[name].append(cuda_ms(lambda: run(m), iters=5, warmup=1))
        ms_s, ms_c = ms["seeded"], ms["converted"]
        repeat = float((run(seeded).float() - run(seeded).float()).abs()
                       .max())
        ips = {"seeded": [4e3 / t for t in ms_s],
               "converted": [4e3 / t for t in ms_c]}
        say(f"convert {mode}: converted vs seeded restore, b4, max |diff| "
            f"{diff} (cuDNN deterministic; with its defaults the seeded "
            f"one against itself: {repeat}); ms (medians of 5, in turns "
            f"seeded, converted, converted, seeded) {ms_s[0]:.3f}, "
            f"{ms_c[0]:.3f}, {ms_c[1]:.3f}, {ms_s[1]:.3f}; launches "
            f"{counts}")
        missing = [k for k in PATH_KERNELS["serve"] if counts[k] == 0]
        if diff != 0.0 or missing or not torch.isfinite(out_c).all():
            raise AssertionError(f"convert {mode}: max |diff| {diff}, "
                                 f"kernels never launched {missing}")
        res[mode] = dict(max_abs_diff=diff, default_repeat_diff=repeat,
                         ms_seeded=ms_s, ms_converted=ms_c, imgs_per_s=ips,
                         launches=counts)
        del seeded, conv
        torch.cuda.empty_cache()
    scores = {}
    for name, cls in (("lpips", LPIPS), ("inception", InceptionV3Features)):
        pair = []
        for sd in (nets[name].state_dict(), loaded[name]):
            net = cls()
            net.load_state_dict(sd)
            net = net.cuda().eval()
            with torch.no_grad(), cudnn_deterministic():
                pair.append(net(low, gt) if name == "lpips" else
                            make_inception_feature_fn(net)(low))
        if not torch.equal(*pair):
            raise AssertionError(f"convert {name}: converted scores differ")
        scores[name] = float(pair[0].float().mean())
    say(f"convert: converted LPIPS and InceptionV3 score as the seeded "
        f"ones (mean LPIPS {scores['lpips']:.6f}, mean pool3 feature "
        f"{scores['inception']:.6f})")
    res["scores"] = scores
    REPORT["convert"] = res


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the duration of the block."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


# --- phase 12 ---------------------------------------------------------------

def _gate(name: str, got, ref) -> dict:
    """Phase 4's card-vs-CPU gate: mean |err| <= 1e-3 x range, max <= 1e-2
    x range of the CPU result."""
    import torch

    g, c = got.float().cpu(), ref.float()
    if g.shape != c.shape or not torch.isfinite(g).all():
        raise AssertionError(f"sample {name}: shape {tuple(g.shape)} vs "
                             f"{tuple(c.shape)} or non-finite")
    rng_ = float(c.max() - c.min())
    err = (g - c).abs()
    mean_r, max_r = float(err.mean()) / rng_, float(err.max()) / rng_
    say(f"sample {name}: range {rng_:.4f} mean|err|/range {mean_r:.3e} "
        f"max|err|/range {max_r:.3e}")
    if mean_r > 1e-3 or max_r > 1e-2:
        raise AssertionError(f"sample {name}: card vs CPU out of bounds")
    return dict(range=rng_, mean_rel=mean_r, max_rel=max_r)


def phase_sample():
    """Truncated sampling from the frozen 1024 px decoder at full width on
    the card against the CPU, same weights (phase 5's decoder, a seeded
    mapping MLP) and draws: `mean_latent` over 4096 z, `noise_mapping` of
    two style draws for b4 with an inject index, `truncate_styles` at 0.7
    toward the mean, the decode; then the pSp `GradualStyleEncoder` at 256
    px b4. CUDA-event medians of the f32 and bf16 sampling and of the
    encoder."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.evaluation import psnr
    from vspbfr_tpu_torch.models import GradualStyleEncoder, PSPFacade
    from vspbfr_tpu_torch.models.layers import (
        StyleMLP,
        init_module,
        truncate_styles,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("phase sample needs CUDA")
    style = init_module(StyleMLP(), torch.Generator().manual_seed(61))
    cpu = PSPFacade(mapping=True)
    cpu.load_state_dict({**SEEDED["pipe"].psp.state_dict(),
                         **{f"decoder.style.{k}": v
                            for k, v in style.state_dict().items()}})
    cpu.eval()
    card = PSPFacade(mapping=True)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    rng = np.random.default_rng(12)
    draws = {"z": rng.standard_normal((4096, 512)),
             "styles": rng.standard_normal((2, 4, 512))}
    # layer i's noise map is (4, r, r, 1), r = 4, 8, 8, 16, 16, ... 1024
    draws["noise"] = [rng.standard_normal(
        (4,) + (2 ** (2 + (i + 1) // 2),) * 2 + (1,)).astype(np.float32)
        for i in range(cpu.decoder.num_layers)]
    inject = 5

    def sample(psp, dev, dt=torch.float32):
        z = torch.tensor(draws["z"], dtype=dt, device=dev)
        st = torch.tensor(draws["styles"], dtype=dt, device=dev)
        noise = [torch.tensor(n, dtype=dt, device=dev)
                 for n in draws["noise"]]
        mean = psp.mean_latent(z=z)
        w = psp.noise_mapping(st, inject_index=inject)
        t = truncate_styles(w, 0.7, mean[None])
        img, _ = psp.decoder(t, noise=noise)
        return {"mean_latent": mean, "noise_mapping": w, "truncated": t,
                "image": img}

    res = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = sample(cpu, "cpu")
        t_cpu = time.perf_counter() - t0
        ops.reset_launch_counts()
        got = sample(card, "cuda")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        say(f"sample: 1024 px b4, CPU {t_cpu:.1f} s; card launches {counts}")
        res["gate"] = {k: _gate(k, got[k], ref[k]) for k in ref}
        missing = [k for k in PATH_KERNELS["sample"] if counts[k] == 0]
        if missing:
            raise AssertionError(f"sample: kernels never launched {missing}")
        res["launches"] = counts
        del cpu, ref
        img32 = got["image"].float()
        ms = {"f32": cuda_ms(lambda: sample(card, "cuda"), iters=5, warmup=1),
              "mean_latent_f32": cuda_ms(lambda: card.mean_latent(
                  z=torch.tensor(draws["z"], dtype=torch.float32,
                                 device="cuda")), iters=10, warmup=2)}
        card.decoder.to(torch.bfloat16)
        got16 = sample(card, "cuda", torch.bfloat16)
        if not torch.isfinite(got16["image"]).all():
            raise AssertionError("sample bf16: non-finite image")
        ms["bf16"] = cuda_ms(lambda: sample(card, "cuda", torch.bfloat16),
                             iters=5, warmup=1)
        p16 = float(psnr(got16["image"].float(), img32,
                         data_range=max(2 * float(img32.abs().max()),
                                        2.0)).mean())
        say(f"sample b4 (mean_latent of 4096 z, noise_mapping, truncation, "
            f"1024 px decode; ms, medians of 5): f32 {ms['f32']:.3f}, bf16 "
            f"{ms['bf16']:.3f}; mean_latent alone f32 "
            f"{ms['mean_latent_f32']:.3f}; bf16 vs f32 image PSNR "
            f"{p16:.3f} dB")
        res.update(ms=ms, bf16_vs_f32_psnr_db=p16)
        del card, got, got16
        torch.cuda.empty_cache()

        enc = init_module(GradualStyleEncoder(),
                          torch.Generator().manual_seed(62)).eval()
        x = torch.tensor(synthetic_faces(4, 256, seed=13))
        t0 = time.perf_counter()
        ref = enc(x)
        t_cpu = time.perf_counter() - t0
        enc = enc.cuda()
        xc = x.cuda()
        res["encoder_gate"] = _gate("GradualStyleEncoder", enc(xc), ref)
        res["encoder_ms"] = cuda_ms(lambda: enc(xc), iters=5, warmup=1)
        say(f"sample: GradualStyleEncoder 256 px b4 (18 styles), "
            f"{res['encoder_ms']:.3f} ms (median of 5), CPU {t_cpu:.1f} s")
    REPORT["sample"] = res


# --- phase 13 ---------------------------------------------------------------

RANK_TIMEOUT = 240      # seconds one phase-13 run of ranks may take


def _spawn_ranks(mode: str, out: str, nproc: int | None, argv=()) -> dict:
    """Start `rank_main(mode, out, *argv)` in a new process, under torchrun
    with `nproc` ranks (`--standalone`) or, with nproc None, alone; the
    handle `_collect_ranks` waits for."""
    if nproc is None:
        cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py")]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc),
               os.path.join(HERE, "chip_smoke.py")]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    proc = subprocess.Popen(cmd + ["--rank", mode, out, *argv], cwd=HERE,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    return dict(proc=proc, mode=mode, out=out, nproc=nproc,
                t0=time.perf_counter())


def _stop_ranks(h: dict) -> None:
    """Kill a `_spawn_ranks` process and every rank it started."""
    if h["proc"].poll() is None:
        os.killpg(h["proc"].pid, signal.SIGKILL)
    h["proc"].communicate()


def _collect_ranks(h: dict, timeout: int = RANK_TIMEOUT) -> list[dict]:
    """Wait for a `_spawn_ranks` process (killed at `timeout` seconds after
    its start) and return each rank's record."""
    proc, mode, nproc = h["proc"], h["mode"], h["nproc"]
    left = max(1.0, timeout - (time.perf_counter() - h["t0"]))
    try:
        stdout, stderr = proc.communicate(timeout=left)
    except BaseException:
        _stop_ranks(h)
        raise
    wall = time.perf_counter() - h["t0"]
    if proc.returncode != 0:
        raise AssertionError(f"parallel {mode} ({nproc} ranks): exit "
                             f"{proc.returncode}\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[dist]")]
    say(f"parallel {mode}: {nproc or 1} process(es) in {wall:.1f} s; "
        + "; ".join(lines))
    recs = []
    for r in range(nproc or 1):
        with open(f"{h['out']}.{r}.json") as f:
            recs.append(json.load(f))
        recs[-1]["wall_s"] = wall
        if any(recs[-1]["plain_cuda_calls"].values()):
            raise AssertionError(f"parallel {mode} rank {r}: a plain version "
                                 f"ran on the card: "
                                 f"{recs[-1]['plain_cuda_calls']}")
    return recs


def _bit_sums(module) -> list[int]:
    """Two sums of the bits of each tensor of the module's state (as int64,
    plain and position-weighted): equal lists for bit-identical states."""
    import torch

    sums = []
    for t in module.state_dict().values():
        v = t.detach().reshape(-1)
        bits = (v.view(torch.int32) if v.dtype == torch.float32
                else v).to(torch.int64)
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        sums += [bits.sum(), (bits * w).sum()]
    return torch.stack(sums).tolist()


def _stage2_parallel_trainer(batch: int, dp=None):
    """Phase 7's full-width stage-2 config (256 px, 1024 px decoder,
    IR-SE-50) from seed 3, the diffuser's attention conditioned as phase
    7's card-vs-CPU step is."""
    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)

    tr = DiffuserTrainer(DiffuserTrainConfig(size=256, batch=batch),
                         RestorationPipeline(size=256), dp).init_from_seed(3)
    _condition_diffuser(tr.pipe)
    return tr


def _stage2_update(tr) -> dict:
    """The diffuser's parameters after a step and Adam's first moments, on
    the host: with beta1 = 0 the moment is the step's (reduced)
    gradient."""
    st = tr.state.opt.state
    return {"params": {n: p.detach().cpu().clone()
                       for n, p in tr.diffuser.named_parameters()},
            "grads": {n: st[p]["exp_avg"].cpu().clone()
                      for n, p in tr.diffuser.named_parameters()}}


def _stage2_parallel_batch(device):
    import torch

    return [torch.tensor(synthetic_faces(16, 256, seed=s), device=device)
            for s in (41, 42)]


def rank_main(argv) -> None:
    """One process of phase 13, `--rank MODE OUT [CLI flags]`: MODE
    "restore" runs the stage-3 CLI with the flags, "restore_sums" the same
    recording the bit sums of G, D, g_ema and the ADA state after each
    step, "stage2" one stage-2 step at phase 7's config on this rank's rows
    of a b16 batch. Each gradient all-reduce is timed with CUDA events.
    Writes OUT.<rank>.json."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.parallel import DataParallel, distributed, mesh
    from vspbfr_tpu_torch.train import restore_train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mode, out, *flags = argv
    if mode == "mesh2d":
        return _mesh_rank(out, *flags)
    if mode == "meshtrain":
        return _meshtrain_rank(out, *flags)
    events, sums = [], []
    reduce, step = (mesh.DataParallel.all_reduce_grads,
                    restore_train.RestoreTrainer.train_step)

    def all_reduce_grads(self, params):
        params = list(params)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reduce(self, params)
        end.record()
        if self.backend:
            events.append((start, end, sum(p.numel() * p.element_size()
                                           for p in params)))

    def train_step(self, *a, **kw):
        metrics = step(self, *a, **kw)
        sums.append({"g": _bit_sums(self.gen), "d": _bit_sums(self.disc),
                     "g_ema": _bit_sums(self.g_ema),
                     "ada": [float(v) for v in self.ada_state]})
        return metrics

    mesh.DataParallel.all_reduce_grads = all_reduce_grads
    if mode == "restore_sums":
        restore_train.RestoreTrainer.train_step = train_step
    rec = {}
    if mode in ("restore", "restore_sums"):
        from vspbfr_tpu_torch.cli import train_restore

        rec["report"] = train_restore.main(flags)
    else:
        with distributed("cuda") as device:
            dp = DataParallel()
            tr = _stage2_parallel_trainer(8, dp).to(device)
            dp.replicate(tr.diffuser)
            low, real = (x[dp.local_rows(16)]
                         for x in _stage2_parallel_batch(device))
            m = tr.train_step(low, real,
                              torch.Generator(device=device).manual_seed(13))
            rec["metrics"] = {k: float(v) for k, v in m.items()}
            rec["diffuser"] = f"{out}.{dp.rank}.pt"
            torch.save(_stage2_update(tr), rec["diffuser"])
            rec["sums"] = _bit_sums(tr.diffuser)
    torch.cuda.synchronize()
    rec.update(
        launches=ops.launch_counts(), plain_cuda_calls=ops.plain_cuda_calls(),
        allreduce_ms=[s.elapsed_time(e) for s, e, _ in events],
        allreduce_bytes=[n for _, _, n in events], step_sums=sums,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    with open(f"{out}.{os.environ.get('RANK', '0')}.json", "w") as f:
        json.dump(rec, f)


def _lone_restore(flags) -> dict:
    """The stage-3 CLI in this process (no process group), as phase 8 runs
    it: its report, launch counts and peak memory."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli import train_restore

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = train_restore.main(flags)
    torch.cuda.synchronize()
    return dict(report=report, launches=ops.launch_counts(),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                wall_s=time.perf_counter() - t0)


def _parallel_world1(res, faces_dir, tmp):
    """(a) The stage-3 CLI at full width, b4, bf16, 3 steps (R1 at step 0)
    alone (in this process) and under torchrun at world size 1 (NCCL), in
    turns alone, torchrun, alone: the torchrun run's per-step losses
    against the first lone run, within 10x the second lone run's spread
    against the first (phase 8's rule; equal where that spread is 0); the
    restore kernels launch, no plain K6 / K7 runs on the card; step-time
    medians and the all-reduce's CUDA-event ms and bytes a step."""
    flags = ["--path", faces_dir, "--size", "512", "--decoder_size", "1024",
             "--channel_multiplier", "2", "--batch", "4", "--iter", "3",
             "--train_dtype", "bf16", "--device", "cuda", "--seed", "0",
             "--save_inter", "100000", "--show_inter", "100000"]
    runs = {}
    for key in ("alone0", "torchrun", "alone1"):
        out = os.path.join(tmp, key)
        if key == "torchrun":
            (rec,) = _collect_ranks(_spawn_ranks("restore", out, 1,
                                                 flags + ["--out", out]))
        else:
            rec = _lone_restore(flags + ["--out", out])
        steps = rec["report"]["steps"]
        if len(steps) != 3 or not steps[0]["r1"] > 0:
            raise AssertionError(f"parallel {key}: steps {steps}")
        runs[key] = rec
    names = [k for k in runs["alone0"]["report"]["steps"][0]
             if k not in ("it", "seconds")]
    gate = {}
    for k in names:
        ref = np.array([s[k] for s in runs["alone0"]["report"]["steps"]])
        again = np.array([s[k] for s in runs["alone1"]["report"]["steps"]])
        got = np.array([s[k] for s in runs["torchrun"]["report"]["steps"]])
        scale = max(float(np.abs(ref).max()), 1e-12)
        err = float(np.abs(got - ref).max()) / scale
        spread = float(np.abs(again - ref).max()) / scale
        gate[k] = dict(rel_err=err, spread=spread)
        if not (np.all(np.isfinite(got)) and err <= 10 * spread):
            raise AssertionError(f"parallel world 1 {k}: torchrun vs alone "
                                 f"{err:.3e}, spread {spread:.3e}")
    tr = runs["torchrun"]
    if tr["report"]["world_size"] != 1:
        raise AssertionError("parallel: torchrun run is not world size 1")
    missing = [k for k in PATH_KERNELS["parallel"] if tr["launches"][k] == 0]
    if missing:
        raise AssertionError(f"parallel world 1: kernels never launched "
                             f"{missing}")
    ms, nbytes = tr["allreduce_ms"], tr["allreduce_bytes"]
    if not ms or not all(nbytes):
        raise AssertionError("parallel world 1: no gradient all-reduce")
    med = {k: statistics.median(s["seconds"] for s in r["report"]["steps"]
                                [1:]) * 1e3 for k, r in runs.items()}
    res["world1"] = dict(
        gate=gate, median_step_ms=med, launches=tr["launches"],
        allreduce_ms=ms, allreduce_bytes=nbytes,
        allreduce_ms_per_step=sum(ms) / 3,
        allreduce_bytes_per_step=sum(nbytes) / 3,
        peak_gib={k: r["peak_gib"] for k, r in runs.items()},
        wall_s={k: r["wall_s"] for k, r in runs.items()},
        losses={k: r["report"]["steps"] for k, r in runs.items()})
    say(f"parallel world 1 (NCCL) bf16 b4: median step ms (first excluded) "
        f"alone {med['alone0']:.1f} / torchrun {med['torchrun']:.1f} / "
        f"alone {med['alone1']:.1f} (wall s incl. init "
        f"{[round(r['wall_s'], 1) for r in runs.values()]}); gradient "
        f"all-reduce {len(ms)} calls, "
        f"{sum(ms) / 3:.3f} ms and {sum(nbytes) / 3 / 2 ** 20:.1f} MiB a "
        f"step (calls: {[round(x, 3) for x in ms]} ms); loss gate "
        + ", ".join(f"{k} {v['rel_err']:.2e}/{v['spread']:.2e}"
                    for k, v in gate.items())
        + f"; launches {tr['launches']}")


def _parallel_stage2(res, tmp):
    """(b) Stage 2 at phase 7's full-width config, TF32 off: two gloo ranks
    on the one card at b8 against this process at b16, on the same rows
    and draws; both ranks' diffusers bit-identical. The losses, the reduced
    gradients (Adam's first moments) and the updated parameters within
    phase 7's f32 gate: 10x the spread of the b16 step under +-1e-6 input
    changes, + 1e-5 (worst tensor)."""
    import torch

    out = os.path.join(tmp, "stage2")
    ranks = _collect_ranks(_spawn_ranks("stage2", out, 2))
    if ranks[0]["sums"] != ranks[1]["sums"]:
        raise AssertionError("parallel stage 2: the ranks' diffusers differ")
    got = torch.load(ranks[0]["diffuser"], weights_only=True)
    tr = _stage2_parallel_trainer(16).to("cuda")
    init = {k: v.clone() for k, v in tr.diffuser.state_dict().items()}
    low, real = _stage2_parallel_batch("cuda")
    runs = []
    for f in (1.0, 1 + 1e-6, 1 - 1e-6):
        tr.diffuser.load_state_dict(init)
        tr.state.opt.state.clear()
        m = tr.train_step(low * f, real,
                          torch.Generator(device="cuda").manual_seed(13))
        runs.append(({k: float(v) for k, v in m.items()},
                     _stage2_update(tr)))
    (m1, u1), *pert = runs
    gate = {}
    for k in m1:
        scale = max(abs(m1[k]), 1e-12)
        gate[k] = dict(
            rel_err=max(abs(r["metrics"][k] - m1[k]) for r in ranks) / scale,
            spread=max(abs(p[0][k] - m1[k]) for p in pert) / scale)
    for part in ("grads", "params"):
        ref = u1[part]
        gate[part] = dict(
            rel_err=max(_rel(got[part][k], ref[k]) for k in ref),
            spread=max(_rel(p[1][part][k], ref[k]) for p in pert
                       for k in ref))
    say("parallel stage 2 (2 gloo ranks b8 vs one process b16, f32), rel "
        "err / spread: " + ", ".join(
            f"{k} {v['rel_err']:.2e}/{v['spread']:.2e}"
            for k, v in gate.items())
        + f"; all-reduce ms {ranks[0]['allreduce_ms']}")
    res["stage2"] = dict(gate=gate, allreduce_ms=ranks[0]["allreduce_ms"],
                         allreduce_bytes=ranks[0]["allreduce_bytes"],
                         metrics=[r["metrics"] for r in ranks],
                         reference=m1)
    bad = [k for k, v in gate.items()
           if not v["rel_err"] <= 10 * v["spread"] + 1e-5]
    if bad:
        raise AssertionError(f"parallel stage 2: out of the f32 gate: {bad}")
    del tr


def _start_stage3(faces_dir, tmp) -> dict:
    """(b) The stage-3 CLI at full width, bf16, two gloo ranks on the one
    card at b2 each, 2 steps with ADA (the controller on), started beside
    stage 2's check (`_parallel_stage3` waits for it)."""
    out = os.path.join(tmp, "stage3")
    flags = ["--path", faces_dir, "--size", "512", "--decoder_size", "1024",
             "--batch", "2", "--iter", "2", "--train_dtype", "bf16",
             "--augment", "--device", "cuda", "--seed", "0",
             "--save_inter", "2", "--show_inter", "100000", "--out", out]
    return _spawn_ranks("restore_sums", out, 2, flags)


def _parallel_stage3(res, h):
    """G, D, g_ema and the ADA state bit-identical across the two ranks
    after each step; only rank 0 writes the checkpoint."""
    ranks = _collect_ranks(h)
    a, b = (r["step_sums"] for r in ranks)
    if len(a) != 2 or a != b:
        raise AssertionError("parallel stage 3: the ranks' G, D, g_ema or "
                             "ADA state differ")
    if not os.path.exists(os.path.join(h["out"], "checkpoint",
                                       "restore.pt")):
        raise AssertionError("parallel stage 3: rank 0 wrote no checkpoint")
    steps = ranks[0]["report"]["steps"]
    say(f"parallel stage 3 (2 gloo ranks b2, bf16, ADA; beside stage 2's "
        f"check): bit-identical after both steps; ADA state {a[-1]['ada']}; "
        f"step seconds {[round(s['seconds'], 3) for s in steps]}; all-reduce "
        f"ms {[round(x, 1) for x in ranks[0]['allreduce_ms']]}")
    res["stage3"] = dict(ada=a[-1]["ada"], steps=steps,
                         allreduce_ms=ranks[0]["allreduce_ms"],
                         launches=ranks[0]["launches"])


def phase_parallel():
    """Data-parallel training (`vspbfr_tpu_torch/parallel/`): (a) world size
    1 on NCCL against the lone process, (b) two gloo ranks on the one card
    at stage 2 and stage 3. NCCL across cards needs more than one card."""
    import torch

    SEEDED["nets"].clear()
    SEEDED.pop("pipe", None)
    torch.cuda.empty_cache()
    res = {}
    faces = synthetic_faces(8, 512, seed=8)
    gt_u8 = np.round((faces + 1.0) * 127.5).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "faces")
        os.makedirs(d)
        for i, f in enumerate(gt_u8):
            np.save(os.path.join(d, f"face{i}.npy"), f)
        _parallel_world1(res, d, tmp)
        torch.cuda.empty_cache()
        # the two gloo checks share the card (~50 of its 80 GB); their
        # times are not compared with anything
        stage3 = _start_stage3(d, tmp)
        try:
            _parallel_stage2(res, tmp)
        except BaseException:
            _stop_ranks(stage3)
            raise
        _parallel_stage3(res, stage3)
    REPORT["parallel"] = res


# --- phase 14 ---------------------------------------------------------------

HOSTDATA_TIMEOUT = 300  # seconds one phase-14 training process may take

# backward_counts' specs: name -> (module of `vspbfr_tpu_torch.ops`, its
# autograd Function, the kernel wrapper whose launches inside the Function's
# backward are counted, or None to count the backward's calls)
CLI_BACKWARDS = {
    "dense_conv_epilogue": ("dense_conv", "_DenseConvEpi", None),
    "dilated_multi_conv": ("dilated_conv", "_DilatedMulti", None),
    "smart_core": ("smart", "_SmartCore", None),
    "conv_epilogue": ("epilogue", "_ConvEpilogue", None)}


@contextlib.contextmanager
def backward_counts(specs: dict):
    """Count, while the block runs, the backward calls of the kernels'
    autograd Functions that `specs` names (or, where a spec names a kernel
    wrapper, that wrapper's launches inside the backward): yields the
    counts, name -> n (a dict, which `.clear()` resets)."""
    import importlib

    counts: dict = {}
    saved = []
    for name, (mod_name, cls_name, kernel) in specs.items():
        mod = importlib.import_module(f"vspbfr_tpu_torch.ops.{mod_name}")
        cls = getattr(mod, cls_name)
        backward = cls.__dict__["backward"]
        wrapper = getattr(mod, kernel) if kernel else None

        def count(ctx, *g, name=name, backward=backward.__func__,
                  wrapper=wrapper):
            before = wrapper.launches if wrapper else 0
            out = backward(ctx, *g)
            counts[name] = counts.get(name, 0) + (
                wrapper.launches - before if wrapper else 1)
            return out

        saved.append((cls, backward))
        cls.backward = staticmethod(count)
    try:
        yield counts
    finally:
        for cls, backward in reversed(saved):
            cls.backward = backward


# runs a trainer CLI (argv: CLI module, output JSON, its flags) where any
# import of cv2, PIL, JAX or the JAX package fails, timing each wait on its
# loader (the host clock from asking for a batch to receiving it) and
# counting the backward calls of the kernels' autograd Functions (the
# backward rows' launches in PERF.md)
NO_CV_TRAIN = (
    "import importlib, json, sys, time\n"
    "for m in ('cv2', 'PIL', 'jax', 'vspbfr_tpu'):\n"
    "    sys.modules[m] = None\n"
    "import torch\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "from vspbfr_tpu_torch import ops\n"
    "from chip_smoke import CLI_BACKWARDS, backward_counts\n"
    "cli = importlib.import_module('vspbfr_tpu_torch.cli.' + sys.argv[1])\n"
    "waits, build = [], cli.build_loader\n"
    "def timed_loader(*a, **kw):\n"
    "    loader = build(*a, **kw)\n"
    "    forever = loader.forever\n"
    "    def timed(*fa, **fkw):\n"
    "        batches = forever(*fa, **fkw)\n"
    "        while True:\n"
    "            t0 = time.perf_counter()\n"
    "            batch = next(batches)\n"
    "            waits.append(time.perf_counter() - t0)\n"
    "            yield batch\n"
    "    loader.forever = timed\n"
    "    return loader\n"
    "cli.build_loader = timed_loader\n"
    "ops.reset_launch_counts()\n"
    "ops.reset_plain_cuda_calls()\n"
    "with backward_counts(CLI_BACKWARDS) as backwards:\n"
    "    report = cli.main(sys.argv[3:])\n"
    "torch.cuda.synchronize()\n"
    "with open(sys.argv[2], 'w') as f:\n"
    "    json.dump(dict(report=report, launches=ops.launch_counts(),\n"
    "                   forms=ops.form_counts(), backwards=backwards,\n"
    "                   plain=ops.plain_cuda_calls(), waits=waits,\n"
    "                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30),\n"
    "              f)\n")


def _face_dir(d: str, n: int, size: int, seed: int) -> np.ndarray:
    """n synthetic uint8 faces at `size` px, as `.npy` files in d."""
    gt_u8 = np.round((synthetic_faces(n, size, seed=seed) + 1.0)
                     * 127.5).astype(np.uint8)
    os.makedirs(d)
    for i, f in enumerate(gt_u8):
        np.save(os.path.join(d, f"face{i}.npy"), f)
    return gt_u8


def _host_chain_cli(res, key, module, flags, kernels, losses, tmp):
    """One trainer CLI run in its own process (`NO_CV_TRAIN`): the path's
    kernels must launch, no plain K6 / K7 may run on the card, every loss
    must be finite; step medians and the loader's waits."""
    out = os.path.join(tmp, key)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", NO_CV_TRAIN, module, out + ".json",
         "--out", out, "--device", "cuda", "--seed", "0", "--iter", "3",
         "--train_dtype", "bf16", "--save_inter", "100000",
         "--show_inter", "100000", *flags],
        cwd=HERE, capture_output=True, text=True, timeout=HOSTDATA_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"hostdata {key}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out + ".json") as f:
        rec = json.load(f)
    steps = rec["report"]["steps"]
    if len(steps) != 3 or not all(np.isfinite(s[k]) for s in steps
                                  for k in losses):
        raise AssertionError(f"hostdata {key}: steps {steps}")
    if "r1" in losses and not steps[0]["r1"] > 0:
        raise AssertionError(f"hostdata {key}: no R1 at step 0")
    missing = [k for k in kernels if rec["launches"][k] == 0]
    if missing:
        raise AssertionError(f"hostdata {key}: kernels never launched "
                             f"{missing}")
    if any(rec["plain"].values()):
        raise AssertionError(f"hostdata {key}: a plain version ran on the "
                             f"card: {rec['plain']}")
    secs = [s["seconds"] for s in steps]
    med = statistics.median(secs[1:])
    waits = rec["waits"][:3]       # the loop asks for a 4th batch, then ends
    res[key] = dict(step_seconds=secs, median_step_ms=med * 1e3,
                    loader_wait_s=waits, launches=rec["launches"],
                    backward_calls=rec["backwards"],
                    peak_gib=rec["peak_gib"], wall_s=wall, losses=steps)
    say(f"hostdata {key}: step seconds {[round(x, 4) for x in secs]}, "
        f"median (first excluded) {med * 1e3:.1f} ms; seconds waiting on "
        f"the loader before each step {[round(x, 4) for x in waits]}"
        f"; peak {rec['peak_gib']:.3f} GiB, wall {wall:.1f} s incl. init; "
        f"launches {rec['launches']}; backward calls {rec['backwards']}")


def _loader_rate(make, batches: int = 8, sync: bool = False) -> float:
    """Images a second of a fresh loader's first `batches` batches, from
    asking for the first to holding the last (the fill included), each
    batch finished on the card with `sync`."""
    import torch

    loader = make()
    t0 = time.perf_counter()
    it = loader.forever()
    n = 0
    for _ in range(batches):
        batch = next(it)
        n += batch[0].shape[0]
        if sync:
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    it.close()
    return n / dt


def _loader_rates(res, faces_dir):
    """(b) Images a second at 512 px b4 over 8 batches: the numpy host
    chain and the C++ engine (the CLIs' host loader, one chain a sample),
    the engine alone on its own thread pool (`os.cpu_count()` threads),
    the device chain with the host JPEG and with the device JPEG."""
    import torch

    from vspbfr_tpu_torch.data import (DataLoader, DeviceDegradeLoader,
                                       RestoreTrainDataset, native)

    def ds(use_native=True):
        return RestoreTrainDataset(faces_dir, im_size=(512, 512),
                                   n_degraded=1, seed=0,
                                   use_native=use_native)

    def device(jpeg):
        return lambda: DeviceDegradeLoader(ds(), 4, device="cuda",
                                           jpeg=jpeg)

    next(device("device")().forever())          # warm the device chain
    torch.cuda.synchronize()
    rates = {
        "numpy": _loader_rate(lambda: DataLoader(ds(False), 4)),
        "native": _loader_rate(lambda: DataLoader(ds(), 4)),
        "jpeg_host": _loader_rate(device("host"), sync=True),
        "device": _loader_rate(device("device"), sync=True)}
    gt = np.stack([np.load(os.path.join(faces_dir, f"face{i}.npy"))
                   for i in range(32)]).astype(np.float32) / 255.0
    threads = os.cpu_count() or 1
    t0 = time.perf_counter()
    native.degrade_batch(gt, np.arange(32, dtype=np.uint64) + 1, threads)
    rates["native_pool"] = 32 / (time.perf_counter() - t0)
    res["loader_imgs_per_s"] = rates
    res["cpu_count"] = threads
    say(f"hostdata loader rates, 512 px b4 over 8 batches (imgs/s; "
        f"{threads} CPUs): numpy host chain {rates['numpy']:.2f}, C++ "
        f"engine (the host loader's 8 threads) {rates['native']:.2f}, the "
        f"engine alone on {threads} threads (32 images) "
        f"{rates['native_pool']:.2f}, --jpeg host {rates['jpeg_host']:.2f}, "
        f"device chain {rates['device']:.2f}")


def _numpy_stages(gt, p, buf: int, size: int, jpg):
    """The numpy chain's stage A (blur, haze, downscale, u8; sigma 0) of
    float [0, 1] GT and its stage B (resize back, u8 grid, gray) of the
    JPEG'd small images, on the device stages' parameters."""
    from vspbfr_tpu_torch.data.degradations import (BGR2GRAY, filter2d,
                                                    resize_linear, to_gray,
                                                    to_u8)

    small = np.zeros((len(gt), buf, buf, 3), np.uint8)
    lq = np.zeros((len(gt), size, size, 3), np.float32)
    for i in range(len(gt)):
        h, w = int(p.dh[i]), int(p.dw[i])
        x = filter2d(gt[i], p.kernels[i])
        x = x * p.alpha[i] + (1.0 - p.alpha[i])
        small[i, :h, :w] = to_u8(resize_linear(x, w, h) * 255.0)
        y = resize_linear(jpg[i, :h, :w].astype(np.float32) / 255.0, size,
                          size)
        y = to_u8(y * 255.0).astype(np.float32) / 255.0
        lq[i] = (np.repeat(to_gray(y, BGR2GRAY)[..., None], 3, axis=2)
                 if p.gray[i] else y)
    return small, lq


def _stage_checks(res, gt_u8):
    """(c) One full-width stage_a batch from the card (b4, one hazy, one
    gray sample): the device JPEG against `host_jpeg.py` (mean and 99th
    percentile |diff| over the valid regions), the C++ engine's JPEG equal
    to `host_jpeg.py`, and stage_a / stage_b at sigma 0 against the numpy
    chain on the same parameters within the CPU tests' bound for the
    device stages (`test_degrade_batch_matches_jax`: mean |diff| <= 0.05
    u8 levels, max 1)."""
    import torch

    from vspbfr_tpu_torch.data import native
    from vspbfr_tpu_torch.data.device_degrade import DeviceDegrader, sample_params
    from vspbfr_tpu_torch.data.device_jpeg import (jpeg_roundtrip_batch,
                                                   quality_tables)
    from vspbfr_tpu_torch.data.host_jpeg import jpeg_roundtrip

    dd = DeviceDegrader(512)
    p = sample_params(np.random.default_rng(14), 4, 512, dd.cfg)
    p.sigma[:] = 0.0
    p.alpha[1] = 0.8
    p.gray[2] = True
    seeds = np.arange(4, dtype=np.uint32)
    gt = torch.as_tensor(gt_u8[:4]).cuda().float() / 255.0
    small_dev = dd.stage_a(gt, p, seeds)
    small = small_dev.cpu().numpy()
    host = dd.host_jpeg(small, p)
    tl = np.stack([quality_tables(int(q))[0] for q in p.quality])
    tc = np.stack([quality_tables(int(q))[1] for q in p.quality])
    dev = jpeg_roundtrip_batch(
        small_dev, torch.as_tensor(p.dh).cuda().long(),
        torch.as_tensor(p.dw).cuda().long(), torch.as_tensor(tl).cuda(),
        torch.as_tensor(tc).cuda()).cpu().numpy()
    diffs, cpp_equal = [], True
    for i in range(4):
        h, w = int(p.dh[i]), int(p.dw[i])
        diffs.append(np.abs(dev[i, :h, :w].astype(np.int32)
                            - host[i, :h, :w]).ravel())
        crop = small[i, :h, :w]
        cpp_equal &= np.array_equal(native.jpeg_roundtrip(crop, p.quality[i]),
                                    jpeg_roundtrip(crop, int(p.quality[i])))
    d = np.concatenate(diffs)
    lq = dd.stage_b(torch.as_tensor(host).cuda(), p).cpu().numpy()
    ref_small, ref_lq = _numpy_stages(gt_u8[:4].astype(np.float32) / 255.0,
                                      p, dd.buf, 512, host)
    da = np.concatenate([np.abs(small[i, :p.dh[i], :p.dw[i]].astype(np.int32)
                                - ref_small[i, :p.dh[i], :p.dw[i]]).ravel()
                         for i in range(4)])
    db = np.abs(np.rint(lq * 255.0) - np.rint(ref_lq * 255.0))
    res["stages"] = dict(
        sizes=[[int(p.dh[i]), int(p.dw[i])] for i in range(4)],
        quality=[int(q) for q in p.quality],
        device_jpeg_mean_abs=float(d.mean()),
        device_jpeg_p99_abs=float(np.quantile(d, 0.99)),
        device_jpeg_max_abs=int(d.max()), cpp_jpeg_equal=bool(cpp_equal),
        stage_a_equal=float((da == 0).mean()), stage_a_max=int(da.max()),
        stage_b_equal=float((db == 0).mean()), stage_b_max=float(db.max()))
    say(f"hostdata stages (b4, downscaled to {res['stages']['sizes']}, q "
        f"{res['stages']['quality']}): device JPEG vs host_jpeg.py mean "
        f"|diff| {d.mean():.4f}, p99 {np.quantile(d, 0.99):.1f}, max "
        f"{d.max()} levels; C++ JPEG equal: {cpp_equal}; stage_a vs numpy "
        f"{(da == 0).mean():.5f} equal, max {da.max()}; stage_b vs numpy "
        f"{(db == 0).mean():.5f} equal, max {db.max():.0f}")
    if not cpp_equal:
        raise AssertionError("hostdata: the C++ JPEG differs from "
                             "host_jpeg.py")
    for name, x in (("stage_a", da), ("stage_b", db)):
        if not (x.mean() <= 0.05 and x.max() <= 1):
            raise AssertionError(f"hostdata: {name} vs the numpy chain: "
                                 f"mean |diff| {x.mean()}, max {x.max()}")


def phase_hostdata():
    """The host degradation chain (`data/host_jpeg.py`, `data/degradations.
    py`, `data/native.py`): (a) both trainer CLIs on it, each in its own
    process without cv2, PIL, JAX or the JAX package, (b) loader rates,
    (c) the JPEG and stage checks."""
    import torch

    torch.cuda.empty_cache()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 32 faces: 8 batches of 4 an epoch, one for each loader thread
        # (with fewer, a loader runs fewer threads and refills only when
        # an epoch turns over)
        faces512 = os.path.join(tmp, "faces512")
        gt_u8 = _face_dir(faces512, 32, 512, seed=14)
        faces256 = os.path.join(tmp, "faces256")
        _face_dir(faces256, 16, 256, seed=15)
        _host_chain_cli(
            res, "stage3_host", "train_restore",
            ["--path", faces512, "--size", "512", "--decoder_size", "1024",
             "--batch", "4", "--loader", "host", "--n_degraded", "2"],
            PATH_KERNELS["restore"],
            ("d", "r1", "real_score", "fake_score", "g", "gan", "percept",
             "id"), tmp)
        _host_chain_cli(
            res, "stage2_jpeg_host", "train_diffuser",
            ["--path", faces256, "--size", "256", "--decoder_size", "1024",
             "--batch", "16", "--loader", "device", "--jpeg", "host"],
            PATH_KERNELS["train"], ("loss", "l1", "kl", "percept", "id"),
            tmp)
        _loader_rates(res, faces512)
        _stage_checks(res, gt_u8)
    REPORT["hostdata"] = res


# --- phase 15 ---------------------------------------------------------------

PACKED_PMR = 512   # the JAX CLIs' default threshold


def _packed_conv_cases():
    """(label, x shape, unpacked w shape, form) of the convs the packed
    path at packed_min_res 512 runs as one K1 each, b4 at full width: the
    assembled stride-1 kernels of the decoder's 1024 px and both models'
    512 px levels, SMART's d1 + d2 pair, the up-convs into and within the
    packed levels and the encoder's down-conv out of them."""
    return [("styled 1024px C32 packed", (4, 512, 512, 128), (3, 3, 32, 32),
             "s1"),
            ("styled 512px C64 packed", (4, 256, 256, 256), (3, 3, 64, 64),
             "s1"),
            ("SMART d1+d2 512px C64 packed", (4, 256, 256, 256),
             (3, 3, 64, 16), "d12"),
            ("up-conv 256->512 packed out", (4, 256, 256, 128),
             (3, 3, 128, 64), "up"),
            ("up-conv 512->1024 packed", (4, 256, 256, 256), (3, 3, 64, 32),
             "up_packed"),
            ("down-conv 512->256 packed in", (4, 256, 256, 256),
             (3, 3, 64, 128), "down")]


def _packed_weight(rand, dt, ws, form):
    """(assembled kernel in dt, pads) of a `_packed_conv_cases` entry."""
    from vspbfr_tpu_torch.ops import packed as pk
    from vspbfr_tpu_torch.ops.modulated_conv import d12_kernel

    scale = 1.0 / (9 * ws[2]) ** 0.5
    if form == "d12":
        wp, py, px = d12_kernel(rand(*ws) * scale, rand(*ws) * scale)
    else:
        wp, py, px = pk.assembled_kernel(rand(*ws) * scale, form)
    return wp.to(dt).contiguous(), (tuple(py), tuple(px))


def _nc4_operands(rand, dt, xs, pieces):
    """kwargs of `conv_epilogue` for an output of shape xs with one noise
    value a phase (nc = 4): "s" out_scale, "n" noise, "b" bias + lrelu,
    each "p" a post-add, "2" the second noise / bias / lrelu stage."""
    b, h, w, c = xs
    kw = {"act": "b" in pieces}
    if "s" in pieces:
        kw["out_scale"] = rand(b, c, scale=0.2, offset=1.0).to(dt)
    if "n" in pieces:
        kw["noise"] = rand(b, h, w, 4, scale=0.3).to(dt)
    if "b" in pieces:
        kw["bias"] = rand(c, scale=0.3).to(dt)
    if "p" in pieces:
        kw["post_add"] = tuple(rand(*xs).to(dt)
                               for _ in range(pieces.count("p")))
    if "2" in pieces:
        kw.update(noise2=rand(b, h, w, 4, scale=0.3).to(dt),
                  bias2=rand(c, scale=0.3).to(dt), act2=True)
    return kw


# (x shape, pieces, label) of K6 with nc = 4 on the packed path: a styled
# conv's epilogue, the RestoreNet up-conv's with its two skips, the SMART
# tail's two stages
NC4_K6_CASES = (((4, 512, 512, 128), "snb", "styled 1024px C32 packed"),
                ((4, 256, 256, 256), "snbpp",
                 "chain: up-conv, 2 skips, 512px packed"),
                ((4, 256, 256, 256), "b2", "chain: SMART tail 512px packed"))
# (x shape, unpacked w shape, pieces, label) of K1e with nc = 4
NC4_K1E_CASES = (((4, 512, 512, 128), (3, 3, 32, 32), "snb",
                  "styled 1024px C32 packed"),
                 ((4, 256, 256, 256), (3, 3, 64, 64), "b2",
                  "SMART fusion 512px C64 packed +stage2"))
# the grouped K2 of the packed SMART: x, Cb, dilations on the half grid
GROUPED_K2 = ((4, 256, 256, 256), 16, (2, 4),
              "SMART d4+d8 512px C64 packed")


def _packed_kernel_rows(rows, rand, dt_name, dt):
    """(a) K1 at the assembled shapes, K1e, K6 with nc = 4 and the grouped
    K2 against their plain versions: error, CUDA-event medians of the
    kernel, the plain version and the library's call (cuDNN for K1; for
    K2 the composition of cuDNN's grouped dilated convs + the
    concatenation), the bound."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.cli.profile import copies, device_ms, k6_work
    from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc

    def f32(kw):
        return {k: (tuple(t.float() for t in v) if k == "post_add" else
                    v.float() if torch_is_tensor(v) else v)
                for k, v in kw.items()}

    for label, xs, ws, form in _packed_conv_cases():
        x = rand(*xs).to(dt)
        w, pads = _packed_weight(rand, dt, ws, form)
        s = rand(xs[0], xs[3], scale=0.2, offset=1.0).to(dt)
        got = ops.dense_conv(x, w, pads, in_scale=s)
        ref = ops.dense_conv_plain(x.float(), w.float(), pads, s.float())
        ms = cuda_ms(lambda: ops.dense_conv(x, w, pads, in_scale=s))
        pms = cuda_ms(lambda: ops.dense_conv_plain(x, w, pads, s))
        xs_ = x * s[:, None, None, :]
        lms = cuda_ms(lambda: conv_nhwc(xs_, w, 1, pads))
        _check("dense_conv", label, dt_name, got, ref, ms, pms, rows,
               flops=conv_flops(x.shape, w.shape, got.shape) + x.numel(),
               moved=nbytes(x, w, s, got), library_ms=lms,
               assembled=tuple(w.shape))
        del x, w, s, got, ref, xs_
    for xs, ws, pieces, label in NC4_K1E_CASES:
        x = rand(*xs).to(dt)
        w, pads = _packed_weight(rand, dt, ws, "s1")
        b, h, wd, c = xs
        kw = _nc4_operands(rand, dt, (b, h, wd, w.shape[3]), pieces)
        if "s" in pieces:
            kw["in_scale"] = rand(b, c, scale=0.2, offset=1.0).to(dt)
        before = ops.form_counts()["dense_conv_epilogue_nc4"]
        got = ops.dense_conv_epilogue(x, w, pads, **kw)
        if ops.form_counts()["dense_conv_epilogue_nc4"] != before + 1:
            raise AssertionError(f"K1e nc4 {label}: not one launch")
        ref = ops.dense_conv_epilogue_plain(x.float(), w.float(), pads,
                                            **f32(kw))
        ms = cuda_ms(lambda: ops.dense_conv_epilogue(x, w, pads, **kw))
        pms = cuda_ms(lambda: ops.dense_conv_epilogue_plain(x, w, pads,
                                                            **kw))
        isc = kw.get("in_scale")
        xs_ = x if isc is None else x * isc[:, None, None, :]
        cms = cuda_ms(lambda: conv_nhwc(xs_, w, 1, pads))
        flops, moved = epi_work(x, w, kw, got)
        _check("dense_conv_epilogue_nc4", label, dt_name, got, ref, ms, pms,
               rows, flops=flops, moved=moved, cudnn_conv_ms=cms)
        del x, w, kw, got, ref, xs_
    for xs, pieces, label in NC4_K6_CASES:
        x = rand(*xs).to(dt)
        kw = _nc4_operands(rand, dt, xs, pieces)
        before = ops.form_counts()["conv_epilogue_nc4"]
        got = ops.conv_epilogue(x, **kw)
        if ops.form_counts()["conv_epilogue_nc4"] != before + 1:
            raise AssertionError(f"K6 nc4 {label}: not one launch")
        ref = ops.epilogue_plain_chain(x.float(), **f32(kw))
        ms = cuda_ms(lambda: ops.conv_epilogue(x, **kw))
        flops, moved = k6_work(x, kw)

        def k6_call(xs=xs, pieces=pieces):
            x2 = rand(*xs).to(dt)
            kw2 = _nc4_operands(rand, dt, xs, pieces)
            return lambda: ops.conv_epilogue(x2, **kw2)
        dms = device_ms(copies(k6_call, moved))
        pms = cuda_ms(lambda: ops.epilogue_plain_chain(x, **kw))
        _check("conv_epilogue_nc4", label, dt_name, got, ref, ms, pms, rows,
               flops=flops, moved=moved, device_ms=dms)
        del x, kw, got, ref
    xs, cb, dils, label = GROUPED_K2
    cg = xs[3] // 4
    x = rand(*xs).to(dt)
    wl = [(rand(3, 3, cg, cb) / (9 * cg) ** 0.5).to(dt) for _ in dils]
    s = rand(xs[0], xs[3], scale=0.2, offset=1.0).to(dt)
    o = rand(xs[0], 4 * cb * len(dils), scale=0.2, offset=1.0).to(dt)
    before = ops.form_counts()["dilated_multi_conv_grouped"]
    got = ops.dilated_multi_conv(x, wl, dils, groups=4, in_scale=s,
                                 out_scale=o)
    if ops.form_counts()["dilated_multi_conv_grouped"] != before + 1:
        raise AssertionError("grouped K2: not one launch")
    ref = ops.dilated_multi_conv_plain(x.float(), [w.float() for w in wl],
                                       dils, s.float(), o.float(), groups=4)
    ms = cuda_ms(lambda: ops.dilated_multi_conv(x, wl, dils, groups=4,
                                                in_scale=s, out_scale=o))
    pms = cuda_ms(lambda: ops.dilated_multi_conv_plain(x, wl, dils, s, o,
                                                       groups=4))
    # no one library call computes it: cuDNN's grouped dilated convs (the
    # shared weights tiled over the groups) on x * in_scale and the
    # concatenation stand beside it
    xs_ = x * s[:, None, None, :]
    tiled = [torch.cat([w] * 4, dim=-1) for w in wl]
    cms = cuda_ms(lambda: torch.cat(
        [conv_nhwc(xs_, w, 1, ((d, d), (d, d)), dilation=d, groups=4)
         for w, d in zip(tiled, dils)], dim=-1))
    _check("dilated_multi_conv_grouped", label, dt_name, got, ref, ms, pms,
           rows, flops=2 * got.numel() * 9 * cg,
           moved=nbytes(x, *wl, s, o, got), composition_ms=cms)
    say(f"{'':20s} {label:28s} {dt_name:4s} cuDNN grouped dilated convs + "
        f"cat (composition) {cms:.4f} ms")
    del x, wl, s, o, got, ref, xs_, tiled


def _packed_grads(rows, rand, dt_name, dt):
    """The new forms' gradients against plain autograd: the grouped K2
    Function (dx, both shared weights, d_in_scale, d_out_scale), K6 and
    K1e with nc = 4 (every operand; the elements within 1e-5 of an
    activation's kink get no incoming gradient), and K6's double backward
    with nc = 4 noise (R1's pattern through the SMART tail's chain)."""
    import torch

    from vspbfr_tpu_torch import ops

    xs, cb, dils, label = GROUPED_K2
    cg = xs[3] // 4
    leaves = [rand(*xs).to(dt)]
    leaves += [(rand(3, 3, cg, cb) / (9 * cg) ** 0.5).to(dt) for _ in dils]
    leaves += [rand(xs[0], xs[3], scale=0.2, offset=1.0).to(dt),
               rand(xs[0], 4 * cb * len(dils), scale=0.2, offset=1.0).to(dt)]
    for t in leaves:
        t.requires_grad_()

    def k2(x, w4, w8, s, o, fn=ops.dilated_multi_conv):
        return fn(x, [w4, w8], dils, in_scale=s, out_scale=o, groups=4)

    def k2_plain(*a):
        return k2(*a, fn=ops.dilated_multi_conv_plain)

    g = rand(xs[0], xs[1], xs[2], 4 * cb * len(dils)).to(dt)
    got, ref, ms, pms = _grads_vs_plain(k2, k2_plain, leaves, g)
    # the timed backward: dx and dw, each the forward's multiply-adds
    work = dict(flops=2 * 2 * g.numel() * 9 * cg,
                moved=nbytes(*leaves, g, *leaves))
    for i, (name, a, b) in enumerate(zip(
            ("dx", "dw4", "dw8", "d_in_scale", "d_out_scale"), got, ref)):
        _check(f"dilated_multi_conv_grouped_grad {name}", label, dt_name, a,
               b, ms if i == 0 else float("nan"),
               pms if i == 0 else float("nan"), rows,
               **(work if i == 0 else {}))
    del leaves, g, got, ref

    xs, pieces, label = NC4_K6_CASES[2]
    x = rand(*xs).to(dt)
    kw = _nc4_operands(rand, dt, xs, pieces)
    flags = {k: kw.pop(k) for k in ("act", "act2")}
    names = list(kw)
    leaves = [x, *kw.values()]
    for t in leaves:
        t.requires_grad_()

    def k6(x_, *o, fn=ops.conv_epilogue):
        return fn(x_, **dict(zip(names, o)), **flags)

    def k6_plain(*a):
        return k6(*a, fn=ops.epilogue_plain_chain)

    # the pre-activations of both stages, from the plain chain in f32
    u = ops.epilogue_plain(x.detach().float(),
                           bias=kw["bias"].detach().float(), act=False)
    keep = _kink_keep(u) & _kink_keep(ops.epilogue_plain_chain(
        u, act=True, noise2=kw["noise2"].detach().float(),
        bias2=kw["bias2"].detach().float()))
    g = (rand(*xs) * keep).to(dt)
    got, ref, ms, pms = _grads_vs_plain(k6, k6_plain, leaves, g)
    # the timed backward reads g and y (or x) and writes dx
    work = dict(flops=2 * x.numel(), moved=nbytes(g, x, x))
    for i, (name, a, b) in enumerate(zip(["dx", *names], got, ref)):
        _check(f"conv_epilogue_nc4_grad {name}", label, dt_name, a, b,
               ms if i == 0 else float("nan"),
               pms if i == 0 else float("nan"), rows,
               kink_share=1.0 - float(keep.float().mean()),
               **(work if i == 0 else {}))
    del x, kw, leaves, g, got, ref, u, keep

    def r1(fn, x_, b_, **kw_):
        x_ = x_.detach().requires_grad_()
        b_ = b_.detach().requires_grad_()
        (gx,) = torch.autograd.grad((fn(x_, bias=b_, **kw_).float() ** 2)
                                    .sum(), x_, create_graph=True)
        return torch.autograd.grad((gx.float() ** 2).sum(), b_)[0]

    x, bias = rand(*xs).to(dt), rand(xs[3], scale=0.3).to(dt)
    tail = dict(noise2=rand(*xs[:3], 4, scale=0.3).to(dt),
                bias2=rand(xs[3], scale=0.3).to(dt), act2=True)
    tail32 = {k: (v.float() if torch_is_tensor(v) else v)
              for k, v in tail.items()}
    got = r1(ops.conv_epilogue, x, bias, **tail)
    ref = r1(ops.epilogue_plain_chain, x.float(), bias.float(), **tail32)
    ms = cuda_ms(lambda: r1(ops.conv_epilogue, x, bias, **tail), iters=5)
    pms = cuda_ms(lambda: r1(ops.epilogue_plain_chain, x, bias, **tail),
                  iters=5)
    _check("conv_epilogue_nc4_grad r1 d_bias", label, dt_name, got, ref, ms,
           pms, rows)
    del x, bias, tail, got, ref

    xs, ws, pieces, label = NC4_K1E_CASES[0]
    x = rand(*xs).to(dt)
    w, pads = _packed_weight(rand, dt, ws, "s1")
    b, h, wd, c = xs
    kw = _nc4_operands(rand, dt, (b, h, wd, w.shape[3]), pieces)
    kw["in_scale"] = rand(b, c, scale=0.2, offset=1.0).to(dt)
    flags = {k: kw.pop(k) for k in ("act",)}
    names = list(kw)
    leaves = [x, w, *kw.values()]
    for t in leaves:
        t.requires_grad_()
    keep = kink_free(x.detach(), w.detach(), pads,
                     {**{k: v.detach() for k, v in kw.items()}, **flags})

    def k1e(x_, w_, *o, fn=ops.dense_conv_epilogue, dt_=dt):
        kw_ = dict(zip(names, o))
        if fn is not ops.dense_conv_epilogue:   # round x * in_scale as K1e
            x_ = scaled_input(x_, kw_.pop("in_scale"), dt_)
        return fn(x_, w_, pads, **kw_, **flags)

    def k1e_plain(*a):
        return k1e(*a, fn=ops.dense_conv_epilogue_plain)

    g = (rand(b, h, wd, w.shape[3]) * keep).to(dt)
    flops, moved = epi_work(x, w, {**kw, **flags}, g)
    got, ref, ms, pms = _grads_vs_plain(k1e, k1e_plain, leaves, g)
    # the timed backward: dx and dw, each a conv of the forward's size,
    # plus the epilogue's elementwise work again
    work = dict(flops=2 * flops, moved=2 * moved)
    for i, (name, a, b_) in enumerate(zip(["dx", "dw", *names], got, ref)):
        _check(f"dense_conv_epilogue_nc4_grad {name}", label, dt_name, a, b_,
               ms if i == 0 else float("nan"),
               pms if i == 0 else float("nan"), rows,
               kink_share=1.0 - float(keep.float().mean()),
               **(work if i == 0 else {}))
    del x, w, kw, leaves, g, got, ref, keep


def _noise_maps(shapes, seed, device):
    """Seeded N(0, 1) maps of the given shapes (explicit noise: both
    layouts read the same values)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=device) for s in shapes]


def _serving_gate(name, got, ref, gate: bool = True) -> dict:
    """mean |err| and max |err| relative to ref's range; with `gate`, the
    serving gate (mean <= 1e-3, max <= 1e-2) raises."""
    import torch

    got, ref = got.float().cpu(), ref.float().cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite")
    span = float(ref.max() - ref.min())
    err = (got - ref).abs()
    out = dict(range=span, mean_rel=float(err.mean()) / span,
               max_rel=float(err.max()) / span)
    say(f"{name}: range {span:.4f} mean|err|/range {out['mean_rel']:.3e} "
        f"max|err|/range {out['max_rel']:.3e}")
    if gate and (out["mean_rel"] > 1e-3 or out["max_rel"] > 1e-2):
        raise AssertionError(f"{name}: out of the serving gate")
    return out


def _packed_launches(fn) -> dict:
    """Every kernel's and form's launches during fn() (counts set to 0
    just before)."""
    from vspbfr_tpu_torch import ops

    ops.reset_launch_counts()
    fn()
    return {**ops.launch_counts(), **ops.form_counts()}


def _packed_serving(res):
    """(b) Phase 5's seeded full-width modules (noise gains set to 0.1, so
    that the noise paths count) at packed_min_res 512 against the same
    weights at 0 on 4 faces with explicit equal noise, f32 and bf16, under
    the serving gate; launches and peak memory; `restore` in turns, 0,
    512, 512, 0, with the `upto=` split; the switch on (K1e with nc = 4)."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    base = SEEDED.get("pipe")
    if base is None:
        base = RestorationPipeline().init_from_seed(0).eval()
    sd = {k: torch.full_like(v, 0.1) if k.endswith("noise.weight") else v
          for k, v in base.state_dict().items()}
    faces = SEEDED.get("faces")
    if faces is None:
        faces = synthetic_faces(4, 512, seed=5)
    low = torch.tensor(faces[:4], device="cuda")
    draws = _draws(base, 4, 15, "cuda")
    draws["decoder_noise"] = _noise_maps(
        base.psp.decoder.noise_shapes(4), 16, "cuda")
    draws["noise"] = _noise_maps(base.generator.noise_shapes(4), 17, "cuda")
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        pipes = {}
        for pmr in (0, PACKED_PMR):
            p = RestorationPipeline(compute_dtype=dt, packed_min_res=pmr)
            p.load_state_dict(sd)
            pipes[pmr] = p.cuda().eval().prepare_params()

        def run(pmr, upto="full", sample=True):
            return pipes[pmr].restore(
                low, torch.Generator(device="cuda").manual_seed(0),
                upto=upto, return_sample=sample and upto == "full",
                draws=draws)

        torch.cuda.reset_peak_memory_stats()
        counts = _packed_launches(lambda: run(PACKED_PMR))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        missing = [k for k in PATH_KERNELS["packed"] if counts[k] == 0]
        if missing:
            raise AssertionError(f"packed serve {mode}: kernels never "
                                 f"launched: {missing}")
        outs = dict(zip(("restored", "sample"), zip(run(PACKED_PMR),
                                                     run(0))))
        if dt is None:
            # f32: the serving gate, 512 against 0; kept as bf16's reference
            ref32 = {k: v[1].float().cpu() for k, v in outs.items()}
            gates = {k: _serving_gate(f"packed serve f32 {k} 512 vs 0", *v)
                     for k, v in outs.items()}
        else:
            # bf16: two bf16 roundings of the same sums disagree by more
            # than the serving gate, whatever the layout, at these random
            # weights (bf16 against f32 is ~25-35 dB PSNR); so each layout
            # is held to the f32 output at 0, and 512 must be as close to
            # it as 0 is (within 1.5x, mean and max); 512 against 0 in
            # bf16 is reported
            gates = {}
            for k, (pk_, flat_) in outs.items():
                e512 = _serving_gate(f"packed serve bf16 {k} 512 vs f32 0",
                                     pk_, ref32[k], gate=False)
                e0 = _serving_gate(f"packed serve bf16 {k} 0 vs f32 0",
                                   flat_, ref32[k], gate=False)
                gates[k] = dict(vs_f32_512=e512, vs_f32_0=e0,
                                vs_bf16_0=_serving_gate(
                                    f"packed serve bf16 {k} 512 vs 0",
                                    pk_, flat_, gate=False))
                if (e512["mean_rel"] > 1.5 * e0["mean_rel"]
                        or e512["max_rel"] > 1.5 * e0["max_rel"]):
                    raise AssertionError(f"packed serve bf16 {k}: 512 "
                                         "further from f32 than 0 is")
        del outs
        turns = {0: [], PACKED_PMR: []}
        for pmr in (0, PACKED_PMR, PACKED_PMR, 0):
            turns[pmr].append(cuda_ms(lambda: run(pmr), iters=3, warmup=1))
        split = {}
        for pmr in (0, PACKED_PMR):
            ms = {u: cuda_ms(lambda: run(pmr, u), iters=3, warmup=1)
                  for u in ("encode", "ddpm", "decode", "full")}
            split[pmr] = {"encode": ms["encode"],
                          "ddpm": ms["ddpm"] - ms["encode"],
                          "decode": ms["decode"] - ms["ddpm"],
                          "restore": ms["full"] - ms["decode"]}
        with fused_epi("1"):
            fused = _packed_launches(lambda: run(PACKED_PMR))
        missing = [k for k in PATH_KERNELS["packed_fused"] if fused[k] == 0]
        if missing:
            raise AssertionError(f"packed serve {mode}, switch on: kernels "
                                 f"never launched: {missing}")
        med = {pmr: statistics.median(v) for pmr, v in turns.items()}
        say(f"packed serve {mode} b4 with the sample image (ms, medians of 3 "
            f"in turns 0, 512, 512, 0): pmr 0 {turns[0]}, pmr 512 "
            f"{turns[PACKED_PMR]}; imgs/s {4e3 / med[0]:.3f} / "
            f"{4e3 / med[PACKED_PMR]:.3f}; split (medians of 3) " + "; ".join(
                f"pmr {pmr}: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           sp.items())
                for pmr, sp in split.items())
            + f"; peak {peak:.3f} GiB; launches {counts}; switch on "
            f"{fused}")
        res[mode] = dict(launches=counts, fused_launches=fused,
                         peak_gib=peak, gates=gates,
                         turns_ms={str(k): v for k, v in turns.items()},
                         imgs_per_s={str(k): 4e3 / v for k, v in med.items()},
                         split_ms={str(k): v for k, v in split.items()})
        del pipes
        torch.cuda.empty_cache()


def _packed_card_vs_cpu(res):
    """(c) Phase 4's mid-size config at packed_min_res 64 (half its size),
    card (kernels) against CPU (plain versions), same weights, draws and
    explicit noise (gains 0.1)."""
    import torch

    from vspbfr_tpu_torch.models.e4e import TINY_STAGES
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    cfg = dict(size=128, decoder_size=256, encode_size=64,
               encoder_stages=TINY_STAGES, channel_div=4, packed_min_res=64)
    cpu = RestorationPipeline(**cfg).init_from_seed(1).eval()
    _condition_diffuser(cpu)
    with torch.no_grad():
        for k, v in cpu.named_parameters():
            if k.endswith("noise.weight"):
                v.fill_(0.1)
    card = RestorationPipeline(**cfg)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    low = torch.tensor(synthetic_faces(1, 128, seed=2))
    noise = {"decoder_noise": _noise_maps(
        cpu.psp.decoder.noise_shapes(1), 18, "cpu"),
        "noise": _noise_maps(cpu.generator.noise_shapes(1), 19, "cpu")}

    def draws(device):
        d = _draws(cpu, 1, 3, device)
        d.update({k: [t.to(device) for t in v] for k, v in noise.items()})
        return d

    outs = {}
    counts = _packed_launches(lambda: outs.update(card=card.restore(
        low.cuda(), None, return_sample=True, draws=draws("cuda"))))
    outs["cpu"] = cpu.restore(low, None, return_sample=True,
                              draws=draws("cpu"))
    gates = {name: _serving_gate(f"packed slice {name} card vs CPU",
                                 g, c)
             for name, g, c in zip(("restored", "sample"), outs["card"],
                                   outs["cpu"])}
    missing = [k for k in PATH_KERNELS["packed"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"packed slice: kernels never launched: "
                             f"{missing}")
    say(f"packed slice (size 128, decoder 256, channel_div 4, pmr 64, b1): "
        f"launches {counts}")
    res["slice"] = dict(launches=counts, gates=gates)


def _packed_cli(res, key, module, flags, kernels, losses, tmp):
    """(d) One trainer CLI at --packed_min_res 512 in its own process
    (`NO_CV_TRAIN`): the path's kernels and forms must launch, no plain K6
    / K7 may run on the card, every loss must be finite; step medians,
    peak memory, launches and the backward calls of the kernels'
    Functions."""
    out = os.path.join(tmp, key)
    proc = subprocess.run(
        [sys.executable, "-c", NO_CV_TRAIN, module, out + ".json",
         "--out", out, "--device", "cuda", "--seed", "0", "--iter", "3",
         "--train_dtype", "bf16", "--save_inter", "100000",
         "--show_inter", "100000", "--packed_min_res", str(PACKED_PMR),
         *flags],
        cwd=HERE, capture_output=True, text=True, timeout=HOSTDATA_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"packed {key}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out + ".json") as f:
        rec = json.load(f)
    steps = rec["report"]["steps"]
    if len(steps) != 3 or not all(np.isfinite(s[k]) for s in steps
                                  for k in losses):
        raise AssertionError(f"packed {key}: steps {steps}")
    if "r1" in losses and not steps[0]["r1"] > 0:
        raise AssertionError(f"packed {key}: no R1 at step 0")
    counts = {**rec["launches"], **rec["forms"]}
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"packed {key}: kernels never launched "
                             f"{missing}")
    if any(rec["plain"].values()):
        raise AssertionError(f"packed {key}: a plain version ran on the "
                             f"card: {rec['plain']}")
    secs = [s["seconds"] for s in steps]
    med = statistics.median(secs[1:])
    res[key] = dict(step_seconds=secs, median_step_ms=med * 1e3,
                    launches=counts, backward_calls=rec["backwards"],
                    peak_gib=rec["peak_gib"], losses=steps)
    say(f"packed {key}: step seconds {[round(x, 4) for x in secs]}, median "
        f"(first excluded) {med * 1e3:.1f} ms; peak {rec['peak_gib']:.3f} "
        f"GiB; launches {counts}; backward calls {rec['backwards']}")


def phase_packed():
    """The space-to-depth layout at packed_min_res 512 (the JAX CLIs'
    default): (a) the new kernel forms and K1 at the assembled shapes
    against plain, with their gradients; (b) serving, 512 against 0; (c)
    the card against the CPU at the mid-size config; (d) both trainer
    CLIs at --packed_min_res 512."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)

    def rand(*shape, scale=1.0, offset=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + offset

    res = {"kernels": []}
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        _packed_kernel_rows(res["kernels"], rand, dt_name, dt)
        torch.cuda.empty_cache()
        _packed_grads(res["kernels"], rand, dt_name, dt)
        torch.cuda.empty_cache()
    res["serve"] = {}
    # (b)-(d) are the main paths: no plain K6 / K7 on the card there ((a)
    # calls the plain versions on purpose, as phases 3 and 6 do)
    with no_plain_on_card("packed"), tempfile.TemporaryDirectory() as tmp:
        _packed_serving(res["serve"])
        _packed_card_vs_cpu(res)
        faces512 = os.path.join(tmp, "faces512")
        _face_dir(faces512, 8, 512, seed=14)
        faces256 = os.path.join(tmp, "faces256")
        _face_dir(faces256, 16, 256, seed=15)
        _packed_cli(res, "stage3", "train_restore",
                    ["--path", faces512, "--size", "512", "--decoder_size",
                     "1024", "--batch", "4"], PATH_KERNELS["packed_restore"],
                    ("d", "r1", "real_score", "fake_score", "g", "gan",
                     "percept", "id"), tmp)
        _packed_cli(res, "stage2", "train_diffuser",
                    ["--path", faces256, "--size", "256", "--decoder_size",
                     "1024", "--batch", "16"], PATH_KERNELS["packed_train"],
                    ("loss", "l1", "kl", "percept", "id"), tmp)
    for key, phase in (("stage3", "restore"), ("stage2", "train")):
        unpacked = REPORT.get(phase, {}).get("bf16", {}).get("median_step_ms")
        res[key]["unpacked_median_step_ms"] = unpacked
        say(f"packed {key} bf16 median step {res[key]['median_step_ms']:.1f}"
            f" ms at 512, beside phase {phase}'s bf16 at 0: {unpacked}")
    REPORT["packed"] = res


# --- phase 16 ---------------------------------------------------------------

MESH_BATCH = 2          # the serving stages' batch, (a)-(d)
MESH_STAGE2_BATCH = 8   # stage 2's batch, (e): each rank of the 1 x 2
#                         mesh computes all of it (two f32 steps share
#                         the card)
MESH_TIMEOUT = 420      # seconds the phase-16 ranks may take
# the kernels the sharded paths launch: the serving stages, stage 2
MESH_KERNELS = {"serve": ("dense_conv", "dilated_multi_conv", "d2s",
                          "conv_epilogue", "fused_leaky_relu"),
                # the decoder alone has no K7 (its mapping MLP is not run)
                "decode": ("dense_conv", "d2s", "conv_epilogue"),
                "grads": ("dense_conv", "d2s", "s2d", "conv_epilogue"),
                "train": ("dense_conv", "d2s", "s2d", "conv_epilogue",
                          "fused_leaky_relu")}
SHOWN = ("dense_conv", "dilated_multi_conv", "d2s", "conv_epilogue",
         "fused_leaky_relu")


def _mesh_inputs(pipe, device):
    """Phase 16's seeded codes (B, 18, 512), degraded faces at 512 px and
    noise latent (B, 16, 512)."""
    import torch

    rng = np.random.default_rng(16)
    codes = rng.standard_normal((MESH_BATCH, pipe.psp.n_latent, 512))
    lat = rng.standard_normal((MESH_BATCH, pipe.generator.n_latent, 512))
    low = synthetic_faces(MESH_BATCH, 512, seed=16)
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (codes, low, lat)]


@contextlib.contextmanager
def _counted(name: str, rec: dict):
    """The block's kernel launches and plain K6 / K7 calls on CUDA tensors
    (both set to 0 just before) into rec[name]; a plain call raises."""
    import torch

    from vspbfr_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.reset_plain_cuda_calls()
    yield
    torch.cuda.synchronize()
    rec[name] = dict(launches=ops.launch_counts(), forms=ops.form_counts(),
                     plain=ops.plain_cuda_calls())
    if any(rec[name]["plain"].values()):
        raise AssertionError(f"mesh2d {name}: a plain version ran on the "
                             f"card: {rec[name]['plain']}")


def _mesh_pipelines(state, packed_min_res: int = 0):
    """The seeded full-width pipeline in f32 and bf16 (noise gains 0.1) on
    the card, from its state_dict, at packed_min_res (the parameters are
    the same in either layout)."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    pipes = {}
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        p = RestorationPipeline(compute_dtype=dt,
                                packed_min_res=packed_min_res)
        p.load_state_dict(state)
        pipes[mode] = p.cuda().eval().prepare_params()
    return pipes


def _mesh_serving(pipes, sp, counts) -> dict:
    """(a)-(c) on the pipelines, H-sharded under `sp` (None: the lone
    run), f32 and bf16: the decode stage (pooled image, feature taps),
    RestoreNet's stage on the decode's features, `restore` end to end with
    the sample image; outputs whole, on the host; peak memory a dtype."""
    import torch

    out = {}
    for mode, p in pipes.items():
        dt = p.compute_dtype or torch.float32
        codes, low, lat = _mesh_inputs(p, "cuda")
        torch.cuda.reset_peak_memory_stats()

        def gen(seed):
            return torch.Generator(device="cuda").manual_seed(seed)

        def whole(t):
            return (sp.gather(t) if sp is not None else t).float().cpu()

        with torch.no_grad():
            with _counted(f"decode {mode}", counts):
                img, feats = p.psp.decode_with_feats(
                    codes.to(dt), generator=gen(3), spatial=sp)
            with _counted(f"restore stage {mode}", counts):
                stage = p.generator(low.to(dt), feats, codes.to(dt),
                                    lat.to(dt), input_is_latent=True,
                                    generator=gen(6), spatial=sp)
        with _counted(f"restore {mode}", counts):
            restored, sample = p.restore(low, gen(7), return_sample=True,
                                         spatial=sp)
        out[mode] = dict(image=whole(img), feats=[whole(f) for f in feats],
                         stage=whole(stage), restored=restored.float().cpu(),
                         sample=sample.float().cpu(),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _decoder_grads(pipe, mesh) -> dict:
    """(d) The decoder (f32, TF32 off, cuDNN's deterministic algorithms)
    on phase 16's codes with explicit noise: the image and the gradients of
    mean(image^2) by parameter name, whole; with `mesh` model-sharded
    (`shard_module`: the gathers in the forward, each rank's slice of the
    gradient gathered back here for the comparison)."""
    import copy

    import torch

    from vspbfr_tpu_torch.parallel.model_axis import (model_axis,
                                                      parameters_in_order,
                                                      shard_module,
                                                      sharded_names)

    dec = copy.deepcopy(pipe.psp.decoder).requires_grad_(True)
    if mesh is not None:
        shard_module(dec, mesh)
    codes = _mesh_inputs(pipe, "cuda")[0]
    noise = _noise_maps(dec.noise_shapes(MESH_BATCH), 18, "cuda")
    with cudnn_deterministic():
        img, _ = dec(codes, noise=noise)
        img.square().mean().backward()
    names = (dec._model_axis["names"] if mesh is not None
             else [n for n, _ in dec.named_parameters()])
    sharded = set(sharded_names(dec))
    grads = {}
    for n, p in zip(names, parameters_in_order(dec)):
        grads[n] = (model_axis(dec).gather(p.grad) if n in sharded
                    else p.grad).cpu()
    return dict(image=img.detach().cpu(), grads=grads,
                sharded=sorted(sharded))


@contextlib.contextmanager
def _adam_grads(state, names, record):
    """Record into `record` (name -> tensor) the gradients Adam takes in
    `state`'s next update (reduced over the data axis, before the step);
    `names` in the optimizer's parameter order."""
    def hook(opt, *_):
        params = opt.param_groups[0]["params"]
        record.update({n: p.grad.clone() for n, p in zip(names, params)})

    handle = state.opt.register_step_pre_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@contextlib.contextmanager
def _whole_images(tr, record: list | None = None, keep: int = 1,
                  subs: list | None = None):
    """The whole images a training step of `tr` hands its whole-image nets
    (a stage-2 trainer: `_decode`'s, to LPIPS and ID; a stage-3 one:
    `generate`'s, to D, ADA, LPIPS and ID), while the block runs: the
    first `keep` appended to `record` (one a call: stage 3 makes two a
    step, D's and G's, and a stage-2 step one, whose rematerialised
    recompute is its second call), or, with `subs`, replaced in call order
    by those images: the value the substitute's, the gradient passed
    unchanged into tr's own decode. On a mesh the images are gathered
    whole, so the lone step can take the ranks' and run the whole-image
    nets on the same values."""
    import torch

    class Substitute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, out, sub):
            return sub.clone()

        @staticmethod
        def backward(ctx, g):
            return g, None

    name = "_decode" if hasattr(tr, "_decode") else "generate"
    method = getattr(tr, name)
    calls = [0]

    def wrapped(*args, **kw):
        out = method(*args, **kw)
        i = calls[0]
        calls[0] += 1
        if record is not None and len(record) < keep:
            record.append(out.detach().clone())
        if subs is not None:
            out = Substitute.apply(out, subs[i % len(subs)])
        return out

    setattr(tr, name, wrapped)
    try:
        yield
    finally:
        delattr(tr, name)


def _moment_bytes(tr) -> int:
    return sum(v.numel() * v.element_size()
               for st in tr.state.opt.state.values()
               for k, v in st.items() if k != "step")


def _mesh_rank(out, state_file):
    """One rank of phase 16 (`--rank mesh2d OUT STATE`), on the 1 data x 2
    model mesh: (a)-(c) H-sharded, (d) the model-sharded decoder, (g)
    (a)-(c) at packed_min_res 512 and its traps, (e) one model-sharded
    stage-2 step; rank 0 writes the whole outputs to
    OUT.tensors.pt, every rank its launches, plain calls, peak memory and
    Adam's bytes to OUT.<rank>.json."""
    import torch

    from vspbfr_tpu_torch.parallel import (Spatial, create_mesh_2d,
                                           distributed)
    from vspbfr_tpu_torch.parallel.model_axis import model_axis, sharded_names

    rec = {"counts": {}}
    with distributed("cuda") as device:
        mesh = create_mesh_2d(1, 2)
        sp = Spatial.from_mesh(mesh)
        rank = torch.distributed.get_rank()
        state = torch.load(state_file, map_location="cpu", weights_only=True)
        pipes = _mesh_pipelines(state)
        t0 = time.perf_counter()
        tensors = {"serve": _mesh_serving(pipes, sp, rec["counts"])}
        rec["serve_s"] = time.perf_counter() - t0
        rec["exchanges"] = sp.exchanges
        rec["peak_gib"] = {k: v.pop("peak_gib")
                           for k, v in tensors["serve"].items()}
        torch.cuda.reset_peak_memory_stats()
        with _counted("decoder grads", rec["counts"]):
            tensors["decoder"] = _decoder_grads(pipes["f32"], mesh)
        rec["peak_gib"]["decoder"] = (torch.cuda.max_memory_allocated()
                                      / 2 ** 30)
        del pipes
        torch.cuda.empty_cache()
        tensors["packed"], rec["packed"] = _packed_mesh_serving(state, sp)
        del state
        torch.cuda.empty_cache()
        tr = _stage2_parallel_trainer(MESH_STAGE2_BATCH).to(device)
        tr.shard_model(mesh)
        low, real = (x[:MESH_STAGE2_BATCH]
                     for x in _stage2_parallel_batch(device))
        torch.cuda.reset_peak_memory_stats()
        grads, images = {}, []
        with _counted("stage2", rec["counts"]), cudnn_deterministic(), \
                _adam_grads(tr.state, tr.diffuser._model_axis["names"],
                            grads), _whole_images(tr, images):
            m = tr.train_step(low, real,
                              torch.Generator(device=device).manual_seed(13))
        tensors["stage2_image"] = images[0].cpu()
        rec["peak_gib"]["stage2"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["metrics"] = {k: float(v) for k, v in m.items()}
        rec["moment_bytes"] = _moment_bytes(tr)
        ck = tr.state.state_dict()      # collective: the whole tensors
        tensors["stage2"] = {k: v.cpu() for k, v in ck["params"].items()}
        # the gradients Adam took, whole (gathered in name order, on both
        # ranks)
        ax, sharded = model_axis(tr.diffuser), set(sharded_names(tr.diffuser))
        tensors["stage2_grads"] = {
            n: (ax.gather(g) if n in sharded else g).cpu()
            for n, g in grads.items()}
        if rank == 0:
            torch.save(tensors, f"{out}.tensors.pt")
    rec["plain_cuda_calls"] = {}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)


def _mesh_stage2_lone(res, ranks, tensors, grads, image, tr):
    """(e) The lone stage-2 step (trainer `tr`, made while the ranks run)
    at the same batch, draws and weights; at inputs moved by +-1e-6 for
    phase 7's loss gate (10 x that spread + 1e-5); twice more as it was
    (the step's own spread: the forward is bit-equal under cuDNN's
    deterministic algorithms, the backward is not); and once with the
    ranks' decoded image (`image`, whole) handed to LPIPS and ID in place
    of its own (`_whole_images`). The ranks decode on their rows, which
    rounds the image otherwise (up to 6e-7 of its range on an H100, phase
    16 (a)), and the whole-image nets grow that in the gradients they send
    back (there 1.2e-4 of a tensor's max against the plain lone step,
    whose repeat moves 4.6e-6), as they grow a +-1e-6 input change: so
    the gradients Adam took on the ranks (`grads`, whole) are held to that
    last lone step's, worst tensor relative to each one's max, within
    1e-5 + 10 x the larger of the repeats' spread and the distance the
    ranks' image alone moves the lone step (phase 17's gate, which its
    steps without a model-axis sum fail: such a sum moves a tensor by its
    own size); the plain lone step's distance is reported. The ranks'
    updated diffuser within 2.05 x lr_eff of the plain lone one's
    (`tests/test_sharding2d.py`'s envelope), with at most 5% of any
    tensor's elements apart by more than lr_eff (a first Adam step moves
    each by +-lr_eff, so only gradients near zero may change sign)."""
    import torch

    init = {k: v.clone() for k, v in tr.diffuser.state_dict().items()}
    low, real = (x[:MESH_STAGE2_BATCH] for x in _stage2_parallel_batch("cuda"))
    sub = [image.to("cuda")]
    runs = []
    lone_grads, again, at_image = {}, ({}, {}), {}
    torch.cuda.reset_peak_memory_stats()
    for i, f in enumerate((1.0, 1 + 1e-6, 1 - 1e-6, 1.0, 1.0, 1.0)):
        tr.diffuser.load_state_dict(init)
        tr.state.opt.state.clear()
        with cudnn_deterministic(), _adam_grads(
                tr.state, [n for n, _ in tr.diffuser.named_parameters()],
                {0: lone_grads, 3: again[0], 4: again[1],
                 5: at_image}.get(i, {})), \
                _whole_images(tr, subs=sub if i == 5 else None):
            m = tr.train_step(low * f, real,
                              torch.Generator(device="cuda").manual_seed(13))
        runs.append(({k: float(v) for k, v in m.items()},
                     {k: v.detach().cpu().clone()
                      for k, v in tr.diffuser.state_dict().items()},
                     _moment_bytes(tr)))
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (m1, p1, lone_bytes), *pert = runs[:3]
    gate = {}
    for k in m1:
        scale = max(abs(m1[k]), 1e-12)
        gate[k] = dict(
            rel_err=max(abs(r["metrics"][k] - m1[k]) for r in ranks) / scale,
            spread=max(abs(p[0][k] - m1[k]) for p in pert) / scale)
    bad = [k for k, v in gate.items()
           if not v["rel_err"] <= 10 * v["spread"] + 1e-5]
    lr_eff = tr.cfg.lr * tr.cfg.reg_every / (tr.cfg.reg_every + 1)
    worst = flips = 0.0
    for k, want in p1.items():
        d = (tensors[k] - want).abs()
        worst = max(worst, float(d.max()) / lr_eff)
        flips = max(flips, float((d > lr_eff).float().mean()))
    if set(grads) != set(lone_grads):
        raise AssertionError("mesh2d stage 2: the ranks' gradients name "
                             "other parameters than the lone step's")

    def worst_rel(got, want):
        """(worst |got - want| over want's max, its name)."""
        return max((float((got[k].cpu() - v.cpu()).abs().max())
                    / max(float(v.abs().max()), 1e-6), k)
                   for k, v in want.items())

    grad_worst, grad_worst_at = worst_rel(grads, at_image)
    grad_plain = worst_rel(grads, lone_grads)[0]
    image_moves = worst_rel(at_image, lone_grads)[0]
    grad_repeat = max(worst_rel(g, lone_grads)[0] for g in again)
    grad_limit = 1e-5 + 10 * max(grad_repeat, image_moves)
    res["stage2"] = dict(gate=gate, metrics=ranks[0]["metrics"], lone=m1,
                         grad_worst_rel=grad_worst,
                         grad_worst_at=grad_worst_at,
                         grad_vs_plain_lone_rel=grad_plain,
                         lone_at_ranks_image_vs_lone_rel=image_moves,
                         lone_grad_repeat_rel=grad_repeat,
                         grad_limit=grad_limit,
                         max_param_move_over_lr_eff=worst,
                         flip_share=flips,
                         moment_bytes=[r["moment_bytes"] for r in ranks],
                         lone_moment_bytes=lone_bytes,
                         peak_gib=[r["peak_gib"]["stage2"] for r in ranks],
                         lone_peak_gib=peak,
                         launches=ranks[0]["counts"]["stage2"]["launches"])
    say(f"mesh2d (e) stage 2 (256 px, 1024 px decoder, b{MESH_STAGE2_BATCH}, "
        f"f32) 1 x 2 `shard_model` (decode H-sharded) vs lone, rel err / "
        f"spread: "
        + ", ".join(f"{k} {v['rel_err']:.2e}/{v['spread']:.2e}"
                    for k, v in gate.items())
        + f"; Adam's gradients worst {grad_worst:.2e} of each one's max "
        f"against the lone step on the ranks' image ({grad_worst_at}), "
        f"gate {grad_limit:.2e} (the lone step repeated: "
        f"{grad_repeat:.2e}; the ranks' image alone moves it "
        f"{image_moves:.2e}); against the plain lone step "
        f"{grad_plain:.2e}; params max |diff| {worst:.3f} x lr_eff, "
        f"flips {flips:.4f}; Adam moments bytes per rank "
        f"{res['stage2']['moment_bytes']} vs lone {lone_bytes}; peak GiB "
        f"per rank {res['stage2']['peak_gib']} vs lone {peak:.3f}")
    if (bad or grad_worst > grad_limit or worst > 2.05 or flips > 0.05):
        raise AssertionError(f"mesh2d stage 2: out of the gate: {bad}, "
                             f"gradients {grad_worst:.2e} of max, moves "
                             f"{worst:.3f} x lr_eff, flips {flips}")
    if not all(b < lone_bytes for b in res["stage2"]["moment_bytes"]):
        raise AssertionError("mesh2d stage 2: Adam's moments not sharded")
    torch.cuda.empty_cache()


def _semipacked_rows(rows):
    """(f) `conv2d_semipacked` at (4, 512, 256, 128) (512 px C64 packed
    along the width), 3x3, dilation 1: K1 at the assembled kernel against
    its plain version (phase 3's tolerances), timed beside the unpacked K1
    and cuDNN at 512 px C64 and the 2x2-packed K1 at (4, 256, 256, 256);
    the semi-packed result also against the unpacked conv. The plain
    version is one cuDNN call on the assembled kernel, so it is also the
    library's time."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.ops import dense_conv, dense_conv_plain
    from vspbfr_tpu_torch.ops import packed as pk
    from vspbfr_tpu_torch.ops import semipacked as spk
    from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc

    gen = torch.Generator(device="cuda").manual_seed(161)
    xu32 = torch.randn((4, 512, 512, 64), generator=gen, device="cuda")
    w32 = torch.randn((3, 3, 64, 64), generator=gen, device="cuda") / 24.0
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xu, w = xu32.to(dt), w32.to(dt)
        x = spk.space_to_width(xu).contiguous()
        wp, padx = spk._assemble_x(w)
        wp = wp.contiguous()
        pads = ((1, 1), padx)
        ops.reset_launch_counts()
        got = spk.conv2d_semipacked(x, w)
        torch.cuda.synchronize()
        if ops.launch_counts()["dense_conv"] != 1:
            raise AssertionError("mesh2d (f): conv2d_semipacked did not "
                                 "launch K1")
        ref = dense_conv_plain(x, wp, pads)
        unpacked = conv_nhwc(xu, w, 1, ((1, 1), (1, 1)))
        vs_unpacked = float((spk.width_to_space(got).float()
                             - unpacked.float()).abs().max()
                            / unpacked.float().abs().max())
        xp = pk.space_to_depth(xu)
        wpk, ppy, ppx = pk.assembled_kernel(w, "s1")
        wpk = wpk.contiguous()
        ms = cuda_ms(lambda: dense_conv(x, wp, pads))
        call_ms = cuda_ms(lambda: spk.conv2d_semipacked(x, w))
        plain_ms = cuda_ms(lambda: dense_conv_plain(x, wp, pads))
        k1_ms = cuda_ms(lambda: dense_conv(xu, w, ((1, 1), (1, 1))))
        cudnn_ms = cuda_ms(lambda: conv_nhwc(xu, w, 1, ((1, 1), (1, 1))))
        packed_ms = cuda_ms(lambda: dense_conv(xp, wpk, (ppy, ppx)))
        # the bound: the work the function needs (the unpacked 3x3 conv's
        # multiply-adds; half the assembled kernel's taps are zeros) and
        # its own operands (x, w, the output); the assembled kernel's
        # figure beside it
        _check("dense_conv", "semi-packed 512px C64, 3x3 128 -> 128",
               dt_name, got, ref, ms, plain_ms, rows,
               flops=conv_flops(xu.shape, w.shape, unpacked.shape),
               moved=nbytes(x, w, got), library_ms=plain_ms,
               assembled_bound_ms=bound(
                   conv_flops(x.shape, wp.shape, got.shape),
                   nbytes(x, wp, got), dt_name)[0],
               call_ms=call_ms, unpacked_k1_ms=k1_ms,
               unpacked_cudnn_ms=cudnn_ms, packed_k1_ms=packed_ms,
               vs_unpacked_rel=vs_unpacked,
               kernel_shape=list(wp.shape))
        say(f"mesh2d (f) semi-packed {dt_name}: K1 at {tuple(wp.shape)} "
            f"{ms:.4f} ms (the call with its assembly {call_ms:.4f}); "
            f"unpacked K1 {k1_ms:.4f}, cuDNN {cudnn_ms:.4f}, 2x2-packed K1 "
            f"at {tuple(wpk.shape)} {packed_ms:.4f} ms; vs the unpacked "
            f"conv {vs_unpacked:.2e} of max")
        del x, xu, w, wp, got, ref, unpacked, xp, wpk
    torch.cuda.empty_cache()


def _features(feats) -> dict:
    """The decoder's feature taps by their resolution (4, 8, ... px: a
    packed tap's rows are half of it)."""
    return {f"feature {4 << i} px": f for i, f in enumerate(feats)}


def _mesh_gates(got, ref, label: str = "mesh2d") -> dict:
    """(a)-(c) against the lone run. f32: the serving gate. bf16: the
    RestoreNet stage leaves the lone run's bits at one cuDNN stride-2
    conv on a window's shape, by one bf16 ulp from bit-equal inputs
    (`_first_divergence` shows where on each run), and these random
    weights grow that to more than the serving gate, as any two bf16
    roundings of the same sums do (phase 15). So, as there, each bf16
    output is held to the lone f32 output, and the sharded one must be as
    close to it as the lone bf16 one is (within 1.5x, mean and max, +
    1e-6 of the range); bf16 sharded against bf16 lone is reported."""
    def outputs(run):
        named = {k: run[k] for k in ("image", "stage", "restored", "sample")}
        named.update(_features(run["feats"]))
        return named

    gates = {}
    f32 = outputs(ref["f32"])
    for key, g in outputs(got["f32"]).items():
        gates[f"{key} f32"] = _serving_gate(f"{label} 1x2 vs lone {key} f32",
                                            g, f32[key])
    lone16 = outputs(ref["bf16"])
    for key, g in outputs(got["bf16"]).items():
        e_sh = _serving_gate(f"{label} 1x2 bf16 vs lone f32 {key}", g,
                             f32[key], gate=False)
        e_lone = _serving_gate(f"{label} lone bf16 vs lone f32 {key}",
                               lone16[key], f32[key], gate=False)
        gates[f"{key} bf16"] = dict(
            vs_f32=e_sh, lone_vs_f32=e_lone,
            vs_lone_bf16=_serving_gate(f"{label} 1x2 vs lone {key} bf16", g,
                                       lone16[key], gate=False))
        for m in ("mean_rel", "max_rel"):
            if e_sh[m] > 1.5 * e_lone[m] + 1e-6:
                raise AssertionError(f"{label} {key} bf16: further from f32 "
                                     f"than the lone bf16 run ({m})")
    return gates


# (g) the packed layout on the mesh: the kernels each block must launch
# (the wrappers' counts here hold their unpacked forms only,
# `_packed_counts`), the planted faults of `_packed_trap`
PACKED_MESH_KERNELS = {
    "decode": ("dense_conv", "d2s", "conv_epilogue", "conv_epilogue_nc4"),
    "serve": ("dense_conv", "dilated_multi_conv",
              "dilated_multi_conv_grouped", "d2s", "s2d", "conv_epilogue",
              "conv_epilogue_nc4", "fused_leaky_relu")}
PACKED_SHOWN = PACKED_MESH_KERNELS["serve"]
PACKED_TRAPS = ("halo rows zero", "strips swapped")


def _packed_counts(c: dict) -> dict:
    """A `_counted` record's launches with the layout's forms apart: K2's
    and K6's own counts less their grouped / nc = 4 launches."""
    out = {**c["launches"], **c["forms"]}
    out["dilated_multi_conv"] -= out["dilated_multi_conv_grouped"]
    out["conv_epilogue"] -= out["conv_epilogue_nc4"]
    return out


@contextlib.contextmanager
def _packed_trap(name: str):
    """For the block, a fault in every window of a packed map on this
    rank's rows (`Spatial.window` with packed=True at a sharded
    resolution), as a copy with it would run: "halo rows zero" the
    exchange returns zero rows (the neighbours' strips zeros, the shard's
    own rows kept); "strips swapped" the window's top and bottom pads
    swapped: the counts (top, bottom) -> (bottom, top) and the strips,
    the rows from rank + 1 above the shard and those from rank - 1 below
    it (every packed window's pads are symmetric, (1, 1) or (4, 4), so
    the counts alone would change nothing)."""
    import torch

    from vspbfr_tpu_torch.parallel.spatial import Spatial

    own = Spatial.__dict__["window"]

    def window(self, x, top, bottom, packed=False):
        if not (packed and self.sharded(self.res_of(x, True))):
            return own(self, x, top, bottom, packed)
        if name == "halo rows zero":
            w = own(self, x, top, bottom, packed).clone()
            w[:, :top] = 0
            w[:, w.shape[1] - bottom:] = 0
            return w
        w = own(self, x, bottom, top, packed)
        n = w.shape[1]
        return torch.cat([w[:, n - top:], w[:, bottom:n - top],
                          w[:, :bottom]], dim=1)

    Spatial.window = window
    try:
        yield
    finally:
        Spatial.window = own


def _packed_mesh_serving(state, sp) -> tuple[dict, dict]:
    """(g) on this rank (`sp`) or, with sp None, the lone run: the
    pipelines at packed_min_res 512 from `state`; (a)-(c) in f32 and bf16
    (`_mesh_serving`, one dtype at a time: the halo exchanges a batch),
    then on the ranks the f32 run once with each `_packed_trap`. Returns
    the outputs (whole, on the host) and the record: launches per block,
    peak GiB and exchanges per dtype, seconds."""
    import torch

    pipes = _mesh_pipelines(state, PACKED_PMR)
    outs, rec = {}, {"counts": {}, "peak_gib": {}, "exchanges": {},
                     "seconds": {}}
    for mode, p in pipes.items():
        before = sp.exchanges if sp is not None else 0
        t0 = time.perf_counter()
        outs[mode] = _mesh_serving({mode: p}, sp, rec["counts"])[mode]
        rec["seconds"][mode] = time.perf_counter() - t0
        rec["peak_gib"][mode] = outs[mode].pop("peak_gib")
        rec["exchanges"][mode] = (sp.exchanges - before if sp is not None
                                  else 0)
    if sp is not None:
        for trap in PACKED_TRAPS:
            with _packed_trap(trap):
                outs[trap] = _mesh_serving({"f32": pipes["f32"]}, sp,
                                           {})["f32"]
            outs[trap].pop("peak_gib")
    del pipes
    return outs, rec


def _packed_mesh_gates(got, ref, ranks, lone) -> dict:
    """(g)'s gates and report: (a) each output against the lone packed
    run by `_mesh_gates` (f32 the serving gate, bf16 as close to the lone
    f32 as the lone bf16); (b) each trap's f32 run must fail the serving
    gate (by how many times the worst output misses it); (c) every kernel
    of `PACKED_MESH_KERNELS` launched on every rank, the counts beside the
    lone run's; (d) peak GiB per rank, halo exchanges per batch and the
    ranks' seconds beside the lone run's."""
    res = {"gates": _mesh_gates(got, ref, label="mesh2d packed")}
    f32 = dict(ref["f32"])
    f32.update(_features(f32.pop("feats")))
    res["traps"] = {}
    for trap in PACKED_TRAPS:
        run = dict(got[trap])
        run.update(_features(run.pop("feats")))
        miss = 0.0
        for key, g in run.items():
            e = _serving_gate(f"mesh2d packed trap '{trap}' {key} f32", g,
                              f32[key], gate=False)
            miss = max(miss, e["mean_rel"] / 1e-3, e["max_rel"] / 1e-2)
        res["traps"][trap] = miss
        say(f"mesh2d packed trap '{trap}': misses the f32 serving gate by "
            f"{miss:.3g}x")
        if miss <= 1.0:
            raise AssertionError(f"mesh2d packed: the trap '{trap}' passes "
                                 f"the f32 serving gate")
    lone_c = {k: _packed_counts(c) for k, c in lone["counts"].items()}
    res["lone_counts"] = lone_c
    res["rank_counts"] = []
    for r, rank in enumerate(ranks):
        counts = {k: _packed_counts(c) for k, c in
                  rank["packed"]["counts"].items()}
        res["rank_counts"].append(counts)
        for name, c in counts.items():
            need = PACKED_MESH_KERNELS["decode" if name.startswith("decode")
                                       else "serve"]
            missing = [k for k in need if c[k] == 0]
            if missing:
                raise AssertionError(f"mesh2d packed {name} rank {r}: "
                                     f"kernels never launched {missing}")
    for name, c in res["rank_counts"][0].items():
        say(f"mesh2d packed launches {name}: rank 0 "
            + ", ".join(f"{k} {c[k]}" for k in PACKED_SHOWN)
            + "; lone " + ", ".join(f"{k} {lone_c[name][k]}"
                                    for k in PACKED_SHOWN))
    for key in ("peak_gib", "exchanges", "seconds"):
        res[key] = [r["packed"][key] for r in ranks]
        res[f"lone_{key}"] = lone[key]
    say(f"mesh2d packed peak GiB per rank {res['peak_gib']}, lone "
        f"{res['lone_peak_gib']}; halo exchanges and gathers per batch "
        f"{res['exchanges']}; seconds (a)-(c) per dtype, ranks "
        f"{res['seconds']}, lone {res['lone_seconds']}")
    return res


class _ThreadRows:
    """A stand-in exchanger for `Spatial`: rank `rank` of `hub.n` threads
    of this process; `all_gather` meets the others at a barrier."""

    def __init__(self, hub, rank):
        self.hub, self.rank, self.size = hub, rank, hub.n

    def all_gather(self, t):
        hub = self.hub
        hub.slots[self.rank] = t
        hub.barrier.wait()
        out = list(hub.slots)
        hub.barrier.wait()
        return out


def _first_divergence(sd, rank_stage, mode: str = "bf16") -> dict:
    """Where the RestoreNet stage of the 1 x 2 run (`mode` f32 or bf16)
    leaves the lone run's bits. The lone stage runs here with a forward
    hook on every module of the RestoreNet keeping its inputs and
    outputs; then the same
    stage runs H-sharded on two threads of this process (`_ThreadRows`:
    the ranks' shapes and kernels, without gloo), each hook holding its
    module's inputs and outputs (this rank's rows) against the lone
    run's. Reports whether the threads reproduce the gloo ranks' output
    bit for bit, and a rank's first module call (post-order) whose output
    differs, and its first whose output differs from bit-equal inputs:
    that module's own arithmetic (its code outside the modules it calls,
    which all matched) on this rank's shapes, not a halo's rows; with
    each one's |difference| over its output's range."""
    import threading
    import types

    import torch

    from vspbfr_tpu_torch.parallel import Spatial
    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    p = RestorationPipeline(compute_dtype=dt if mode == "bf16" else None)
    p.load_state_dict(sd)
    p = p.cuda().eval().prepare_params()
    codes, low, lat = _mesh_inputs(p, "cuda")

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    with torch.no_grad():
        _, feats = p.psp.decode_with_feats(codes.to(dt), generator=gen(3))
    net = p.generator
    names = {m: n or "RestoreNet" for n, m in net.named_modules()}
    local = threading.local()
    lone, calls = [], {0: [], 1: []}

    def tensors(v):
        if torch.is_tensor(v):
            return [v]
        if isinstance(v, (list, tuple)):
            return [t for x in v for t in tensors(x)]
        return []

    def diff(got, want, sp):
        """max |got - want| over the pairs (want whole, got in its
        layout); None where a pair's shapes do not correspond."""
        worst = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape and g.dim() == 4 and (
                    g.shape[1] * sp.n == w.shape[1]):
                w = w[:, sp.own_rows(w.shape[1])]
            if g.shape != w.shape:
                return None
            worst = max(worst, float((g.float() - w.float()).abs().max()))
        return worst

    def hook(mod, args, out):
        ins, outs = tensors(args), tensors(out)
        rank = getattr(local, "rank", None)
        if rank is None:
            lone.append((names[mod], [t.clone() for t in ins],
                         [t.clone() for t in outs]))
            return
        i = len(calls[rank])
        name, w_in, w_out = lone[i] if i < len(lone) else (None, [], [])
        span = max((float(t.float().max() - t.float().min())
                    for t in w_out), default=0.0)
        calls[rank].append(dict(
            name=names[mod], kind=type(mod).__name__,
            same_module=name == names[mod],
            in_diff=diff(ins, w_in, local.sp),
            out_diff=diff(outs, w_out, local.sp), out_range=span))

    handles = [m.register_forward_hook(hook) for m in net.modules()]
    hub = types.SimpleNamespace(n=2, slots=[None] * 2,
                                barrier=threading.Barrier(2, timeout=120))
    outs, errors = [None, None], []

    def rank_thread(r):
        try:
            local.rank, local.sp = r, Spatial(_ThreadRows(hub, r))
            with torch.no_grad():
                outs[r] = net(low.to(dt), feats, codes.to(dt), lat.to(dt),
                              input_is_latent=True, generator=gen(6),
                              spatial=local.sp)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            hub.barrier.abort()

    try:
        with torch.no_grad():
            whole = net(low.to(dt), feats, codes.to(dt), lat.to(dt),
                        input_is_latent=True, generator=gen(6))
        threads = [threading.Thread(target=rank_thread, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"mesh2d {mode} witness: the thread ranks "
                                 f"failed: {errors}")
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    sharded = torch.cat(outs, dim=1).float().cpu()
    res = dict(threads_equal_ranks=bool(torch.equal(sharded, rank_stage)),
               calls=len(lone), first=[])
    span = float(whole.float().max() - whole.float().min())
    res["stage_max_rel"] = float((sharded - whole.float().cpu()).abs().max()
                                 ) / span
    res["first_own"] = []
    for r in range(2):
        c = calls[r]
        n = next((i for i, x in enumerate(c) if not x["same_module"]),
                 len(c))
        res.setdefault("same_calls", []).append(n == len(c) == len(lone))
        found = [None, None]
        for i, x in enumerate(c[:n]):
            if x["out_range"]:
                x["out_diff_rel"] = (x["out_diff"] or 0.0) / x["out_range"]
            if x["out_diff"] != 0.0 and found[0] is None:
                found[0] = dict(x, index=i)
            if (x["out_diff"] != 0.0 and x["in_diff"] == 0.0
                    and found[1] is None):
                found[1] = dict(x, index=i)
        res["first"].append(found[0])
        res["first_own"].append(found[1])
    del lone, calls
    torch.cuda.empty_cache()
    return res


def phase_mesh2d():
    """The 2-D mesh (`parallel/`) and the semi-packed layout: (a)-(e) and
    (g) (the packed layout, `_packed_mesh_serving`) in two gloo ranks on
    the one card (1 data x 2 model) against this process's lone runs, (f)
    `conv2d_semipacked` here."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline

    SEEDED["nets"].clear()
    SEEDED.pop("pipe", None)
    torch.cuda.empty_cache()
    res = {"kernels": []}
    base = RestorationPipeline().init_from_seed(0)
    _condition_diffuser(base)     # so that (c)'s DDPM chain is well posed
    sd = {k: torch.full_like(v, 0.1) if k.endswith("noise.weight") else v
          for k, v in base.state_dict().items()}
    del base
    with tempfile.TemporaryDirectory() as tmp:
        state_file = os.path.join(tmp, "pipe.pt")
        torch.save(sd, state_file)
        out = os.path.join(tmp, "mesh2d")
        h = _spawn_ranks("mesh2d", out, 2, [state_file])
        try:
            lone = {"counts": {}}
            pipes = _mesh_pipelines(sd)
            ref = _mesh_serving(pipes, None, lone["counts"])
            torch.cuda.reset_peak_memory_stats()
            ref_dec = _decoder_grads(pipes["f32"], None)
            lone_dec_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            del pipes
            torch.cuda.empty_cache()
            ref_pk, lone_pk = _packed_mesh_serving(sd, None)
            torch.cuda.empty_cache()
            lone_tr = _stage2_parallel_trainer(MESH_STAGE2_BATCH).to("cuda")
            ranks = _collect_ranks(h, MESH_TIMEOUT)
        except BaseException:
            _stop_ranks(h)
            raise
        got = torch.load(f"{out}.tensors.pt", weights_only=True)
        res["gates"] = _mesh_gates(got["serve"], ref)
        def _call(f):
            return ("none" if f is None else
                    f"#{f['index']} {f['name']} ({f['kind']}; inputs |diff| "
                    f"{f['in_diff']}, output |diff| {f['out_diff']} = "
                    f"{f.get('out_diff_rel', 0.0):.2e} of its range)")

        # where each dtype's stage leaves the lone run's bits, and why
        for mode in ("f32", "bf16"):
            w = _first_divergence(sd, got["serve"][mode]["stage"], mode)
            res[f"{mode}_witness"] = w
            say(f"mesh2d {mode} witness: the threads reproduce the gloo "
                f"ranks' stage bit for bit: {w['threads_equal_ranks']}; "
                f"threads vs lone {w['stage_max_rel']:.2e} of the range; "
                f"{w['calls']} module calls, the same a rank: "
                f"{w['same_calls']}")
            for r in range(2):
                say(f"mesh2d {mode} witness rank {r}: first differing call "
                    f"{_call(w['first'][r])}; first from bit-equal inputs "
                    f"{_call(w['first_own'][r])}")
        # (d) the model-sharded decoder
        d_img = _rel(got["decoder"]["image"], ref_dec["image"])
        worst = max(float((got["decoder"]["grads"][k] - v).abs().max())
                    / max(float(v.abs().max()), 1e-6)
                    for k, v in ref_dec["grads"].items())
        res["decoder"] = dict(image_rel=d_img, grad_worst_rel=worst,
                              n_sharded=len(got["decoder"]["sharded"]),
                              peak_gib=[r["peak_gib"]["decoder"]
                                        for r in ranks],
                              lone_peak_gib=lone_dec_peak)
        say(f"mesh2d (d) model-sharded decoder (1024 px b{MESH_BATCH} f32, "
            f"{len(got['decoder']['sharded'])} parameters sharded): image "
            f"{d_img:.2e} of max, gradients worst {worst:.2e} of each "
            f"one's max; peak GiB per rank {res['decoder']['peak_gib']} vs "
            f"lone {lone_dec_peak:.3f}")
        if d_img > 5e-4 or worst > 1e-5:
            raise AssertionError("mesh2d (d): the model-sharded decoder "
                                 "out of the gate")
        _mesh_stage2_lone(res, ranks, got["stage2"], got["stage2_grads"],
                          got["stage2_image"], lone_tr)
        del lone_tr
        res["packed"] = _packed_mesh_gates(got["packed"], ref_pk, ranks,
                                           lone_pk)
    for name, c in ranks[0]["counts"].items():
        path = {"stage2": "train", "decoder grads": "grads"}.get(
            name, "decode" if name.startswith("decode") else "serve")
        missing = [k for k in MESH_KERNELS[path] if c["launches"][k] == 0]
        if missing:
            raise AssertionError(f"mesh2d {name}: kernels never launched "
                                 f"{missing}")
    res["launches"] = {name: c["launches"] for name, c in
                       ranks[0]["counts"].items()}
    res["packed"]["launches"] = {
        name: {**c["launches"], **c["forms"]}
        for name, c in ranks[0]["packed"]["counts"].items()}
    res["lone_launches"] = {name: c["launches"] for name, c in
                            lone["counts"].items()}
    res["peak_gib"] = [r["peak_gib"] for r in ranks]
    res["lone_peak_gib"] = {k: v["peak_gib"] for k, v in ref.items()}
    res["exchanges"] = [r["exchanges"] for r in ranks]
    res["serve_s"] = [r["serve_s"] for r in ranks]
    for name, c in ranks[0]["counts"].items():
        lone_c = lone["counts"].get(name, {}).get("launches", {})
        say(f"mesh2d launches {name}: rank 0 "
            + ", ".join(f"{k} {c['launches'][k]}" for k in SHOWN)
            + ("; lone " + ", ".join(f"{k} {lone_c[k]}" for k in SHOWN)
               if lone_c else ""))
    say(f"mesh2d peak GiB per rank {res['peak_gib']}, lone "
        f"{res['lone_peak_gib']}; halo exchanges and gathers per rank "
        f"{res['exchanges']}; the ranks' (a)-(c) took {res['serve_s']} s")
    _semipacked_rows(res["kernels"])
    REPORT["mesh2d"] = res


# --- phase 17 ---------------------------------------------------------------

MESHTRAIN_TIMEOUT = 480     # seconds the phase-17 ranks may take
MT_STAGE2 = dict(size=256, batch=8)     # phase 7's config, (a)
MT_STAGE3 = dict(size=512, batch=4)     # phase 8's, (b); ADA at p 0.5
MT_PIPE: dict = {}          # full width (a CPU rehearsal cuts it)
MT_STEPS = 1                # steps a run, checked and timed (was 2: cut
#                             for the script's time)
# the kernels each sharded step must launch on each rank (the first step)
MT_KERNELS = {"stage2": ("dense_conv", "d2s", "s2d", "conv_epilogue",
                         "fused_leaky_relu"),
              "stage3": ("dense_conv", "dilated_multi_conv", "d2s", "s2d",
                         "conv_epilogue", "fused_leaky_relu")}


# the backward counts of phase 17: K1's launches inside its Function's
# backward (K1 dx) and the backward calls of K2's Function (K2 bwd)
MT_BACKWARDS = {"k1_dx": ("dense_conv", "_DenseConv", "dense_conv"),
                "k2_bwd": ("dilated_conv", "_DilatedMulti", None)}


MT_FROZEN = ("psp", "diffuser", "lpips", "id")     # both stages' nets
# whole images a step hands its whole-image nets (`_whole_images`)
MT_IMAGES = {"stage2": 1, "stage3": 2}
# the model-axis sums taken out, one at a time, in the f32 mesh's extra
# steps (`_mt_trap`): each must fail the gradient gate. Stage 2 sums its
# codes' row parts only; stage 3 also its replicated and model-sharded
# parameters' parts
MT_TRAPS = {"stage2": ("codes' sum",),
            "stage3": ("parameters' sum", "reduce-scatter")}
# (d) the packed layout: both stages again at this packed_min_res (the
# 1024 px decoder's 512 and 1024 levels and RestoreNet's 512 level
# packed, sharded by packed rows), the counts each rank's packed step must
# share with the lone packed step's (nonzero: the layout's kernel forms,
# K3, K4 and grouped K2's backward Function), and the planted faults in
# the packed windows' backward (`_mt_trap`) that the f32 run's gradients
# must show while its losses stay as they were; the model-axis sums'
# traps are the layout's alike, so they run unpacked only
MT_PMR = 512
MT_PACKED_COUNTS = {"stage2": ("d2s", "s2d", "conv_epilogue_nc4"),
                    "stage3": ("dilated_multi_conv_grouped", "k2_bwd", "d2s",
                               "s2d", "conv_epilogue_nc4")}
MT_PACKED_TRAPS = ("strip gradients dropped", "strip gradients swapped")
# the runs of phase 17: (stage, packed_min_res)
MT_CELLS = (("stage2", 0), ("stage3", 0), ("stage2", MT_PMR),
            ("stage3", MT_PMR))


def _mt_key(stage: str, pmr: int) -> str:
    """A run's key: "stage2", or "stage2 packed" at `MT_PMR`."""
    return f"{stage} packed" if pmr else stage


def _mt_name(key: str, mode: str) -> str:
    """A run's name: "stage2 f32", "stage3 bf16 packed"."""
    stage, *packed = key.split()
    return " ".join([stage, mode, *packed])


def _mt_traps(name: str) -> tuple:
    return (MT_PACKED_TRAPS if name.endswith(" packed")
            else MT_TRAPS[name.split()[0]])


def _mt_trainer(stage: str, mode: str, weights: dict | None = None,
                pmr: int = 0):
    """Phase 17's trainer: stage 2 at phase 7's config, stage 3 at phase
    8's with ADA at p 0.5, f32 or bf16, at packed_min_res `pmr`; from
    `weights` (module -> state_dict: the frozen nets, which both stages
    share, G and D; g_ema starts as G; the unpacked layout's tensors in
    either layout) or, without, stage 2 seeded (the diffuser conditioned,
    noise gains 0.1)."""
    import torch

    from vspbfr_tpu_torch.pipeline import RestorationPipeline
    from vspbfr_tpu_torch.train.diffuser_train import (DiffuserTrainConfig,
                                                       DiffuserTrainer)
    from vspbfr_tpu_torch.train.restore_train import (RestoreTrainConfig,
                                                      RestoreTrainer)

    dt = "bfloat16" if mode == "bf16" else None
    if stage == "stage2":
        tr = DiffuserTrainer(DiffuserTrainConfig(compute_dtype=dt,
                                                 **MT_STAGE2),
                             RestorationPipeline(size=MT_STAGE2["size"],
                                                 packed_min_res=pmr,
                                                 **MT_PIPE))
    else:
        tr = RestoreTrainer(RestoreTrainConfig(
            augment=True, augment_p=0.5, compute_dtype=dt, **MT_STAGE3),
            RestorationPipeline(size=MT_STAGE3["size"], packed_min_res=pmr,
                                **MT_PIPE))
    if weights is None:
        tr.init_from_seed(3)
        _condition_diffuser(tr.pipe)
        with torch.no_grad():
            for k, v in tr.pipe.named_parameters():
                if k.endswith("noise.weight"):
                    v.fill_(0.1)
        return tr
    for k in MT_FROZEN:
        tr.modules[k].load_state_dict(weights[k])
    if stage == "stage3":
        tr.gen.load_state_dict(weights["generator"])
        tr.disc.load_state_dict(weights["disc"])
        tr.sync_ema()
    return tr


def _mt_weights() -> dict:
    """Phase 17's seeded weights on the host (module -> state_dict): the
    frozen nets of the seeded stage-2 trainer, and G (noise gains 0.1) and
    D from seed 1."""
    import torch

    from vspbfr_tpu_torch.models import Discriminator, RestorationNet
    from vspbfr_tpu_torch.models.layers import init_module

    tr = _mt_trainer("stage2", "f32")
    weights = {k: tr.modules[k].state_dict() for k in MT_FROZEN}
    del tr
    gen = torch.Generator().manual_seed(1)
    width = {k: v for k, v in MT_PIPE.items() if k == "channel_div"}
    g = init_module(RestorationNet(size=MT_STAGE3["size"], **width), gen)
    with torch.no_grad():
        for k, v in g.named_parameters():
            if k.endswith("noise.weight"):
                v.fill_(0.1)
    d = init_module(Discriminator(size=MT_STAGE3["size"], **width), gen)
    weights.update(generator=g.state_dict(), disc=d.state_dict())
    return weights


def _mt_states(tr) -> dict:
    if hasattr(tr, "d_state"):
        return {"d": tr.d_state, "g": tr.g_state}
    return {"diffuser": tr.state}


def _mt_held(tr) -> dict:
    """The trained modules' state_dicts, whole, on the host (collective on
    a mesh; off the card, so no peak counts them), for `_mt_reset`."""
    return {k: {n: v.to("cpu", copy=True)
                for n, v in st.module.state_dict().items()}
            for k, st in _mt_states(tr).items()}


def _mt_reset(tr, held: dict) -> None:
    """The trainer back to `held` (`_mt_held`), its Adams new and its
    step counts 0 (so stage 3 runs R1 again), g_ema = G."""
    for k, st in _mt_states(tr).items():
        st.module.load_state_dict(held[k])
        st.opt.state.clear()
        st.step = 0
    if hasattr(tr, "g_state"):
        tr.sync_ema()


def _strip_fault(name: str):
    """A `Spatial.window` whose windows of a packed map on this rank's rows
    (packed=True at a sharded resolution) run the forward exchange as the
    package does and a faulty reverse one: "strip gradients dropped" adds
    nothing from the strips (each rank keeps its own rows' gradient);
    "strip gradients swapped" sends the top strip's gradient to the lower
    neighbour and the bottom one's to the upper (each rank adds the upper
    neighbour's top strip into its first rows and the lower neighbour's
    bottom strip into its last)."""
    import torch
    from torch.autograd.function import once_differentiable

    from vspbfr_tpu_torch.parallel.spatial import Spatial, _Window

    class Faulty(_Window):
        @staticmethod
        @once_differentiable
        def backward(ctx, g):
            sp, top, bottom = ctx.sp, ctx.top, ctx.bottom
            h = g.shape[1] - top - bottom
            sp.exchanges += 1
            parts = sp.rows_group.all_gather(
                torch.cat([g[:, :top], g[:, top + h:]], dim=1))
            dx = g[:, top:top + h].clone()
            k = min(top, bottom)
            if name == "strip gradients swapped" and k:
                if sp.rank > 0:
                    dx[:, :k] += parts[sp.rank - 1][:, top - k:top]
                if sp.rank < sp.n - 1:
                    dx[:, h - k:] += parts[sp.rank + 1][:, top:top + k]
            return dx, None, None, None

    own = Spatial.__dict__["window"]

    def window(self, x, top, bottom, packed=False):
        if not (packed and (top or bottom)
                and self.sharded(self.res_of(x, True))):
            return own(self, x, top, bottom, packed)
        self._check(x, True)
        return Faulty.apply(x, self, top, bottom)

    return window


@contextlib.contextmanager
def _mt_trap(name: str):
    """For the block, a fault in the package's backward, as a copy with it
    would run: a model-axis sum taken out ("codes' sum" the style codes'
    row parts' (`Spatial.summed` the identity), "parameters' sum" the
    replicated parameters' (`Spatial.sum_partial_grads` does nothing),
    "reduce-scatter" the model-sharded parameters' (each rank keeps its
    slice of its own part)), or one of `MT_PACKED_TRAPS` in the packed
    windows' reverse exchange (`_strip_fault`)."""
    from vspbfr_tpu_torch.parallel.model_axis import ModelAxis
    from vspbfr_tpu_torch.parallel.spatial import Spatial

    if name in MT_PACKED_TRAPS:
        cls, attr, stub = Spatial, "window", _strip_fault(name)
    else:
        cls, attr, stub = {
            "codes' sum": (Spatial, "summed", lambda self, t: t),
            "parameters' sum": (Spatial, "sum_partial_grads",
                                lambda self, module: None),
            "reduce-scatter": (ModelAxis, "reduce_scatter_last",
                               lambda self, t: self.local(t).contiguous()),
        }[name]
    own = cls.__dict__.get(attr)
    setattr(cls, attr, stub)
    try:
        yield
    finally:
        if own is None:
            delattr(cls, attr)
        else:
            setattr(cls, attr, own)


def _mt_batch(stage: str, device):
    """The stage's low and real faces (seeded)."""
    import torch

    cfg, seeds = ((MT_STAGE2, (41, 42)) if stage == "stage2"
                  else (MT_STAGE3, (171, 172)))
    return [torch.tensor(synthetic_faces(cfg["batch"], cfg["size"], seed=s),
                         device=device) for s in seeds]


def _mt_run(tr, stage: str, device, bwd: dict, f: float = 1.0,
            steps: int = MT_STEPS) -> dict:
    """`steps` steps of `tr` (under cuDNN's deterministic algorithms) on
    phase 17's batch, its low images scaled by f, and the draws of one
    seeded generator on the device: the first step's metrics, the
    gradients each of its Adam updates took (by name, in the modules'
    unsharded order; the rank's slice of a model-sharded one), its
    launches and the layout's forms', K1 dx and K2 bwd counts and plain
    K6 / K7 calls; every
    step's seconds (host clock, synchronised); peak memory; Adam's bytes;
    with a mesh the first step's halo exchanges and model-axis sums."""
    import torch

    from vspbfr_tpu_torch import ops
    from vspbfr_tpu_torch.parallel.model_axis import model_axis

    def reduce_scatters():
        axes = {id(a): a for a in map(model_axis, tr.modules.values()) if a}
        return sum(a.reduce_scatters for a in axes.values())

    low, real = _mt_batch(stage, device)
    gen = torch.Generator(device=device).manual_seed(13)
    grads: dict = {k: [] for k in _mt_states(tr)}
    hooks = []
    for key, state in _mt_states(tr).items():
        mod = state.module
        names = (mod._model_axis["names"]
                 if getattr(mod, "_model_axis", None)
                 else [n for n, _ in mod.named_parameters()])

        def hook(opt, *_, names=names, out=grads[key]):
            params = opt.param_groups[0]["params"]
            out.append({n: p.grad.detach().clone()
                        for n, p in zip(names, params)})

        hooks.append(state.opt.register_step_pre_hook(hook))
    sp = getattr(tr, "spatial", None)
    rs0 = reduce_scatters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out: dict = {"seconds": []}
    for s in range(steps):
        if s == 0:
            ops.reset_launch_counts()
            ops.reset_plain_cuda_calls()
            bwd.clear()
        t0 = time.perf_counter()
        with cudnn_deterministic():
            m = tr.train_step(low * f, real, gen)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        if s == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            out["launches"] = ops.launch_counts()
            out["forms"] = ops.form_counts()
            out["plain"] = ops.plain_cuda_calls()
            out["backward"] = dict(bwd)
            for h in hooks:
                h.remove()
            if sp is not None:
                out.update(exchanges=sp.exchanges, grad_sums=sp.grad_sums,
                           reduce_scatters=reduce_scatters() - rs0)
    out["grads"] = grads
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["adam_bytes"] = sum(v.numel() * v.element_size()
                            for st in _mt_states(tr).values()
                            for p_st in st.opt.state.values()
                            for k, v in p_st.items() if k != "step")
    if any(out["plain"].values()):
        raise AssertionError(f"meshtrain {stage}: a plain version ran on the "
                             f"card: {out['plain']}")
    return out


def _mt_whole(tr, grads: dict) -> dict:
    """The recorded gradients with each model-sharded slice gathered whole
    (collective over the model group), on the host."""
    from vspbfr_tpu_torch.parallel.model_axis import (model_axis,
                                                      sharded_names)

    out = {}
    for key, state in _mt_states(tr).items():
        mod = state.module
        ax, sharded = model_axis(mod), set(sharded_names(mod))
        out[key] = [{n: (ax.gather(v) if n in sharded else v).cpu()
                     for n, v in g.items()} for g in grads[key]]
    return out


def _meshtrain_rank(out, mode, weights_file):
    """One rank of phase 17 (`--rank meshtrain OUT MODE WEIGHTS`) on a 1
    data x 2 model mesh: per `MT_CELLS` entry (each stage unpacked, then at
    `MT_PMR`) a trainer in MODE (f32 or bf16) on the parent's
    `_mt_weights` (WEIGHTS, once it is written), `shard_model`, `MT_STEPS`
    steps; in f32 the first step's whole images recorded, then per
    model-axis trap of an unpacked run (`MT_TRAPS`) the first step again
    with that sum taken out. The bf16 mesh then runs the f32 packed runs'
    traps (`MT_PACKED_TRAPS`), the first f32 step again on a new trainer
    with each fault planted, so the two meshes take about as long. Each
    trap run's gradients and metrics are kept. Rank 0 writes the first
    steps' gradients, whole, and the images to OUT.tensors.pt, every rank
    its record to OUT.<rank>.json."""
    import torch

    from vspbfr_tpu_torch.parallel import create_mesh_2d, distributed

    t0 = time.perf_counter()
    rec = {"runs": {}, "trap_metrics": {}, "marks": []}

    def mark(what):
        rec["marks"].append((what, round(time.perf_counter() - t0, 1)))

    def traps(tr, name, stage, held, names):
        rec["trap_metrics"][name] = {}
        for trap in names:
            _mt_reset(tr, held)
            with _mt_trap(trap):
                t_run = _mt_run(tr, stage, device, bwd, steps=1)
            tensors[f"{name} without {trap}"] = _mt_whole(tr, t_run["grads"])
            rec["trap_metrics"][name][trap] = t_run["metrics"]
        mark(f"{name} trapped")

    tensors = {}
    with distributed("cuda") as device, \
            backward_counts(MT_BACKWARDS) as bwd:
        mesh = create_mesh_2d(1, 2)
        rank = torch.distributed.get_rank()
        mark("mesh")
        while not os.path.exists(weights_file):
            if time.perf_counter() - t0 > MESHTRAIN_TIMEOUT:
                raise TimeoutError(f"no {weights_file}")
            time.sleep(0.2)
        weights = torch.load(weights_file, weights_only=True)
        mark("weights")
        for stage, pmr in MT_CELLS:
            name = _mt_name(_mt_key(stage, pmr), mode)
            tr = _mt_trainer(stage, mode, weights, pmr).to(device)
            tr.shard_model(mesh)
            mark(f"{name} built")
            held = _mt_held(tr) if mode == "f32" else None
            images: list = []
            with _whole_images(tr, images, MT_IMAGES[stage]):
                run = _mt_run(tr, stage, device, bwd)
            mark(f"{name} stepped")
            tensors[name] = _mt_whole(tr, run.pop("grads"))
            rec["runs"][name] = run
            if mode == "f32":
                tensors[f"{name} images"] = [t.cpu() for t in images]
                if not pmr:
                    traps(tr, name, stage, held, MT_TRAPS[stage])
            del tr, held
            torch.cuda.empty_cache()
        if mode == "bf16":
            for stage, pmr in MT_CELLS:
                if pmr:
                    tr = _mt_trainer(stage, "f32", weights, pmr).to(device)
                    tr.shard_model(mesh)
                    traps(tr, _mt_name(_mt_key(stage, pmr), "f32"), stage,
                          _mt_held(tr), MT_PACKED_TRAPS)
                    del tr
                    torch.cuda.empty_cache()
        if rank == 0:
            torch.save(tensors, f"{out}.tensors.pt")
        mark("saved")
    rec["plain_cuda_calls"] = {}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(rec, f)


def _mt_compare(got: list, want: list) -> dict:
    """A gradient set (a list of updates, each name -> tensor) against
    another: the worst tensor's max |diff| over its max |want| (and its
    name), the whole set's relative L2 error, and the share of elements
    whose sign differs (of those where want is not 0). On the card: the
    phase compares billions of elements."""
    worst, at = 0.0, ""
    diff2 = ref2 = 0.0
    flips = counted = 0
    for g_upd, w_upd in zip(got, want):
        if set(g_upd) != set(w_upd):
            raise AssertionError("meshtrain: the gradient sets name other "
                                 "parameters")
        for k, w in w_upd.items():
            g = g_upd[k].to("cuda").float()
            w = w.to("cuda").float()
            d = (g - w).abs()
            rel = float(d.max()) / max(float(w.abs().max()), 1e-6)
            if rel > worst:
                worst, at = rel, k
            diff2 += float(d.square().sum())
            ref2 += float(w.square().sum())
            nz = w != 0
            flips += int((g.sign() != w.sign())[nz].sum())
            counted += int(nz.sum())
    return dict(worst_rel=worst, worst_at=at,
                rel_l2=(diff2 / max(ref2, 1e-30)) ** 0.5,
                flips=flips / max(counted, 1))


def _mt_lone(weights: dict, bwd: dict) -> tuple[dict, dict]:
    """The lone runs, in this process: per `MT_CELLS` entry the f32
    trainer at the phase's inputs (`MT_STEPS` steps), at inputs scaled by
    1 +- 1e-6 and once more at 1 (one step each: the losses' spread and
    the gradients' own spread from run to run), and the bf16 trainer
    once; the gradients on the host. Also returns the f32 trainers and
    their weights (run key -> (trainer, `_mt_held`)) for
    `_mt_at_images`."""
    import torch

    out, kept = {}, {}
    for stage, pmr in MT_CELLS:
        key = _mt_key(stage, pmr)
        for mode in ("f32", "bf16"):
            tr = _mt_trainer(stage, mode, weights, pmr).to("cuda")
            held = _mt_held(tr)
            runs = []
            fs = (1.0, 1 + 1e-6, 1 - 1e-6, 1.0) if mode == "f32" else (1.0,)
            for i, f in enumerate(fs):
                if i:
                    _mt_reset(tr, held)     # the step again
                runs.append(_mt_host(_mt_run(tr, stage, "cuda", bwd, f,
                                             MT_STEPS if i == 0 else 1)))
            out[_mt_name(key, mode)] = runs
            if mode == "f32":
                # on the host while the other runs take their peaks
                for st in _mt_states(tr).values():
                    st.opt.state.clear()
                kept[key] = (tr.to("cpu"), held)
            del tr, held
            torch.cuda.empty_cache()
    return out, kept


def _mt_host(run: dict) -> dict:
    run["grads"] = {k: [{n: v.cpu() for n, v in g.items()} for g in gs]
                    for k, gs in run["grads"].items()}
    return run


def _mt_at_images(kept: dict, got: dict, bwd: dict) -> dict:
    """Each lone f32 step once more (`kept`, from `_mt_lone`) with the
    ranks' whole images (`got["<run name> images"]`) handed to its
    whole-image nets in place of its own (`_whole_images`): run key ->
    the run."""
    out = {}
    for key, (tr, held) in kept.items():
        tr.to("cuda")
        _mt_reset(tr, held)
        subs = [t.to("cuda") for t in got[f"{_mt_name(key, 'f32')} images"]]
        with _whole_images(tr, subs=subs):
            out[key] = _mt_host(_mt_run(tr, key.split()[0], "cuda", bwd,
                                        steps=1))
        kept[key] = None    # off the card before the next one
        del tr, held
    return out


def _mt_gates(res, name, ranks, got, lone, at_images) -> None:
    """One stage's f32 or bf16 run on the ranks against the lone runs.
    f32: each loss within phase 7 / 8's gate (10 x the lone step's spread
    under +-1e-6 input changes + 1e-5). The ranks decode (stage 3: the
    embedding and RestoreNet) on their rows, whose windows some ops round
    otherwise (phase 16's witness names the first), and the backward (the
    whole-image nets: LPIPS, ID; in stage 3 D, R1 and Adam's first steps
    before G's) grows a rounding, as it grows a +-1e-6 input change. So
    the gradients are held to the lone step that took the ranks' whole
    images (`at_images`, `_mt_at_images`), which takes the images' share
    out: each gradient set's worst tensor, relative to its max, within
    1e-5 + 10 x the larger of the lone step's own spread (a second run at
    the same inputs: the backward is not deterministic) and the distance
    the ranks' images alone move it (one rounding of the forward, as
    these gradients feel it; what is left, the decode's own rounding
    inside, is of that kind); flips <= 5%; and each trap run of the ranks
    (`_mt_traps`: unpacked a model-axis sum taken out, packed a fault in
    the packed windows' reverse exchange) must fail that gate, a packed
    one with its losses equal to the untrapped step's (within 1e-6 of
    each, relative: the faults are in the backward only). The distances
    to the plain lone step and the +-1e-6 runs' are reported. A packed
    run (name ending " packed") is held to the lone packed runs alike.
    bf16: held
    to the lone f32 step as closely as the lone
    bf16 step is: each loss's relative error within 1.5 x the lone
    bf16's + 2e-2 (bf16's kernel tolerance); each gradient set's relative
    L2 error within 1.5 x the lone bf16's + 1e-6; flips within max(5%,
    1.5 x the lone bf16's)."""
    stage, mode = name.split()[:2]
    ref = lone[name.replace(mode, "f32")]
    m1 = ref[0]["metrics"]
    gate = {"metrics": {}, "grads": {}}
    bad = []
    if mode == "f32":
        for k, v in m1.items():
            scale = max(abs(v), 1e-12)
            err = max(abs(r["runs"][name]["metrics"][k] - v)
                      for r in ranks) / scale
            spread = max(abs(p["metrics"][k] - v) for p in ref[1:3]) / scale
            gate["metrics"][k] = dict(rel_err=err, spread=spread)
            if not err <= 10 * spread + 1e-5:
                bad.append(k)
        traps = {t: got[f"{name} without {t}"] for t in _mt_traps(name)}
        caught = dict.fromkeys(traps, False)
        if name.endswith(" packed"):
            gate["trap_losses"] = {}
            for t in traps:
                worst = max(abs(r["trap_metrics"][name][t][k] - v)
                            / max(abs(v), 1e-12)
                            for r in ranks
                            for k, v in r["runs"][name]["metrics"].items())
                gate["trap_losses"][t] = worst
                if not worst <= 1e-6:
                    bad.append(f"the losses with the {t} moved by {worst}")
        for key, want in at_images["grads"].items():
            plain = ref[0]["grads"][key]
            c = _mt_compare(got[name][key], want)
            c["repeat"] = _mt_compare(ref[3]["grads"][key], plain)
            c["vs_plain"] = _mt_compare(got[name][key], plain)
            c["images_move"] = _mt_compare(want, plain)
            c["limit"] = 1e-5 + 10 * max(c["repeat"]["worst_rel"],
                                         c["images_move"]["worst_rel"])
            c["inputs_move"] = max((_mt_compare(r["grads"][key], plain)
                                    for r in ref[1:3]),
                                   key=lambda o: o["worst_rel"])
            c["traps"] = {t: _mt_compare(g[key], want)
                          for t, g in traps.items()}
            gate["grads"][key] = c
            if c["worst_rel"] > c["limit"] or c["flips"] > 0.05:
                bad.append(f"grads {key}")
            for t, o in c["traps"].items():
                caught[t] |= o["worst_rel"] > c["limit"] or o["flips"] > 0.05
        gate["traps_caught"] = caught
        bad += [f"a copy without the {t} passes" for t, ok in caught.items()
                if not ok]
    else:
        lone16 = lone[name][0]
        for k, v in m1.items():
            scale = max(abs(v), 1e-12)
            err = max(abs(r["runs"][name]["metrics"][k] - v)
                      for r in ranks) / scale
            e16 = abs(lone16["metrics"][k] - v) / scale
            gate["metrics"][k] = dict(rel_err_vs_f32=err,
                                      lone_bf16_vs_f32=e16)
            if not err <= 1.5 * e16 + TOL["bf16"]:
                bad.append(k)
        for key, want in ref[0]["grads"].items():
            c = _mt_compare(got[name][key], want)
            c["lone_bf16"] = _mt_compare(lone16["grads"][key], want)
            gate["grads"][key] = c
            if (c["rel_l2"] > 1.5 * c["lone_bf16"]["rel_l2"] + 1e-6
                    or c["flips"] > max(0.05,
                                        1.5 * c["lone_bf16"]["flips"])):
                bad.append(f"grads {key}")
    res["gates"][name] = gate
    if "trap_losses" in gate:
        say(f"meshtrain {name}: the losses with each backward fault against "
            f"the untrapped step's, worst relative: "
            + ", ".join(f"{t} {w:.2e}"
                        for t, w in gate["trap_losses"].items()))
    say(f"meshtrain {name}, 1 x 2 vs lone: losses (rel err / "
        + ("lone spread" if mode == "f32" else "lone bf16's") + ") "
        + ", ".join(f"{k} " + "/".join(f"{x:.2e}" for x in v.values())
                    for k, v in gate["metrics"].items()))

    def shown(o):
        return f"{o['worst_rel']:.2e} ({o['worst_at']}) / {o['rel_l2']:.2e}"

    for key, c in gate["grads"].items():
        if mode == "f32":
            say(f"meshtrain {name} gradients {key}, worst tensor of its max "
                f"(where) / rel L2: against the lone step on the ranks' "
                f"images {shown(c)}, flips {c['flips']:.4f}, gate "
                f"{c['limit']:.2e} (the lone step repeated "
                f"{shown(c['repeat'])}; the ranks' images alone move it "
                f"{shown(c['images_move'])}); against the plain lone step "
                f"{shown(c['vs_plain'])}; +-1e-6 inputs move it "
                f"{shown(c['inputs_move'])}; "
                + "; ".join(f"without the {t} {shown(o)}"
                            for t, o in c["traps"].items()))
        else:
            say(f"meshtrain {name} gradients {key}: worst {shown(c)}, flips "
                f"{c['flips']:.4f}; lone bf16 {shown(c['lone_bf16'])}, "
                f"flips {c['lone_bf16']['flips']:.4f}")
    if bad:
        raise AssertionError(f"meshtrain {name}: out of the gate: {bad}")


def phase_meshtrain():
    """Training on the 2-D mesh: two gloo ranks on the one card (1 data x
    2 model; an f32 and a bf16 mesh at once, four processes) against this
    process's lone steps, phase 7's stage-2 config
    (b8) and phase 8's stage 3 (512 px b4, ADA at p 0.5, R1 at the first
    step), full width, seeded: (a) / (b) the sharded steps' losses and
    gradients held to the lone steps (`_mt_gates`: in f32 the gradients
    to the lone step on the ranks' images, and the ranks' steps without
    each model-axis sum must fail that gate), f32 and bf16; (c)
    peak memory, Adam's bytes, halo exchanges, model-axis sums, launches
    and step medians a rank beside the lone run's; (d) the same at
    packed_min_res `MT_PMR` in the same processes, the f32 packed step on
    ranks with each of `MT_PACKED_TRAPS` in the packed windows' backward
    (on the bf16 mesh, after its own steps), and (`_mt_report`) the
    layout's counts a rank equal to the lone packed step's."""
    import torch

    SEEDED["nets"].clear()
    SEEDED.pop("pipe", None)
    torch.cuda.empty_cache()
    res = {"runs": {}, "gates": {}, "launches": {}}
    with tempfile.TemporaryDirectory() as tmp, \
            backward_counts(MT_BACKWARDS) as bwd:
        # two meshes at once, one a dtype (each rank's peak is its own;
        # the card holds both and the lone steps); the ranks start while
        # this process draws the seeded weights, and load them once written
        outs = {m: os.path.join(tmp, f"meshtrain_{m}") for m in ("f32",
                                                                "bf16")}
        wfile = os.path.join(tmp, "weights.pt")
        hs = [_spawn_ranks("meshtrain", o, 2, [m, wfile])
              for m, o in outs.items()]
        try:
            t0 = time.perf_counter()
            weights = _mt_weights()
            torch.save(weights, f"{wfile}.part")
            os.replace(f"{wfile}.part", wfile)
            lone, kept = _mt_lone(weights, bwd)
            del weights
            lone_s = time.perf_counter() - t0
            per_mode = [_collect_ranks(h, MESHTRAIN_TIMEOUT) for h in hs]
        except BaseException:
            for h in hs:
                _stop_ranks(h)
            raise
        ranks = [{part: {k: v for r in recs for k, v in r[part].items()}
                  for part in ("runs", "trap_metrics")}
                 for recs in zip(*per_mode)]
        res["marks"] = {m: recs[0]["marks"]
                        for m, recs in zip(outs, per_mode)}
        for m, marks in res["marks"].items():
            say(f"meshtrain: rank 0 of the {m} mesh, seconds since its "
                f"start: {marks}")
        got = {}
        for o in outs.values():
            got.update(torch.load(f"{o}.tensors.pt", weights_only=True))
        t0 = time.perf_counter()
        at_images = _mt_at_images(kept, got, bwd)
        del kept
    say(f"meshtrain: the lone runs took {lone_s:.1f} s beside the ranks, "
        f"the lone steps on the ranks' images "
        f"{time.perf_counter() - t0:.1f} s after them")
    for stage, pmr in MT_CELLS:
        key = _mt_key(stage, pmr)
        for mode in ("f32", "bf16"):
            _mt_report(res, _mt_name(key, mode), ranks, got, lone,
                       at_images[key])
    REPORT["meshtrain"] = res


def _mt_counts(run: dict) -> dict:
    """A run's first-step counts: launches, the layout's forms, and K1 dx
    and K2 bwd."""
    return {**run["launches"], **run["forms"], **run["backward"]}


def _mt_report(res, name, ranks, got, lone, at_images) -> None:
    """Phase 17's checks and lines of one run on the ranks: its gates
    (`_mt_gates`), the kernels each rank launched, (d)'s counts equal to
    the lone packed step's, and (c)'s line."""
    stage = name.split()[0]
    _mt_gates(res, name, ranks, got, lone, at_images)
    runs = [r["runs"][name] for r in ranks]
    lone_run = lone[name][0]
    for i, r in enumerate(runs):
        missing = [k for k in MT_KERNELS[stage] if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"meshtrain {name} rank {i}: kernels "
                                 f"never launched {missing}")
        if name.endswith(" packed"):
            got_c, want_c = _mt_counts(r), _mt_counts(lone_run)
            off = {k: (got_c.get(k, 0), want_c.get(k, 0))
                   for k in MT_PACKED_COUNTS[stage]
                   if not got_c.get(k, 0) == want_c.get(k, 0) > 0}
            if off:
                raise AssertionError(f"meshtrain {name} rank {i}: counts "
                                     f"(rank, lone) not equal and nonzero "
                                     f"{off}")
    res["launches"][name] = {**runs[0]["launches"], **runs[0]["forms"]}
    res["runs"][name] = dict(
        ranks=[{k: r[k] for k in ("seconds", "peak_gib", "adam_bytes",
                                  "exchanges", "grad_sums",
                                  "reduce_scatters", "launches", "forms",
                                  "backward", "metrics")}
               for r in runs],
        lone={k: lone_run[k] for k in ("seconds", "peak_gib",
                                       "adam_bytes", "launches", "forms",
                                       "backward", "metrics")})
    r0 = runs[0]
    shown, lone_shown = ({**{k: r["launches"][k]
                             for k in MT_KERNELS["stage3"]},
                          **r["backward"],
                          **(r["forms"] if name.endswith(" packed") else {})}
                         for r in (r0, lone_run))
    say(f"meshtrain {name} (c): peak GiB per rank "
        f"{[round(r['peak_gib'], 3) for r in runs]} vs lone "
        f"{lone_run['peak_gib']:.3f}; Adam's bytes per rank "
        f"{[r['adam_bytes'] for r in runs]} vs lone "
        f"{lone_run['adam_bytes']} "
        f"({runs[0]['adam_bytes'] / lone_run['adam_bytes']:.3f}x); "
        f"first step: halo exchanges and gathers {r0['exchanges']}, "
        f"model-axis sums {r0['grad_sums']} + reduce-scatters "
        f"{r0['reduce_scatters']}; launches rank 0 {shown}, lone "
        f"{lone_shown}; step s (host clock, gloo through the host: not "
        f"speeds) ranks "
        f"{[[round(t, 3) for t in r['seconds']] for r in runs]} median "
        f"{statistics.median(runs[0]['seconds']):.3f}, lone "
        f"{[round(t, 3) for t in lone_run['seconds']]} median "
        f"{statistics.median(lone_run['seconds']):.3f}; plain K6 / K7 "
        f"on CUDA tensors 0")
    if stage == "stage3" and not runs[0]["reduce_scatters"]:
        raise AssertionError(f"meshtrain {name}: no model-sharded "
                             "weight of a layer on rows was "
                             "reduce-scattered")
    if not all(r["adam_bytes"] < lone_run["adam_bytes"] for r in runs):
        raise AssertionError(f"meshtrain {name}: Adam's moments not "
                             "sharded")


# --- main -------------------------------------------------------------------

def _held() -> str:
    """This process' resident host memory and the card's memory its
    allocator holds, GiB (what one phase leaves to the next)."""
    import torch

    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return (f"host {rss / 2 ** 30:.1f} GiB, card "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB held")


def main() -> None:
    import gc

    import torch

    for name in PHASES:
        # what the last phase left goes before the next one's processes
        # share the card and the host
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        # the path phases: no plain K6 / K7 on the card
        with (no_plain_on_card(name) if name in ("slice", "cli", "train",
                                                 "restore", "convert",
                                                 "sample", "parallel",
                                                 "hostdata", "mesh2d",
                                                 "meshtrain")
              else contextlib.nullcontext()):
            globals()[f"phase_{name}"]()
        REPORT.setdefault("phase_seconds", {})[name] = round(
            time.perf_counter() - t0, 1)
        say(f"phase {name} done in {time.perf_counter() - t0:.1f} s; "
            f"{_held()}")

    kernels = []
    launches = {"serve": REPORT["cli"]["f32"]["launches"],
                "train": REPORT["train"]["f32"]["launches"],
                "restore": REPORT["restore"]["f32"]["launches"],
                "restore_ada": REPORT["restore"]["f32_augment"]["launches"],
                "restore_fused": REPORT["restore"]["bf16_fused"]["launches"],
                "smart": REPORT["smart"]["f32"]["launches"],
                "experiments": REPORT["experiments"]["launches"],
                "convert": REPORT["convert"]["f32"]["launches"],
                "sample": REPORT["sample"]["launches"],
                "parallel": REPORT["parallel"]["world1"]["launches"],
                "hostdata_restore":
                    REPORT["hostdata"]["stage3_host"]["launches"],
                "hostdata_train":
                    REPORT["hostdata"]["stage2_jpeg_host"]["launches"],
                "packed": REPORT["packed"]["serve"]["f32"]["launches"],
                "packed_fused":
                    REPORT["packed"]["serve"]["bf16"]["fused_launches"],
                "packed_restore": REPORT["packed"]["stage3"]["launches"],
                "packed_train": REPORT["packed"]["stage2"]["launches"],
                "mesh2d": REPORT["mesh2d"]["launches"]["restore f32"],
                "mesh2d_packed":
                    REPORT["mesh2d"]["packed"]["launches"]["restore f32"],
                "meshtrain": REPORT["meshtrain"]["launches"]["stage3 f32"],
                "meshtrain_packed":
                    REPORT["meshtrain"]["launches"]["stage3 f32 packed"]}
    for name, (src, replaces) in KERNEL_INFO.items():
        rows = [r for r in (REPORT["kernels"] + REPORT["grads"]
                            + REPORT["packed"]["kernels"]
                            + REPORT["mesh2d"]["kernels"])
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
                        "launches_by_path": {p: c.get(name)
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
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        sys.exit(main())
