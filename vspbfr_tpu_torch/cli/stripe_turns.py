"""Time K9 and K10 of this tree in turns against an earlier checkout's form
of the same kernels, and the bf16 kernel's tiles against each other, on
one card.

    python -m vspbfr_tpu_torch.cli.stripe_turns --old DIR [--out FILE]

DIR is an earlier checkout of the repository (for example
`git archive 2e8f1dd | tar -x -C DIR`) whose
`vspbfr_tpu_torch/csrc/stripe_conv.cu` has the C entry of the mma.sync
form: `vspbfr_stripe_conv(x, wt, y, dtype, load, B, H, W, Ci, Co, KH, KW,
py0, px0, OH, OW, TH, stream)`, weights (KH, KW, Co, Ci), TH 8 for K9 and
h_t for K10. That source is built apart (one `nvcc`, this tree's flags)
and called through ctypes the way its wrapper called it; this tree's
kernels run through `ops`. At each `cli.profile` STRIPE_SHAPES shape and
each K10 variant at INKPAD_SHAPE (h_t 16), b4, in f32 and bf16, it prints
CUDA-event medians (`cli.profile.cuda_ms`) in the order old, new, new,
old, both forms' max difference from the plain version relative to its
max |value|, cuDNN's time and the bound. Then, in bf16, each case on
every tile of `ops.stripe_conv.BF16_TILES` that its plan can take (in
that order and back), and with the plan's persistent grid (a block per
multiprocessor) against one block a tile (first, second, second, first).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from vspbfr_tpu_torch import ops
from vspbfr_tpu_torch.cli.profile import (INKPAD_CO, INKPAD_ROWS,
                                          INKPAD_SHAPE, STRIPE_SHAPES,
                                          _diffs, _rand_fn, bound_ms,
                                          card_name, cuda_ms, in_turns,
                                          stripe_work)
from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc

tsc = importlib.import_module("vspbfr_tpu_torch.ops.stripe_conv")
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURE = [_P] * 3 + [_I] * 14 + [_P]
OLD_K9_ROWS = 8


def build_old(old: Path) -> ctypes.CDLL:
    """The earlier checkout's stripe_conv.cu as its own library."""
    csrc = old / "vspbfr_tpu_torch" / "csrc"
    out = _build.BUILD_ROOT.parent / "turns"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libold_stripe_conv.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
           "-o", str(so), str(csrc / "stripe_conv.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.vspbfr_stripe_conv.argtypes = OLD_SIGNATURE
    lib.vspbfr_stripe_conv.restype = ctypes.c_int
    return lib


def old_conv(lib, x, w, pads, load, th):
    """One call of the earlier form, as its wrapper made it."""
    if load == "legacy":
        x, pads, load = F.pad(x, (0, 0, 1, 1, 1, 1)), ((0, 0), (0, 0)), \
            "predicated"
    wt = w.to(x.dtype).permute(0, 1, 3, 2).contiguous()
    b, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    (py0, py1), (px0, px1) = pads
    oh, ow = h + py0 + py1 - kh + 1, wd + px0 + px1 - kw + 1
    y = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    err = lib.vspbfr_stripe_conv(
        x.data_ptr(), wt.data_ptr(), y.data_ptr(), _build.dtype_code(x),
        tsc._LOAD[load], b, h, wd, ci, co, kh, kw, py0, px0, oh, ow, th,
        _build.stream_of(x))
    if err:
        raise RuntimeError(f"old vspbfr_stripe_conv: CUDA error {err}")
    return y


def _cases(dtype):
    """(label, x, w, pads, K10 variant or None, h_t) at the entries' shapes."""
    rand = _rand_fn(dtype, torch.device("cuda"))
    for xs, ws, pads in STRIPE_SHAPES:
        yield (f"K9 {xs[1]}px C{xs[3]} {ws[0]}x{ws[1]}->{ws[3]}",
               rand(*xs), rand(*ws, scale=0.05), pads, None, None)
    x = rand(*INKPAD_SHAPE)
    w = rand(3, 3, INKPAD_SHAPE[3], INKPAD_CO, scale=0.05)
    for v in tsc.VARIANTS:
        yield (f"K10 {v} h_t {INKPAD_ROWS}", x, w, ((1, 1), (1, 1)), v,
               INKPAD_ROWS)


def _region(variant):
    return (..., slice(1, -1), slice(None)) if variant == "nomemset" \
        else (...,)


def turns(old_lib) -> list[dict]:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, x, w, pads, variant, h_t in _cases(dtype):
            if variant is None:
                def new():
                    return ops.stripe_conv(x, w, pads)

                def old():
                    return old_conv(old_lib, x, w, pads, "predicated",
                                    OLD_K9_ROWS)

                ref = ops.stripe_conv_plain(x.float(), w.float(), pads)
            else:
                def new():
                    return ops.inkpad_conv(x, w, variant, h_t)

                def old():
                    return old_conv(old_lib, x, w, pads, variant, h_t)

                ref = ops.inkpad_conv_plain(x.float(), w.float(), variant,
                                            h_t)
            with torch.no_grad():
                region = _region(variant)
                d_new = _diffs(new(), ref, region)["max_rel_diff"]
                d_old = _diffs(old(), ref, region)["max_rel_diff"]
                del ref
                old_ms, new_ms = in_turns(cuda_ms, old, new)
                lib_ms = cuda_ms(lambda: conv_nhwc(x, w, 1, pads))
            flops, moved = stripe_work(*x.shape, w.shape[0], w.shape[1],
                                       w.shape[3], pads, x.element_size())
            b_ms, b_by = bound_ms(flops, moved, dt)
            r = dict(case=label, dtype=dt, old_ms=old_ms, new_ms=new_ms,
                     old_rel=d_old, new_rel=d_new, cudnn_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by)
            r["new_over_old"] = sum(new_ms) / sum(old_ms)
            rows.append(r)
            print(f"{label:34s} {dt:4s} old {old_ms[0]:.4f} new "
                  f"{new_ms[0]:.4f} new {new_ms[1]:.4f} old {old_ms[1]:.4f} "
                  f"ms  new/old "
                  f"{r['new_over_old']:.3f}  cuDNN {lib_ms:.4f}  bound "
                  f"{b_ms:.4f} ({b_by})  rel diff new {d_new:.2e} old "
                  f"{d_old:.2e}", flush=True)
    return rows


def _bf16_cases():
    """The bf16 cases as `_launch` takes them: `legacy` on its padded copy."""
    for label, x, w, pads, variant, h_t in _cases(torch.bfloat16):
        load = "predicated" if variant in (None, "legacy") else variant
        if variant == "legacy":
            x, pads = F.pad(x, (0, 0, 1, 1, 1, 1)), ((0, 0), (0, 0))
        yield label, x, w, pads, load, h_t


def tile_turns() -> list[dict]:
    """bf16: the kernel on each tile the plan can take, in the order of
    `BF16_TILES` and back."""
    rows = []
    for label, x, w, pads, load, h_t in _bf16_cases():
        tiles = []
        for t in tsc.BF16_TILES:
            try:
                tsc.stripe_plan(True, x.shape, w.shape, pads, h_t,
                                tiles=(t,))
                tiles.append(t)
            except RuntimeError:
                pass

        def run(t):
            return lambda: tsc._launch("stripe_conv", x, w, pads, load, h_t,
                                       tiles=(t,))
        order = tiles + tiles[::-1]
        with torch.no_grad():
            times = [cuda_ms(run(t)) for t in order]
        rows.append(dict(case=label, tiles=[list(t) for t in order],
                         ms=times))
        print(f"{label:34s} bf16 tiles " + ", ".join(
            f"{t} {ms:.4f}" for t, ms in zip(order, times)) + " ms",
            flush=True)
    return rows


def grid_turns() -> list[dict]:
    """bf16: as many blocks as the card has multiprocessors, each taking
    tiles that far apart (the plan's default), against one block a tile;
    first, second, second, first."""
    rows = []
    for label, x, w, pads, load, h_t in _bf16_cases():
        def run(sms):
            kw = {} if sms == "card" else {"sms": None}
            return lambda: tsc._launch("stripe_conv", x, w, pads, load, h_t,
                                       **kw)
        with torch.no_grad():
            pers, one = in_turns(cuda_ms, run("card"), run(None))
        rows.append(dict(case=label, persistent_ms=pers,
                         one_block_a_tile_ms=one))
        print(f"{label:34s} bf16 persistent {pers[0]:.4f} {pers[1]:.4f}, "
              f"one block a tile {one[0]:.4f} {one[1]:.4f} ms", flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", required=True, type=Path,
                   help="an earlier checkout with the mma.sync form")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stripe_turns: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name()
    print(card, flush=True)
    res = {"card": card, "turns": turns(build_old(args.old)),
           "tiles": tile_turns(), "grid": grid_turns()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
