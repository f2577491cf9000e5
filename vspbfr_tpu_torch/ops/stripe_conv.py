"""The stripe convolution (kernel K9) and its in-kernel padding variants
(kernel K10), each beside its plain version.

Counterparts of `scripts/exp_pallas_conv.py::conv_pallas` (K9: a stride-1
conv of any KHxKW with explicit pads, one matrix-unit dot per tap over a
row stripe staged on chip, f32 accumulation, weights cast to x's dtype,
output in x's dtype) and `scripts/exp_inkpad.py::run` (K10: the same body
for a 3x3 pad-1 conv, with four ways of loading the stripe). Both run
through one CUDA body, `csrc/stripe_conv.cu`; in bf16 its per-tap products
run on the tensor cores, in f32 as FMA on the CUDA cores.

`inkpad_conv`'s variants:

- `legacy`: the wrapper pads x in device memory (the script's `jnp.pad`)
  and the kernel copies the whole stripe;
- `inkpad`: the kernel zeroes the halo in shared memory and copies the
  interior with the first / middle / last-tile branches;
- `nomemset`: `inkpad` without zeroing the column halo; output columns 0
  and W-1 are undefined (timing only);
- `nobranch`: every tile copies input rows [s, s + h_t + 2) with
  s = min(tile * h_t, H - h_t - 2) and no row shift, its column halo
  zeroed (timing only): the "stripe model" below. The script hard-codes
  H = 256 there; here it is H.

The plain versions: `stripe_conv_plain` is `conv_nhwc` with the pads;
`inkpad_conv_plain` is the pad-1 conv for `legacy`, `inkpad` and
`nomemset` (NaN in output columns 0 and W-1 for `nomemset`, where the
kernel's result is undefined by design), and for `nobranch` the stripe
model: the conv valid along y and padded by 1 along x, each output row
taken from its tile's rows starting at s.

No product path calls either: `python -m vspbfr_tpu_torch.cli.profile
--stripe_conv` and `--inkpad` measure them. The scripts have no gradient,
and neither have these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import _norm_pads, conv_nhwc

VARIANTS = ("legacy", "inkpad", "nomemset", "nobranch")
# the kernel's stripe loads (csrc/stripe_conv.cu `Load`)
_LOAD = {"predicated": 0, "inkpad": 1, "nomemset": 2, "nobranch": 3}
MAX_H_T = 128                      # a tile's rows divide its 128 (f32) or
STRIPE_ROWS = 8                    # 256 (bf16) pixels; K9 takes 8 rows


def stripe_conv_plain(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """What K9 computes, in plain torch: w cast to x's dtype, the conv with
    the pads."""
    return conv_nhwc(x, w.to(x.dtype), 1, pads).contiguous()


def stripe_rows(h: int, h_t: int) -> torch.Tensor:
    """For each output row of `nobranch`, the first row of the y-valid conv
    it reads: its tile's s = min(tile * h_t, h - h_t - 2), plus its offset
    in the tile."""
    oy = torch.arange(h)
    s = torch.clamp((oy // h_t) * h_t, max=h - h_t - 2)
    return s + oy % h_t


def inkpad_conv_plain(x: torch.Tensor, w: torch.Tensor, variant: str,
                      h_t: int = 16) -> torch.Tensor:
    """What K10 computes for `variant`, in plain torch (see the module
    docstring)."""
    _check_inkpad(x, w, variant, h_t)
    if variant == "nobranch":
        valid_y = conv_nhwc(x, w.to(x.dtype), 1, ((0, 0), (1, 1)))
        rows = stripe_rows(x.shape[1], h_t).to(x.device)
        return valid_y.index_select(1, rows).contiguous()
    y = stripe_conv_plain(x, w, ((1, 1), (1, 1)))
    if variant == "nomemset":
        y[:, :, 0] = float("nan")
        y[:, :, -1] = float("nan")
    return y


def _out_shape(name, x, w, pads) -> tuple[int, int]:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}")
    _, h, wd, ci = x.shape
    kh, kw, wci, _ = w.shape
    py0, py1, px0, px1 = _norm_pads(pads)
    oh, ow = h + py0 + py1 - kh + 1, wd + px0 + px1 - kw + 1
    if wci != ci or min(py0, py1, px0, px1) < 0 or oh < 1 or ow < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"pads {pads}")
    return oh, ow


def _launch(name, x, w, pads, load, th) -> torch.Tensor:
    """One K9 / K10 launch on CUDA tensors; the weights go to the kernel as
    (KH, KW, Co, Ci) in x's dtype. A kernel whose stripe and weights exceed
    a block's shared memory fails the launch, which raises."""
    oh, ow = _out_shape(name, x, w, pads)
    b, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    wt = w.to(x.dtype).permute(0, 1, 3, 2).contiguous()
    _build.check_cuda_inputs(name, x, wt)
    lib = _build.load_library()
    py0, _, px0, _ = _norm_pads(pads)
    y = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        lib.call("vspbfr_stripe_conv", x.data_ptr(), wt.data_ptr(),
                 y.data_ptr(), _build.dtype_code(x), _LOAD[load], b, h, wd,
                 ci, co, kh, kw, py0, px0, oh, ow, th, _build.stream_of(x))
    return y


def stripe_conv(x: torch.Tensor, w: torch.Tensor, pads) -> torch.Tensor:
    """K9: x (B, H, W, Ci), w (KH, KW, Ci, Co) (cast to x's dtype), pads
    ((py0, py1), (px0, px1)), each >= 0 -> (B, OH, OW, Co) in x's dtype."""
    name = "stripe_conv"
    pads = tuple(tuple(p) for p in pads)
    _out_shape(name, x, w, pads)
    if x.device.type == "cpu":
        return stripe_conv_plain(x, w, pads)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    y = _launch(name, x, w, pads, "predicated", STRIPE_ROWS)
    stripe_conv.launches += 1
    return y


def _check_inkpad(x, w, variant, h_t) -> None:
    name = "inkpad_conv"
    if variant not in VARIANTS:
        raise ValueError(f"{name}: variant {variant!r}, not one of "
                         f"{VARIANTS}")
    if h_t < 1 or h_t > MAX_H_T or h_t & (h_t - 1):
        raise ValueError(f"{name}: h_t {h_t} is not a power of two up to "
                         f"{MAX_H_T}")
    if x.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         "a 3x3 kernel over x's channels")
    if variant == "nobranch" and x.shape[1] < h_t + 2:
        raise ValueError(f"{name}: nobranch needs H >= h_t + 2, got H "
                         f"{x.shape[1]}, h_t {h_t}")


def inkpad_conv(x: torch.Tensor, w: torch.Tensor, variant: str,
                h_t: int = 16) -> torch.Tensor:
    """K10: the 3x3 pad-1 conv of x (B, H, W, Ci) with w (3, 3, Ci, Co)
    through K9's body, h_t output rows per stripe tile, the stripe loaded
    as `variant` says (see the module docstring)."""
    name = "inkpad_conv"
    h_t = int(h_t)
    _check_inkpad(x, w, variant, h_t)
    if x.device.type == "cpu":
        return inkpad_conv_plain(x, w, variant, h_t)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if variant == "legacy":
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        y = _launch(name, xp, w, ((0, 0), (0, 0)), "predicated", h_t)
    else:
        y = _launch(name, x, w, ((1, 1), (1, 1)), variant, h_t)
    inkpad_conv.launches += 1
    return y


stripe_conv.launches = 0
inkpad_conv.launches = 0
