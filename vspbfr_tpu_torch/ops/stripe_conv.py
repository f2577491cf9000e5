"""The stripe convolution (kernel K9) and its in-kernel padding variants
(kernel K10), each beside its plain version.

Counterparts of `scripts/exp_pallas_conv.py::conv_pallas` (K9: a stride-1
conv of any KHxKW with explicit pads, one matrix-unit dot per tap over a
row stripe staged on chip, f32 accumulation, weights cast to x's dtype,
output in x's dtype) and `scripts/exp_inkpad.py::run` (K10: the same body
for a 3x3 pad-1 conv, with four ways of loading the stripe). Both run
through one CUDA source, `csrc/stripe_conv.cu`: in bf16 a warp-specialised
kernel (TMA into a ring of mbarrier stages, wgmma on the tensor cores), in
f32 the FMA tile K1 and K2 share. `stripe_plan` lays out each launch.

`inkpad_conv`'s variants:

- `legacy`: the wrapper pads x in device memory (the script's `jnp.pad`)
  and the kernel copies the whole stripe;
- `inkpad`: the kernel pads inside: in bf16 the TMA box starts one row
  and column before the tile and the hardware's out-of-bounds fill is the
  padding; in f32 the block zeroes the halo in shared memory and copies
  the interior with the first / middle / last-tile branches;
- `nomemset`: `inkpad` without zeroing the column halo; output columns 0
  and W-1 are undefined (timing only; in bf16 the same load as `inkpad`);
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

import ctypes

import torch
import torch.nn.functional as F

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import _norm_pads, conv_nhwc

VARIANTS = ("legacy", "inkpad", "nomemset", "nobranch")
# the kernel's stripe loads (csrc/stripe_conv.cu `Load`)
_LOAD = {"predicated": 0, "inkpad": 1, "nomemset": 2, "nobranch": 3}
MAX_H_T = 128         # a tile's rows (h_t) divide every tile's pixels
# csrc/stripe_conv.cu `Plan`, field for field
PLAN_FIELDS = ("B", "H", "W", "Ci", "Co", "KH", "KW", "py0", "px0", "OH",
               "OW", "M", "N", "TH", "TW", "SH", "SW", "tiles_x", "tiles_y",
               "co_tiles", "grid", "producer", "stripe_stages", "w_stages",
               "stripe_bytes", "w_bytes", "smem")
SMEM_LIMIT = 227 * 1024   # a block's shared memory on the H100
BOX_LIMIT = 256           # TMA's largest box side
# bf16 tiles (M pixels, N output channels) the kernel is built for, in the
# order a plan tries them after those whose N holds Co; (128, 128) serves
# the thin tiles (h_t 1) whose stripes leave no room for wider ones
BF16_TILES = ((256, 64), (256, 128), (128, 256), (128, 128))
F32_TILE = (128, 64)      # conv_tile.cuh Tiles<float>::N64
STRIPE_ROWS = {128: 8, 256: 16}   # K9's tile rows: 8 x 16 and 16 x 16
ROW_BYTES = 128           # a bf16 stage row: 64 channels, 128-byte swizzle
F32_X_ROW, F32_CK = 80, 16   # conv_tile.cuh kXRow, kCK<float>
STRIPE_STAGES, MIN_W_STAGES, MAX_W_STAGES = 2, 4, 8
EPI_BYTES = 8 * 16 * 128 * 2   # the store's staging: 8 warps' 16 x 128 bf16


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


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _geometry(m, n, th, b, oh, ow, co, kh, kw, sms) -> dict:
    tw = m // th
    g = dict(M=m, N=n, TH=th, TW=tw, SH=th + kh - 1, SW=tw + kw - 1,
             tiles_x=-(-ow // tw), tiles_y=-(-oh // th), co_tiles=-(-co // n))
    tiles = b * g["tiles_x"] * g["tiles_y"] * g["co_tiles"]
    g["grid"] = min(tiles, sms) if sms else tiles
    return g


def stripe_plan(bf16: bool, x_shape, w_shape, pads, th: int | None = None,
                aligned: bool = True, tiles=BF16_TILES,
                sms: int | None = None) -> dict:
    """The launch plan of one K9 / K10 call (csrc/stripe_conv.cu `Plan`):
    x (B, H, W, Ci), w (KH, KW, Ci, Co), pads ((py0, py1), (px0, px1)), th
    the tile's rows (K10's h_t; None: K9's `STRIPE_ROWS`), `aligned`
    whether x's and the weights' data start on 16-byte boundaries, `sms`
    the card's multiprocessors (bf16: that many blocks at most, each
    taking tiles `grid` apart; None: one block a tile).

    bf16: of `tiles`, those whose N holds Co first, the first whose
    stripe box fits TMA and whose stages fit a block: a ring of
    `STRIPE_STAGES` stripes and as many weight stages as fit (4 to 8);
    the TMA producer exactly when a pixel's Ci channels are a multiple of
    16 bytes and `aligned`, else plain loads into the same ring. f32:
    `F32_TILE`, one stage of the stripe and of every tap's weights;
    cp.async under the same condition. Raises RuntimeError when no tile
    fits a block's shared memory or TMA's box sides."""
    b, h, wd, ci = x_shape
    kh, kw, _, co = w_shape
    (py0, py1), (px0, px1) = pads
    oh, ow = h + py0 + py1 - kh + 1, wd + px0 + px1 - kw + 1
    itemsize = 2 if bf16 else 4
    base = dict(B=b, H=h, W=wd, Ci=ci, Co=co, KH=kh, KW=kw, py0=py0,
                px0=px0, OH=oh, OW=ow,
                producer=int((ci * itemsize) % 16 == 0 and aligned))
    if not bf16:
        m, n = F32_TILE
        g = _geometry(m, n, th or STRIPE_ROWS[m], b, oh, ow, co, kh, kw,
                      None)
        stripe = g["SH"] * g["SW"] * F32_X_ROW
        wbytes = kh * kw * F32_CK * (n * 4 + 16)
        smem = stripe + wbytes + F32_CK * 4
        if smem > SMEM_LIMIT:
            raise RuntimeError(f"stripe_conv: {smem} bytes of stripe and "
                               f"weights exceed a block's {SMEM_LIMIT}")
        return {**base, **g, "stripe_stages": 1, "w_stages": 1,
                "stripe_bytes": stripe, "w_bytes": wbytes, "smem": smem}
    fits = [t for t in tiles if t[1] >= min(co, 256)]
    for m, n in fits + [t for t in tiles if t not in fits]:
        g = _geometry(m, n, th or STRIPE_ROWS[m], b, oh, ow, co, kh, kw,
                      sms)
        if base["producer"] and max(g["SH"], g["SW"]) > BOX_LIMIT:
            continue
        stripe = _up(g["SH"] * g["SW"] * ROW_BYTES, 1024)
        wbytes = n * ROW_BYTES
        # alignment slack, stripes, the store's staging
        fixed = 1024 + STRIPE_STAGES * stripe + EPI_BYTES
        stages = min(MAX_W_STAGES,
                     (SMEM_LIMIT - fixed - 16 * (STRIPE_STAGES
                                                 + MAX_W_STAGES)) // wbytes)
        if stages < MIN_W_STAGES:
            continue
        smem = fixed + stages * wbytes + 16 * (STRIPE_STAGES + stages)
        return {**base, **g, "stripe_stages": STRIPE_STAGES,
                "w_stages": stages, "stripe_bytes": stripe,
                "w_bytes": wbytes, "smem": smem}
    raise RuntimeError(f"stripe_conv: no bf16 tile of x {tuple(x_shape)}, w "
                       f"{tuple(w_shape)}, rows {th} fits a block's "
                       f"{SMEM_LIMIT} bytes and TMA's {BOX_LIMIT}-wide boxes")


def _launch(name, x, w, pads, load, th, **plan_kw) -> torch.Tensor:
    """One K9 / K10 launch on CUDA tensors, laid out by `stripe_plan`; the
    weights go to the kernel in x's dtype, as (KH, KW, Co, Ci) in bf16 (the
    wgmma B operand is K-major) and as they are, HWIO, in f32."""
    oh, ow = _out_shape(name, x, w, pads)
    b, h, wd, ci = x.shape
    co = w.shape[3]
    bf16 = x.dtype == torch.bfloat16
    wt = w.to(x.dtype)
    wt = wt.permute(0, 1, 3, 2).contiguous() if bf16 else wt.contiguous()
    _build.check_cuda_inputs(name, x, wt)
    plan = stripe_plan(bf16, x.shape, w.shape, pads, th,
                       aligned=x.data_ptr() % 16 == 0
                       and wt.data_ptr() % 16 == 0,
                       **{"sms": _build.multiprocessors(x.device),
                          **plan_kw})
    lib = _build.load_library()
    y = torch.empty((b, oh, ow, co), dtype=x.dtype, device=x.device)
    fields = (ctypes.c_int * len(PLAN_FIELDS))(*(plan[k]
                                                 for k in PLAN_FIELDS))
    with torch.cuda.device(x.device):
        lib.call("vspbfr_stripe_conv", x.data_ptr(), wt.data_ptr(),
                 y.data_ptr(), _build.dtype_code(x), _LOAD[load], fields,
                 _build.stream_of(x))
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
    y = _launch(name, x, w, pads, "predicated", None)
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
