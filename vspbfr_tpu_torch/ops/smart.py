"""The fused SMART core: kernel K5 and its plain version.

Counterpart of `vspbfr_tpu/ops/pallas_smart.py` (`smart_core`, the Pallas
`_smart_fused_impl`) in the unpacked layout. The CUDA source is
`csrc/smart_fused.cu`.

    branches = concat_k(demod_k * dilconv_k(x * style, ws_k / sqrt(9 C)))
    out      = conv3x3(branches, wf / sqrt(9 * 4Cb))

for the dilations (1, 2, 4, 8), the branch tensor zero-padded by 1 at the
image border: the fusion conv's output before its bias, noise and
activation. x (B, H, W, C), style (B, C) (the modulation's output), ws four
(3, 3, C, Cb) kernels, wf (3, 3, 4Cb, Cout).

`smart_core_plain` is the composition `SMARTLayer` runs, in plain torch:
`dilated_multi_conv_plain` with the demod from `demod_coeffs` (as
`modulated_conv2d_multi` builds it), then `dense_conv_plain`.

`smart_core` is a `torch.autograd.Function`: its forward is the plain
version for tensors on the CPU and K5 for CUDA tensors (a CUDA tensor
launches or raises; a shape `smart_plan` cannot lay out raises). Its
backward follows `_smart_fused_bwd` (pallas_smart.py:259-265), the
gradient of the composition: it recomputes the composition from the saved
inputs with the port's differentiable kernels (K2's Function, then K1's)
and takes `torch.autograd.grad` of it, so K2 and K1 launch in K5's
backward as XLA's convs run in JAX's. One backward is supported, not a
double backward.

As in the JAX package, `SMARTLayer` does not call K5: the composition is
the production path, and `python -m vspbfr_tpu_torch.cli.profile --smart`
measures K5 against it.

`smart_plan` lays out each K5 launch (the C struct `Plan` of
`csrc/smart_fused.cu`, field for field): the tile, the cluster of blocks
that shares it, each block's output channels and the shared memory.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import dense_conv, dense_conv_plain
from vspbfr_tpu_torch.ops.dilated_conv import (
    dilated_multi_conv,
    dilated_multi_conv_plain,
)
from vspbfr_tpu_torch.ops.modulated_conv import demod_coeffs

RATES = (1, 2, 4, 8)
# csrc/smart_fused.cu `Plan`, field for field
PLAN_FIELDS = ("B", "H", "W", "C", "Cb", "Co", "kind", "TH", "TW", "tiles_x",
               "tiles_y", "cluster", "co_split", "slabs", "buf_bytes", "smem")
SMEM_LIMIT = 227 * 1024   # a block's shared memory on the H100
CLUSTERS = (1, 2, 4, 8)   # blocks that share a tile (8: the portable most)
SMS = 132                 # the H100's multiprocessors
X_ROW, PASS_BYTES = 80, 64   # conv_tile.cuh kXRow, kPassBytes
FUSION_N = 64             # the fusion body's output channels
# the kinds the kernel is built for, by dtype (bf16?): (tile rows, tile
# columns, the branch body's columns); the branch body's pixels cover the
# (TH + 2) x (TW + 2) branch tile. bf16: Cb <= 16, <= 32, more; f32: Cb <=
# 16, 4Cb <= 256, more
KINDS = {True: ((16, 16, 16), (16, 16, 32), (8, 8, 64)),
         False: ((16, 16, 16), (8, 8, 32), (4, 8, 32))}


def _scales(ws, wf) -> tuple[float, float]:
    """The branch and fusion weights' 1/sqrt(fan_in)."""
    c, cb = ws[0].shape[2], ws[0].shape[3]
    return 1.0 / math.sqrt(9 * c), 1.0 / math.sqrt(9 * 4 * cb)


def _demod(x, style, ws, scale, demodulate, eps):
    if not demodulate:
        return None
    return torch.cat([demod_coeffs(w, style, scale, eps) for w in ws],
                     -1).to(x.dtype).contiguous()


def _composition(x, style, ws, wf, demodulate, eps, multi, conv):
    """The SMART core as two convs: multi (K2 or its plain version) for the
    branches with the demod in its store, conv (K1 or its plain version)
    for the fusion."""
    scale, scale_f = _scales(ws, wf)
    br = multi(x.contiguous(),
               [(scale * w).to(x.dtype).contiguous() for w in ws], RATES,
               in_scale=style.to(x.dtype).contiguous(),
               out_scale=_demod(x, style, ws, scale, demodulate, eps))
    return conv(br, (scale_f * wf).to(x.dtype).contiguous(),
                ((1, 1), (1, 1)))


def smart_core_plain(x: torch.Tensor, style: torch.Tensor, ws, wf,
                     demodulate: bool = True, eps: float = 1e-8):
    """What K5 computes, in plain torch."""
    return _composition(x, style, list(ws), wf, demodulate, eps,
                        dilated_multi_conv_plain, dense_conv_plain)


def _check(x, style, ws, wf) -> None:
    name = "smart_core"
    b, _, _, c = x.shape
    cb = ws[0].shape[3] if len(ws) == len(RATES) else 0
    if (len(ws) != len(RATES) or cb < 1
            or any(tuple(w.shape) != (3, 3, c, cb) for w in ws)
            or tuple(wf.shape[:3]) != (3, 3, 4 * cb)
            or tuple(style.shape) != (b, c)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, style "
                         f"{tuple(style.shape)}, ws "
                         f"{[tuple(w.shape) for w in ws]}, wf "
                         f"{tuple(wf.shape)}")


def _kind(bf16: bool, cb: int) -> int:
    if cb <= 16:
        return 0
    if bf16:
        return 1 if cb <= 32 else 2
    return 1 if 4 * cb <= 256 else 2


def smart_plan(bf16: bool, b: int, h: int, w: int, c: int, cb: int, co: int,
               sms: int = SMS, cluster: int | None = None) -> dict:
    """The launch plan of one K5 call (csrc/smart_fused.cu `Plan`, with
    `blocks`, `seg`, `halo` and `stage_bytes` beside it): x (b, h, w, c),
    branch width cb, co output channels, `sms` the card's multiprocessors.

    - kind and tile by dtype and cb (`KINDS`): 16x16 while a branch tile of
      4cb channels fits beside the dilation-8 stripe (cb <= 16; bf16 cb <=
      32), else 8x8 (bf16; f32 up to 4cb = 256) or 4x8 (f32); `halo` is
      the branch pixels over the output pixels, (TH + 2)(TW + 2) / (TH TW);
    - the branch tile in `slabs` of 64 bytes of channels, 80-byte rows
      (`buf_bytes`); shared memory (`smem`): all of a block's (one block
      a multiprocessor: every plan needs more than half of it), the rest
      past the branch tile a ring of stages, two at a time where they
      fit; the largest stage must: the branch phase's (the dilation-8
      stripe, a pass's weights of `seg` columns, its style) or the
      fusion's (a slab's weights of 64 columns);
    - `cluster`: the fewest blocks a tile (of `CLUSTERS`, dividing 4cb) that
      give at least `sms` blocks, else the most; given, it is checked.
      Each block computes 4cb / cluster branch channels and `co_split`
      output channels (a multiple of 8).
    Raises ValueError for a shape whose plan exceeds a block's shared
    memory, or a cluster that does not divide 4cb."""
    itemsize = 2 if bf16 else 4
    ck = PASS_BYTES // itemsize
    kind = _kind(bf16, cb)
    th, tw, seg = KINDS[bf16][kind]
    bp = (th + 2) * (tw + 2)
    slabs = -(-4 * cb // ck)
    buf = slabs * bp * X_ROW
    d = RATES[-1]
    branch = ((th + 2 + 2 * d) * (tw + 2 + 2 * d) * X_ROW
              + 9 * ck * (seg * itemsize + 16) + ck * 4)
    fusion = 9 * ck * (FUSION_N * itemsize + 16)
    need = buf + max(branch, fusion)
    if need > SMEM_LIMIT:
        raise ValueError(f"smart_core: a {th}x{tw} tile of {4 * cb} branch "
                         f"channels needs {need} bytes of shared memory, "
                         f"more than a block's {SMEM_LIMIT}")
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    tiles = b * tiles_x * tiles_y
    splits = [s for s in CLUSTERS if 4 * cb % s == 0]
    if cluster is None:
        cluster = next((s for s in splits if tiles * s >= sms), splits[-1])
    elif cluster not in splits:
        raise ValueError(f"smart_core: a cluster of {cluster} does not split "
                         f"{4 * cb} branch channels")
    return dict(B=b, H=h, W=w, C=c, Cb=cb, Co=co, kind=kind, TH=th, TW=tw,
                tiles_x=tiles_x, tiles_y=tiles_y, cluster=cluster,
                co_split=8 * -(-co // (8 * cluster)), slabs=slabs,
                buf_bytes=buf, smem=SMEM_LIMIT, blocks=tiles * cluster,
                seg=seg, halo=bp / (th * tw), stage_bytes=max(branch, fusion))


def _smart_forward(x, style, ws, wf, demodulate, eps,
                   cluster=None) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K5 for
    CUDA tensors (`cluster`: the plan's cluster, if given)."""
    if x.device.type == "cpu":
        return smart_core_plain(x, style, ws, wf, demodulate, eps)
    name = "smart_core"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    b, h, w, c = x.shape
    cb, co = ws[0].shape[3], wf.shape[3]
    scale, scale_f = _scales(ws, wf)
    dt = x.dtype
    wb = torch.cat([(scale * w_).to(dt) for w_ in ws], dim=3).contiguous()
    sty = style.to(dt).contiguous()
    dv = _demod(x, style, ws, scale, demodulate, eps)
    wfs = (scale_f * wf).to(dt).contiguous()
    _build.check_cuda_inputs(name, x, sty, wb, dv, wfs)
    plan = smart_plan(dt == torch.bfloat16, b, h, w, c, cb, co,
                      _build.multiprocessors(x.device), cluster)
    fields = (ctypes.c_int * len(PLAN_FIELDS))(*(plan[k]
                                                 for k in PLAN_FIELDS))
    y = torch.empty((b, h, w, co), dtype=dt, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_smart_fused", x.data_ptr(), sty.data_ptr(),
                 wb.data_ptr(), _build.ptr(dv), wfs.data_ptr(), y.data_ptr(),
                 _build.dtype_code(x), fields, _build.stream_of(x))
    smart_core.launches += 1
    return y


class _SmartCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, demodulate, eps, x, style, wf, *ws):
        ctx.save_for_backward(x, style, wf, *ws)
        ctx.demodulate, ctx.eps = demodulate, eps
        return _smart_forward(x, style, ws, wf, demodulate, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            x, style, wf, *ws = leaves
            out = _composition(x, style, ws, wf, ctx.demodulate, ctx.eps,
                               dilated_multi_conv, dense_conv)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (None, None, *[next(grads) if n else None for n in need])


def smart_core(x: torch.Tensor, style: torch.Tensor, ws, wf,
               demodulate: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """K5: the SMART core (see the module docstring), (B, H, W, Cout) in
    x's dtype. Differentiable in x, style, every ws[i] and wf."""
    ws = list(ws)
    _check(x, style, ws, wf)
    return _SmartCore.apply(bool(demodulate), float(eps), x.contiguous(),
                            style, wf, *ws)


smart_core.launches = 0
