"""Multi-dilation 3x3 convolution: kernel K2 and its plain version.

Counterpart of `vspbfr_tpu/ops/pallas_dilated.py` (`dilated_multi_conv`,
the Pallas `_multi_pallas`): N same-input 3x3 "same" dilated convs, outputs
concatenated on channels, with an optional (B, Ci) input scale and a
(B, sum Co) output scale. The CUDA source is `csrc/dilated_conv.cu`; it
reads each branch's weights where they lie (one pointer a branch), so the
forward copies no weights.

`groups=G` is the packed layout's form (`_multi_ref`, pallas_dilated.py:
253): x's Ci channels are G groups (the space-to-depth phases) of Ci/G, each
branch's (3, 3, Ci/G, Co_i) weights are shared by every group, and branch
i's block of the output holds G * Co_i channels, group-major. On the card
one launch covers every group (the group a grid dimension, its channel
offsets applied in the kernel), so no block-diagonal weight is built and no
multiply-add falls on a zero; `grouped_launches` counts these launches
apart (they count in `launches` too).

`dilated_multi_conv` is a `torch.autograd.Function` following the JAX
custom VJP (`_multi_fwd` / `_multi_bwd`, pallas_dilated.py:280-302): its
forward is K2 on the card and the plain version on the CPU. The JAX
backward is XLA's VJP of the plain composition `_multi_ref`, so here the
backward is the same gradient written out in differentiable torch calls
(cuDNN on the card; a double backward runs through it). With zs the
unscaled concatenated output and g_z = g * out_scale:

- d_out_scale = sum over (h, w) of g * zs, reduced in at least f32. zs is
  not recomputed: it is y / out_scale, from the saved output y (the port
  folds the demod into K2's store, as the JAX kernel does; out_scale is a
  demod coefficient, rsqrt(...) > 0);
- per branch i: dw_i by `torch.nn.grad.conv2d_weight` of (x * in_scale,
  g_z_i) at dilation d_i, and the input gradient as the dilated conv of
  g_z_i with the flipped, in/out-swapped kernel (pads d_i); dxs sums them;
  with groups both are cuDNN's grouped convs, and the shared weight's
  gradient is the sum of its groups' (as XLA's VJP of `_multi_ref`);
- dx = dxs * in_scale, d_in_scale = sum over (h, w) of dxs * x.
"""

from __future__ import annotations

import ctypes

import torch

from vspbfr_tpu_torch.ops import _build
from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc
from vspbfr_tpu_torch.ops.fused_act import sum_f32

MAX_BRANCHES = 8


def _tiled(w: torch.Tensor, groups: int) -> torch.Tensor:
    """A shared (3, 3, Ci/G, Co) weight as the grouped conv's (3, 3, Ci/G,
    G*Co)."""
    return w if groups == 1 else torch.cat([w] * groups, dim=-1)


def dilated_multi_conv_plain(x: torch.Tensor, ws, dils,
                             in_scale: torch.Tensor | None = None,
                             out_scale: torch.Tensor | None = None,
                             groups: int = 1) -> torch.Tensor:
    """What K2 computes, in plain torch (`_multi_ref`, pallas_dilated.py:
    253): cuDNN's (grouped) dilated convs and the concatenation."""
    xs = x if in_scale is None else x * in_scale[:, None, None, :]
    out = torch.cat([conv_nhwc(xs, _tiled(w, groups), 1, ((d, d), (d, d)),
                               dilation=d, groups=groups)
                     for w, d in zip(ws, dils)], dim=-1)
    if out_scale is not None:
        out = out * out_scale[:, None, None, :].to(out.dtype)
    return out.contiguous()


def _check(x, ws, dils, groups, in_scale, out_scale) -> list[int]:
    """The wrapper's argument checks; returns the branch widths (of one
    group)."""
    name = "dilated_multi_conv"
    b, _, _, ci = x.shape
    cos = [w.shape[3] for w in ws]
    if not 1 <= len(ws) <= MAX_BRANCHES or len(dils) != len(ws):
        raise ValueError(f"{name}: {len(ws)} weights, {len(dils)} dilations")
    if groups < 1 or ci % groups:
        raise ValueError(f"{name}: {groups} groups do not divide Ci {ci}")
    cg = ci // groups
    if any(tuple(w.shape[:3]) != (3, 3, cg) for w in ws) or min(dils) < 1:
        raise ValueError(f"{name}: weights {[tuple(w.shape) for w in ws]}, "
                         f"dilations {dils}, Ci {ci}, groups {groups}")
    if in_scale is not None and tuple(in_scale.shape) != (b, ci):
        raise ValueError(f"{name}: in_scale {tuple(in_scale.shape)}")
    if (out_scale is not None
            and tuple(out_scale.shape) != (b, groups * sum(cos))):
        raise ValueError(f"{name}: out_scale {tuple(out_scale.shape)}")
    return cos


def _multi_forward(x, ws, dils, groups, in_scale, out_scale) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K2 for
    CUDA tensors."""
    if x.device.type == "cpu":
        return dilated_multi_conv_plain(x, ws, dils, in_scale, out_scale,
                                        groups)
    name = "dilated_multi_conv"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    cos = _check(x, ws, dils, groups, in_scale, out_scale)
    _build.check_cuda_inputs(name, x, *ws, in_scale, out_scale)
    b, h, wd, ci = x.shape
    y = torch.empty((b, h, wd, groups * sum(cos)), dtype=x.dtype,
                    device=x.device)
    # the kernel reads each branch's weights in place, one pointer a branch
    c_ws = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    c_dils = (ctypes.c_int * len(dils))(*dils)
    c_cos = (ctypes.c_int * len(cos))(*cos)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_dilated_multi_conv", x.data_ptr(), c_ws, _build.ptr(in_scale),
                 _build.ptr(out_scale), y.data_ptr(), _build.dtype_code(x),
                 b, h, wd, ci, groups, len(ws), c_dils, c_cos,
                 _build.stream_of(x))
    dilated_multi_conv.launches += 1
    if groups > 1:
        dilated_multi_conv.grouped_launches += 1
    return y


class _DilatedMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dils, groups, x, in_scale, out_scale, *ws):
        y = _multi_forward(x, ws, dils, groups, in_scale, out_scale)
        ctx.save_for_backward(x, in_scale, out_scale, y, *ws)
        ctx.dils, ctx.groups = dils, groups
        return y

    @staticmethod
    def backward(ctx, g):
        x, in_scale, out_scale, y, *ws = ctx.saved_tensors
        need = ctx.needs_input_grad
        grp = ctx.groups
        dosc = None
        if out_scale is not None:
            osc = out_scale[:, None, None, :].to(g.dtype)
            if need[4]:
                dosc = sum_f32(g * (y / osc), (1, 2), out_scale.dtype)
            g = g * osc
        xs = x if in_scale is None else x * in_scale[:, None, None, :]
        dxs, dws, c0 = None, [], 0
        for i, (w, d) in enumerate(zip(ws, ctx.dils)):
            co, cg = w.shape[3], w.shape[2]
            gi = g[..., c0:c0 + grp * co]
            c0 += grp * co
            if need[2] or need[3]:
                # per group: the flipped, in/out-swapped kernel
                wt = _tiled(w.flip((0, 1)).transpose(2, 3), grp).to(g.dtype)
                dxi = conv_nhwc(gi, wt, 1, ((d, d), (d, d)), dilation=d,
                                groups=grp)
                dxs = dxi if dxs is None else dxs + dxi
            dw = None
            if need[5 + i]:
                dw = torch.nn.grad.conv2d_weight(
                    xs.permute(0, 3, 1, 2), (grp * co, cg, 3, 3),
                    gi.permute(0, 3, 1, 2), padding=d, dilation=d,
                    groups=grp)
                # the shared weight's gradient: the sum over its groups
                dw = dw.reshape(grp, co, cg, 3, 3).sum(0)
                dw = dw.permute(2, 3, 1, 0).to(w.dtype)
            dws.append(dw)
        dx = dis = None
        if need[2]:
            dx = dxs if in_scale is None else dxs * in_scale[:, None, None, :]
        if need[3]:
            dis = sum_f32(dxs * x, (1, 2), in_scale.dtype)
        return (None, None, dx, dis, dosc, *dws)


def dilated_multi_conv(x: torch.Tensor, ws, dils, groups: int = 1,
                       in_scale: torch.Tensor | None = None,
                       out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """concat_i(conv(x * in_scale, ws[i], dilation=dils[i], 'same'))
    * out_scale. x (B, H, W, Ci); ws[i] (3, 3, Ci/groups, Co_i) in x's
    dtype, shared by the groups (branch i's output block: groups x Co_i
    channels, group-major); out_scale (B, groups * sum Co_i).
    Differentiable in x, every ws[i], in_scale and out_scale."""
    ws, dils, groups = tuple(ws), tuple(int(d) for d in dils), int(groups)
    _check(x, ws, dils, groups, in_scale, out_scale)
    return _DilatedMulti.apply(dils, groups, x, in_scale, out_scale, *ws)


dilated_multi_conv.launches = 0
dilated_multi_conv.grouped_launches = 0


def dilated_pair_conv(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
                      dil_a: int, dil_b: int, groups: int = 1,
                      in_scale: torch.Tensor | None = None,
                      out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Two branches of `dilated_multi_conv` (`dilated_pair_conv`,
    pallas_dilated.py:344)."""
    return dilated_multi_conv(x, (wa, wb), (dil_a, dil_b), groups,
                              in_scale=in_scale, out_scale=out_scale)
