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
launches or raises). Its backward follows `_smart_fused_bwd`
(pallas_smart.py:259-265), the gradient of the composition: it recomputes
the composition from the saved inputs with the port's differentiable
kernels (K2's Function, then K1's) and takes `torch.autograd.grad` of it,
so K2 and K1 launch in K5's backward as XLA's convs run in JAX's. One
backward is supported, not a double backward.

As in the JAX package, `SMARTLayer` does not call K5: the composition is
the production path, and `python -m vspbfr_tpu_torch.cli.profile --smart`
measures K5 against it.
"""

from __future__ import annotations

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


def smart_tile(h: int, w: int, cb: int) -> int:
    """The output tile side K5 takes for an (h, w) image with branch width
    cb (8 or 4; it sets the halo recompute, (T+2)^2 / T^2)."""
    return _build.load_library().query("vspbfr_smart_tile", h, w, cb)


def _smart_forward(x, style, ws, wf, demodulate, eps) -> torch.Tensor:
    """The forward primitive: the plain version for CPU tensors, K5 for
    CUDA tensors."""
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
    y = torch.empty((b, h, w, co), dtype=dt, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        lib.call("vspbfr_smart_fused", x.data_ptr(), sty.data_ptr(),
                 wb.data_ptr(), _build.ptr(dv), wfs.data_ptr(), y.data_ptr(),
                 _build.dtype_code(x), b, h, w, c, cb, co,
                 _build.stream_of(x))
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
