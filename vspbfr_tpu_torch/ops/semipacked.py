"""Width-only (semi-packed) space-to-depth layout.

Counterpart of `vspbfr_tpu/ops/semipacked.py`. Only the x axis is packed:

    (B, H, 2w, C) -> (B, H, w, 2C),  out[..., i, j, b*C + c] = x[..., i, 2j + b, c]

so a stride-1 'same' conv on the width-packed tensor is one conv with a
kernel re-assembled from the unpacked one at call time (the parameters stay
the unpacked layout's):

  * dilation 1 -> one dense conv with the assembled (k, kx', 2Ci, 2Co)
    kernel, rows literal, pads ((pad, pad), (px0, px1)): K1 through
    `ops/packed.py::_conv`, so `in_scale` folds into K1's input stripe;
  * even dilation d -> the x phases never mix: with `groups_hint` a
    `groups=2` conv at dilation (d, d/2), else the block-diagonal dense
    kernel at the same dilation (`F.conv2d` either way: the JAX package
    runs both through XLA's `conv_general_dilated`, outside Pallas);
  * odd dilations above 1 raise, as in JAX (no model uses them);
  * 1x1 conv -> the phases map independently: a matmul.

No model wires this layout: the JAX package measured it on the TPU and
kept the 2x2 layout (its docstring's verdict). The port carries it, as
the JAX package does, as a library with tests; `chip_smoke.py` phase 16
times its dilation-1 conv on the card.
"""

from __future__ import annotations

import functools

import torch

from vspbfr_tpu_torch.ops.dense_conv import conv_nhwc
from vspbfr_tpu_torch.ops.packed import _conv


# ---------------------------------------------------------------------------
# layout converters (views and permutes)
# ---------------------------------------------------------------------------

def space_to_width(x: torch.Tensor) -> torch.Tensor:
    """(B, H, 2w, C) -> (B, H, w, 2C), x-phase-major channels."""
    b, h, ww, c = x.shape
    return x.reshape(b, h, ww // 2, 2 * c)


def width_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_width: (B, H, w, 2C) -> (B, H, 2w, C)."""
    b, h, w, c2 = x.shape
    return x.reshape(b, h, 2 * w, c2 // 2)


def packed_to_semipacked(x: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 4C) 2x2-packed at res 2h -> (B, 2h, w, 2C) width-packed:
    the y phase goes back to rows, the x phase stays in the channels."""
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, 2, c4 // 2).permute(0, 1, 3, 2, 4)
    return x.reshape(b, 2 * h, w, c4 // 2)


def semipacked_to_packed(x: torch.Tensor) -> torch.Tensor:
    """Inverse of packed_to_semipacked."""
    b, hh, w, c2 = x.shape
    x = x.reshape(b, hh // 2, 2, w, c2).permute(0, 1, 3, 2, 4)
    return x.reshape(b, hh // 2, w, 2 * c2)


def pack_vector_w(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector tiled over the two x-phase groups: (..., C) ->
    (..., 2C)."""
    return torch.cat([v, v], dim=-1)


# ---------------------------------------------------------------------------
# kernel assembly (x axis packed, y axis literal)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tap_map(k: int) -> tuple[tuple, tuple[int, int]]:
    """The static tap map of the assembled d = 1 kernel: for each column u
    of the assembled kernel (offset x0), each input phase e and output
    phase a, the unpacked tap t that lands there, or None. Output x
    2m + a reads input x 2p + e at p - m = (a + t - pad - e) / 2; for a
    fixed (u, e, a) at most one t does, so the kernel is a selection of
    the unpacked taps and zeros (`_assemble_x`, semipacked.py:88)."""
    pad = (k - 1) // 2
    hits = {(a, e, (a + t - pad - e) // 2): t
            for a in range(2) for e in range(2) for t in range(k)
            if (a + t - pad - e) % 2 == 0}
    us = [u for (_, _, u) in hits]
    x0, x1 = min(us), max(us)
    table = tuple(tuple(tuple(hits.get((a, e, u)) for a in range(2))
                        for e in range(2)) for u in range(x0, x1 + 1))
    return table, (-x0, x1)


def _assemble_x(w: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """The semi-packed kernel of a stride-1 'same' conv at d = 1: w (k, k,
    Ci, Co) unpacked -> (wp (k, kx', 2Ci, 2Co), (px0, px1)). One stack of
    the weight's tap columns and a zero block, in the order of the static
    tap map: no index tensor, so nothing is copied from the host, and the
    assembly is differentiable on the weight's device."""
    k, _, ci, co = w.shape
    table, pads = _tap_map(k)
    zero = w.new_zeros((k, ci, co))
    blocks = [w[:, t] if t is not None else zero
              for col in table for row in col for t in row]
    # (k, kx', e, a, ci, co) -> (k, kx', e, ci, a, co)
    wp = torch.stack(blocks, dim=1).reshape(k, len(table), 2, 2, ci, co)
    wp = wp.permute(0, 1, 2, 4, 3, 5).reshape(k, len(table), 2 * ci, 2 * co)
    return wp, pads


def conv2d_semipacked(x: torch.Tensor, w: torch.Tensor, dilation: int = 1,
                      groups_hint: bool = True,
                      in_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 'same' conv on a width-packed tensor ==
    space_to_width(conv(width_to_space(x))).

    x (B, H, w, 2Ci) width-packed; w (k, k, Ci, Co) the unpacked kernel;
    in_scale (B, 2Ci) per-sample input scale (`pack_vector_w` of the
    unpacked one), folded into K1 at dilation 1 and applied up front at
    even dilations."""
    k = w.shape[0]
    if dilation % 2 == 0:
        d2 = dilation // 2
        pady, padx = ((k - 1) * dilation) // 2, ((k - 1) * d2) // 2
        pads = ((pady, pady), (padx, padx))
        if in_scale is not None:
            x = x * in_scale[:, None, None, :].to(x.dtype)
        if groups_hint:
            return conv_nhwc(x, torch.cat([w, w], dim=-1), 1, pads,
                             dilation=(dilation, d2), groups=2)
        zero = torch.zeros_like(w)
        wd = torch.cat([torch.cat([w, zero], dim=-1),
                        torch.cat([zero, w], dim=-1)], dim=2)
        return conv_nhwc(x, wd, 1, pads, dilation=(dilation, d2))
    if dilation != 1:
        raise NotImplementedError("odd dilation > 1 (unused by the models)")
    wp, padx = _assemble_x(w)
    pady = (k - 1) // 2
    return _conv(x, wp, (pady, pady), padx,
                 in_scale=None if in_scale is None
                 else in_scale.to(x.dtype).contiguous())


def conv1x1_semipacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv on the width-packed layout: the two x phases map
    independently with the shared weight. x (B, H, w, 2Ci); w (1, 1, Ci,
    Co) or (Ci, Co)."""
    if w.dim() == 4:
        w = w[0, 0]
    b, h, wd, _ = x.shape
    ci, co = w.shape
    out = x.reshape(b, h, wd, 2, ci) @ w.to(x.dtype)
    return out.reshape(b, h, wd, 2 * co)
