"""ADA: adaptive discriminator augmentation, NHWC.

Counterpart of `vspbfr_tpu/losses/ada.py` (the reference's
`non_leaking.py:481-934`): the same transform distribution, geometric
(x-flip, 90-degree rotations, integer translate, isotropic and anisotropic
lognormal scale, pre / post rotation with p_rot = 1 - sqrt(1 - p),
fractional translate) applied through the antialiased chain reflect pad ->
SYM6 2x up -> bilinear warp -> SYM6 2x down, and color (brightness,
contrast, luma flip, hue rotation, saturation) as homogeneous 4x4
matrices; each transform applies per sample with probability p.

Sampling is split in two. `draw_augment` takes the raw random numbers from
an explicit `torch.Generator`, one entry per sub-key of the JAX sampler
(the flips, r90, the uniforms in their ranges, standard normals, and one
uniform in [0, 1) per gate); `affine_from_draws` / `color_from_draws`
build the matrices from them. A gate is `u < p` with p a 0-d tensor on the
device, which is what `jax.random.bernoulli` computes, so a new p costs no
host sync; a test that hands in JAX's draws gets JAX's matrices.

The FIR passes are per-channel 12-tap filters with zero insertion, the
JAX package's definition `_upfir_x` / `_upfir_y`, as sums of shifted
slices (`_fir`), not its banded-matmul form (`_upfir_x_mm`, written for
the TPU's matrix unit). The padding is static, width / 4 + the kernel
margin, as in the JAX package. Everything here is twice differentiable in
the image (R1 runs a double backward through `augment`).

The controller (`ADAState`, `ada_update`) keeps its state as 0-d tensors
and decides with `torch.where`, so it reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# SYM6 wavelet taps (`non_leaking.py:519-532` upstream)
SYM6 = (
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
)
LUMA_AXIS = (1 / math.sqrt(3),) * 3
N_AFFINE_GATES = 8
N_COLOR_GATES = 5


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on like's device. On the card it goes through a
    pinned buffer and an asynchronous copy: a plain host-to-device copy
    would wait for the stream."""
    t = torch.as_tensor(np.asarray(values, np.float32))
    if like.device.type == "cuda":
        return t.pin_memory().to(like.device, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# homogeneous matrices (batched)
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small (..., n, n) matrices as elementwise products summed
    in index order: the same roundings on the card and the CPU (a library
    matmul sums in its own order, and an ulp in the warp's matrix moves
    each sample by ~1e-4 px at 512 px)."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _eye(batch: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, device=like.device).expand(batch, n, n).clone()


def translate_mat(tx, ty):
    m = _eye(tx.shape[0], 3, tx)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def rotate_mat(theta):
    m = _eye(theta.shape[0], 3, theta)
    c, s = torch.cos(theta), torch.sin(theta)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def scale_mat(sx, sy):
    m = _eye(sx.shape[0], 3, sx)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def translate3d_mat(tx, ty, tz):
    m = _eye(tx.shape[0], 4, tx)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = tx, ty, tz
    return m


def scale3d_mat(sx, sy, sz):
    m = _eye(sx.shape[0], 4, sx)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = sx, sy, sz
    return m


def luma_flip_mat(axis, flip):
    """Householder reflection about the luma axis, where flip > 0.5."""
    v = np.asarray((*axis, 0.0), np.float32)
    h = _const(np.eye(4, dtype=np.float32) - np.float32(2) * np.outer(v, v),
               flip)
    return torch.where(flip[:, None, None] > 0.5, h,
                       _eye(flip.shape[0], 4, flip))


def rotate3d_mat(axis, theta):
    """Rodrigues rotation about `axis`, embedded in a homogeneous 4x4."""
    u = np.asarray(axis, np.float32)
    k = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]],
                 np.float32)
    k, kk = _const(np.stack([k, k @ k]), theta)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    m = _eye(theta.shape[0], 4, theta)
    m[:, :3, :3] = torch.eye(3, device=theta.device) + s * k + (1 - c) * kk
    return m


def saturation_mat(axis, s):
    u = np.asarray(axis, np.float32)
    pr, rest = _const(np.stack([np.outer(u, u),
                                np.eye(3, dtype=np.float32)
                                - np.outer(u, u)]), s)
    m = _eye(s.shape[0], 4, s)
    m[:, :3, :3] = pr + rest * s[:, None, None]
    return m


def _random_apply(u, p, mat_c, mat):
    """mat_c @ mat for the samples whose gate draw u is below p."""
    return torch.where((u < p)[:, None, None], _mm(mat_c, mat), mat)


# ---------------------------------------------------------------------------
# draws and the matrices built from them
# ---------------------------------------------------------------------------

def draw_affine(batch: int, generator: torch.Generator, device) -> dict:
    """The raw numbers of `sample_affine` (`vspbfr_tpu/losses/ada.py:121`),
    one entry per sub-key: flip (randint 0..1), r90 (randint 0..3), t_int
    (2, B) uniform in [-0.125, 0.125), iso / aniso standard normals, th_pre
    / th_post uniform in [-pi, pi), t_frac (2, B) standard normals; gates
    (8, B) uniform in [0, 1), one row per transform in order."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    def randint(hi):
        return torch.randint(0, hi, (batch,), generator=generator,
                             device=device).float()

    return {"flip": randint(2), "r90": randint(4),
            "t_int": uniform((2, batch), -0.125, 0.125),
            "iso": normal((batch,)),
            "th_pre": uniform((batch,), -math.pi, math.pi),
            "aniso": normal((batch,)),
            "th_post": uniform((batch,), -math.pi, math.pi),
            "t_frac": normal((2, batch)),
            "gates": uniform((N_AFFINE_GATES, batch), 0.0, 1.0)}


def draw_color(batch: int, generator: torch.Generator, device) -> dict:
    """The raw numbers of `sample_color` (`vspbfr_tpu/losses/ada.py:155`):
    bright / contrast / sat standard normals, luma (randint 0..1), hue
    uniform in [-pi, pi); gates (5, B) uniform in [0, 1)."""
    def normal():
        return torch.randn((batch,), generator=generator, device=device)

    return {"bright": normal(), "contrast": normal(),
            "luma": torch.randint(0, 2, (batch,), generator=generator,
                                  device=device).float(),
            "hue": torch.rand((batch,), generator=generator, device=device)
            * (2 * math.pi) - math.pi,
            "sat": normal(),
            "gates": torch.rand((N_COLOR_GATES, batch), generator=generator,
                                device=device)}


def draw_augment(batch: int, generator: torch.Generator, device) -> dict:
    """The draws of one `augment` call: {"affine": ..., "color": ...}."""
    return {"affine": draw_affine(batch, generator, device),
            "color": draw_color(batch, generator, device)}


def affine_from_draws(d: dict, p: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """(B, 3, 3) image-space affine from `draw_affine`'s numbers at
    probability p (a 0-d tensor), as `sample_affine` builds it."""
    flip = d["flip"]
    b = flip.shape[0]
    u = d["gates"]
    one = torch.ones_like(flip)
    p_rot = 1 - torch.sqrt(torch.clamp(1 - p, 0.0, 1.0))
    g = _eye(b, 3, flip)
    g = _random_apply(u[0], p, scale_mat(1 - 2 * flip, one), g)
    g = _random_apply(u[1], p, rotate_mat(-math.pi / 2 * d["r90"]), g)
    t = d["t_int"]
    g = _random_apply(u[2], p, translate_mat(torch.round(t[1] * width),
                                             torch.round(t[0] * height)), g)
    s = torch.exp2(d["iso"] * 0.2)
    g = _random_apply(u[3], p, scale_mat(s, s), g)
    g = _random_apply(u[4], p_rot, rotate_mat(-d["th_pre"]), g)
    s = torch.exp2(d["aniso"] * 0.2)
    g = _random_apply(u[5], p, scale_mat(s, 1 / s), g)
    g = _random_apply(u[6], p_rot, rotate_mat(-d["th_post"]), g)
    t = d["t_frac"] * 0.125
    return _random_apply(u[7], p, translate_mat(t[1] * width,
                                                t[0] * height), g)


def color_from_draws(d: dict, p: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) homogeneous color matrix from `draw_color`'s numbers at
    probability p, as `sample_color` builds it."""
    u = d["gates"]
    c = _eye(d["luma"].shape[0], 4, d["luma"])
    b = d["bright"] * 0.2
    c = _random_apply(u[0], p, translate3d_mat(b, b, b), c)
    s = torch.exp2(d["contrast"] * 0.5)
    c = _random_apply(u[1], p, scale3d_mat(s, s, s), c)
    c = _random_apply(u[2], p, luma_flip_mat(LUMA_AXIS, d["luma"]), c)
    c = _random_apply(u[3], p, rotate3d_mat(LUMA_AXIS, d["hue"]), c)
    s = torch.exp2(d["sat"])
    return _random_apply(u[4], p, saturation_mat(LUMA_AXIS, s), c)


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

def _sample_nchw(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """`grid_sample_bilinear` on NCHW x: four gathers of the neighbours,
    weighted in the JAX package's order and arithmetic (torch's
    `F.grid_sample` unnormalises the coordinates in another order, which
    moves a sample by an ulp of the coordinate, ~1e-5 px at 1000 px)."""
    b, c, h, w = x.shape
    ho, wo = grid.shape[1:3]
    gx = (grid[..., 0] + 1.0) * w / 2.0 - 0.5
    gy = (grid[..., 1] + 1.0) * h / 2.0 - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    flat = x.reshape(b, c, h * w)

    def gather(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 2, idx.reshape(b, 1, ho * wo).expand(
            b, c, ho * wo)).reshape(b, c, ho, wo)
        return vals * inb[:, None]

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def grid_sample_bilinear(img: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of (B, H, W, C) at grid (B, Ho, Wo, 2), normalized
    (x, y) coordinates, zeros outside: torch's `F.grid_sample(bilinear,
    zeros, align_corners=False)`."""
    return _sample_nchw(img.permute(0, 3, 1, 2), grid).permute(0, 2, 3, 1)


def _inv3(g: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant); on the card
    `torch.linalg.inv` checks for singularity, a host sync."""
    a, b, c = g[:, 0, 0], g[:, 0, 1], g[:, 0, 2]
    d, e, f = g[:, 1, 0], g[:, 1, 1], g[:, 1, 2]
    gg, h, i = g[:, 2, 0], g[:, 2, 1], g[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * gg)
    C = d * h - e * gg
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * gg, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * gg), a * e - b * d], -1)], -2)
    return adj / det[:, None, None]


def _fir(x: torch.Tensor, taps, up: int, down: int, pad: tuple[int, int],
         dim: int) -> torch.Tensor:
    """One FIR pass along `dim` of NCHW x (`_upfir_x` / `_upfir_y`): zero
    insertion to n * up, pad (p0, p1) (a negative pad crops), convolution
    with the 1-D `taps` (Python floats), stride `down`; each channel on its
    own. The convolution is a sum of shifted, strided slices, whose
    backward and double backward are slices and sums too: as a depthwise
    `F.conv2d`, R1's double backward ran cuDNN's generic grouped path,
    ~2.5 s at 512 px b4 on an H100 (`chip_smoke.py` phase 8)."""
    if up > 1:
        shape = list(x.shape)
        shape[dim] *= up
        z = x.new_zeros(shape)
        z[(slice(None),) * dim + (slice(None, None, up),)] = x
        x = z
    pads = [0, 0] * (x.dim() - 1 - dim) + [pad[0], pad[1]]
    x = F.pad(x, pads)
    n = (x.shape[dim] - len(taps)) // down + 1
    out = None
    for j, t in enumerate(reversed(taps)):
        sl = x[(slice(None),) * dim + (slice(j, j + down * (n - 1) + 1,
                                             down),)]
        out = sl * t if out is None else torch.add(out, sl, alpha=t)
    return out


def upfir_x(x, taps, up, down, pad):
    """`_fir` along W."""
    return _fir(x, taps, up, down, pad, 3)


def upfir_y(x, taps, up, down, pad):
    """`_fir` along H."""
    return _fir(x, taps, up, down, pad, 2)


def apply_affine(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Antialiased warp of (B, H, W, C) float32 by G (`apply_affine`,
    `vspbfr_tpu/losses/ada.py:230`): reflect pad -> separable 2x up ->
    bilinear warp by G^-1 -> separable 2x down, static padding."""
    b, h, w, c = img.shape
    len_k = len(SYM6)
    pad_k = len_k // 4
    px, py = w // 4 + pad_k * 2, h // 4 + pad_k * 2
    x = F.pad(img.permute(0, 3, 1, 2), (px, px, py, py), mode="reflect")

    up_pad = ((len_k + 2 - 1) // 2, (len_k - 2) // 2)
    x = upfir_y(upfir_x(x, SYM6, 2, 1, up_pad), SYM6, 2, 1, up_pad)

    # coordinate bookkeeping (`non_leaking.py:880-892` upstream), symmetric
    # pad so the recentering term vanishes; the same products in the same
    # order as the JAX package
    out_h, out_w = (h + pad_k * 2) * 2, (w + pad_k * 2) * 2
    in_h, in_w = x.shape[2], x.shape[3]
    a, a_inv, t_lo, t_hi, s1, s2 = _const([
        [[2, 0, 0], [0, 2, 0], [0, 0, 1]],
        [[0.5, 0, 0], [0, 0.5, 0], [0, 0, 1]],
        [[1, 0, -0.5], [0, 1, -0.5], [0, 0, 1]],
        [[1, 0, 0.5], [0, 1, 0.5], [0, 0, 1]],
        [[2 / in_w, 0, 0], [0, 2 / in_h, 0], [0, 0, 1]],
        [[out_w / 2, 0, 0], [0, out_h / 2, 0], [0, 0, 1]]], img)
    g_inv = _mm(_mm(a, _inv3(g)), a_inv)
    g_inv = _mm(_mm(t_lo, g_inv), t_hi)
    g_inv = _mm(_mm(s1, g_inv), s2)

    # affine grid over the output (align_corners=False pixel centres); the
    # divisor is a tensor because the card divides by a Python number as a
    # multiplication by its reciprocal, an ulp off the CPU's quotient
    def centres(n):
        i = torch.arange(n, device=img.device, dtype=torch.float32)
        return (2 * i + 1) / torch.full((), float(n), device=img.device) - 1

    gy, gx = centres(out_h)[:, None], centres(out_w)[None, :]
    m = g_inv[:, :2, :, None, None]
    grid = torch.stack([m[:, i, 0] * gx + m[:, i, 1] * gy + m[:, i, 2]
                        for i in range(2)], dim=-1)
    x = _sample_nchw(x, grid)

    d_p = -pad_k * 2
    down_pad = (d_p + (len_k - 2 + 1) // 2, d_p + (len_k - 2) // 2)
    kf = SYM6[::-1]
    x = upfir_y(upfir_x(x, kf, 1, 2, down_pad), kf, 1, 2, down_pad)
    return x.permute(0, 2, 3, 1)


def apply_color(img: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) through the color matrix C (`apply_color`)."""
    return (torch.einsum("bhwc,bdc->bhwd", img, c[:, :3, :3])
            + c[:, None, None, :3, 3])


def augment(img: torch.Tensor, draws: dict, p: torch.Tensor) -> torch.Tensor:
    """The full ADA augment of (B, H, W, 3) float32 at probability p (a 0-d
    tensor) with `draw_augment`'s draws (`augment`,
    `non_leaking.py:930-934` upstream)."""
    _, h, w, _ = img.shape
    g = affine_from_draws(draws["affine"], p, h, w)
    c = color_from_draws(draws["color"], p)
    return apply_color(apply_affine(img, g), c)


# ---------------------------------------------------------------------------
# adaptive controller
# ---------------------------------------------------------------------------

class ADAState(NamedTuple):
    p: torch.Tensor            # augment probability, 0-d float32
    sign_sum: torch.Tensor
    count: torch.Tensor
    steps: torch.Tensor        # 0-d int32

    @classmethod
    def create(cls, device=None) -> "ADAState":
        z = torch.zeros((), device=device)
        return cls(p=z, sign_sum=z.clone(), count=z.clone(),
                   steps=torch.zeros((), dtype=torch.int32, device=device))

    def to(self, device) -> "ADAState":
        return ADAState(*(t.to(device) for t in self))


def ada_update(state: ADAState, real_pred: torch.Tensor,
               target: float = 0.6, ada_length: int = 500 * 1000,
               update_every: int = 256) -> ADAState:
    """`AdaptiveAugment.tune` (`non_leaking.py:492-517` upstream): every
    `update_every` calls, p moves by count / ada_length toward the side
    that brings the sign mean of D's real logits to `target`."""
    sign_sum = state.sign_sum + torch.sign(real_pred).sum()
    count = state.count + real_pred.shape[0] * 1.0
    steps = state.steps + 1
    fire = steps >= update_every
    sign = torch.where(sign_sum / count > target, 1.0, -1.0)
    p = torch.clamp(state.p + sign * count / ada_length, 0.0, 1.0)
    zero = torch.zeros_like(count)
    return ADAState(p=torch.where(fire, p, state.p),
                    sign_sum=torch.where(fire, zero, sign_sum),
                    count=torch.where(fire, zero, count),
                    steps=torch.where(fire, torch.zeros_like(steps), steps))
