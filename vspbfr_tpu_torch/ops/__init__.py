"""Ops of the PyTorch port (counterpart of `vspbfr_tpu/ops`).

The hand-written CUDA kernels live in `dense_conv` (K1 with its gradient,
and K1e, K1 with the styled epilogue in its store), `dilated_conv` (K2,
with its gradient), `d2s` (K3 and its inverse K4, each the other's
gradient), `smart` (K5, the fused SMART core, whose gradient is the
K2 + K1 composition's), `epilogue` (K6, the styled epilogue chain as its
own pass), `fused_act` (K7, bias + leaky ReLU), `interleave` (K8, two more
forms of K3's permutation) and `stripe_conv` (K9, the per-tap stripe conv,
and K10, its in-kernel padding variants), each beside its plain torch
version; `_build` compiles and loads them. No product path calls K8-K10:
`cli.profile --interleave / --stripe_conv / --inkpad` measure them.
`packed` holds the space-to-depth layout's converters and conv forms.
`launch_counts` reports each kernel's launches, `form_counts` those of the
layout's kernel forms (K2 grouped, K6 and K1e with nc = 4 noise);
`plain_cuda_calls` reports the calls of the two elementwise plain versions
(K6's and K7's) on CUDA tensors, which no main path on the card should
make.
"""

from vspbfr_tpu_torch.ops.d2s import d2s, d2s_plain, s2d, s2d_plain
from vspbfr_tpu_torch.ops.dense_conv import (
    apply_epilogue,
    conv2d_dense_epilogue,
    dense_conv,
    dense_conv_epilogue,
    dense_conv_epilogue_plain,
    dense_conv_plain,
    fused_epi_enabled,
)
from vspbfr_tpu_torch.ops.dilated_conv import (
    dilated_multi_conv,
    dilated_multi_conv_plain,
    dilated_pair_conv,
)
from vspbfr_tpu_torch.ops.epilogue import (
    conv_epilogue,
    epilogue_plain,
    epilogue_plain_chain,
)
from vspbfr_tpu_torch.ops.fused_act import (
    fused_leaky_relu,
    fused_leaky_relu_plain,
    scaled_leaky_relu,
)
from vspbfr_tpu_torch.ops.interleave import (
    interleave_repeat,
    interleave_stack,
)
from vspbfr_tpu_torch.ops.modulated_conv import (
    conv2d,
    demod_coeffs,
    modulated_conv2d,
    modulated_conv2d_multi,
)
from vspbfr_tpu_torch.ops.smart import smart_core, smart_core_plain
from vspbfr_tpu_torch.ops.stripe_conv import (
    inkpad_conv,
    inkpad_conv_plain,
    stripe_conv,
    stripe_conv_plain,
)
from vspbfr_tpu_torch.ops.upfirdn2d import (
    blur,
    downsample2d,
    make_resample_kernel,
    upfirdn2d,
    upsample2d,
)

KERNELS = (dense_conv, dense_conv_epilogue, dilated_multi_conv, d2s, s2d,
           smart_core, conv_epilogue, fused_leaky_relu, interleave_stack,
           interleave_repeat, stripe_conv, inkpad_conv)
PLAIN_ON_CARD = (epilogue_plain, fused_leaky_relu_plain)
# the space-to-depth layout's kernel forms: (name, wrapper, its counter of
# them); each launch also counts in the wrapper's `launches`
FORMS = (("dilated_multi_conv_grouped", dilated_multi_conv,
          "grouped_launches"),
         ("conv_epilogue_nc4", conv_epilogue, "phase_launches"),
         ("dense_conv_epilogue_nc4", dense_conv_epilogue, "phase_launches"))


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for _, fn, attr in FORMS:
        setattr(fn, attr, 0)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def form_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, fn, attr in FORMS}


def reset_plain_cuda_calls() -> None:
    for fn in PLAIN_ON_CARD:
        fn.cuda_calls = 0


def plain_cuda_calls() -> dict[str, int]:
    return {fn.__name__: fn.cuda_calls for fn in PLAIN_ON_CARD}


__all__ = [
    "FORMS", "KERNELS", "PLAIN_ON_CARD", "apply_epilogue", "blur", "conv2d",
    "conv2d_dense_epilogue", "conv_epilogue", "d2s", "d2s_plain",
    "demod_coeffs", "dense_conv", "dense_conv_epilogue",
    "dense_conv_epilogue_plain", "dense_conv_plain", "dilated_multi_conv",
    "dilated_multi_conv_plain", "dilated_pair_conv", "downsample2d",
    "epilogue_plain", "form_counts",
    "epilogue_plain_chain", "fused_epi_enabled", "fused_leaky_relu",
    "fused_leaky_relu_plain", "inkpad_conv", "inkpad_conv_plain",
    "interleave_repeat", "interleave_stack", "launch_counts", "make_resample_kernel",
    "modulated_conv2d", "modulated_conv2d_multi", "plain_cuda_calls",
    "reset_launch_counts", "reset_plain_cuda_calls", "s2d", "s2d_plain",
    "scaled_leaky_relu", "smart_core", "smart_core_plain", "stripe_conv",
    "stripe_conv_plain", "upfirdn2d",
    "upsample2d",
]
