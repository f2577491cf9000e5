"""Ops of the PyTorch port (counterpart of `vspbfr_tpu/ops`).

The three hand-written CUDA kernels of the serving path live in
`dense_conv` (K1), `dilated_conv` (K2) and `d2s` (K3), each beside its
plain torch version; `_build` compiles and loads them.
"""

from vspbfr_tpu_torch.ops.d2s import d2s, d2s_plain
from vspbfr_tpu_torch.ops.dense_conv import dense_conv, dense_conv_plain
from vspbfr_tpu_torch.ops.dilated_conv import (
    dilated_multi_conv,
    dilated_multi_conv_plain,
)
from vspbfr_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from vspbfr_tpu_torch.ops.modulated_conv import (
    conv2d,
    demod_coeffs,
    modulated_conv2d,
    modulated_conv2d_multi,
)
from vspbfr_tpu_torch.ops.upfirdn2d import (
    blur,
    downsample2d,
    make_resample_kernel,
    upfirdn2d,
    upsample2d,
)

KERNELS = (dense_conv, dilated_multi_conv, d2s)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "KERNELS", "blur", "conv2d", "d2s", "d2s_plain", "demod_coeffs",
    "dense_conv", "dense_conv_plain", "dilated_multi_conv",
    "dilated_multi_conv_plain", "downsample2d", "fused_leaky_relu",
    "launch_counts", "make_resample_kernel", "modulated_conv2d",
    "modulated_conv2d_multi", "reset_launch_counts", "scaled_leaky_relu",
    "upfirdn2d", "upsample2d",
]
