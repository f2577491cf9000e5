"""Ops of the PyTorch port (counterpart of `vspbfr_tpu/ops`).

The hand-written CUDA kernels live in `dense_conv` (K1 with its gradient,
and K1e, K1 with the styled epilogue in its store), `dilated_conv` (K2,
with its gradient) and `d2s` (K3 and its inverse K4, each the other's
gradient), each beside its plain torch version; `_build` compiles and
loads them.
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

KERNELS = (dense_conv, dense_conv_epilogue, dilated_multi_conv, d2s, s2d)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "KERNELS", "apply_epilogue", "blur", "conv2d", "conv2d_dense_epilogue",
    "d2s", "d2s_plain", "demod_coeffs", "dense_conv", "dense_conv_epilogue",
    "dense_conv_epilogue_plain", "dense_conv_plain", "dilated_multi_conv",
    "dilated_multi_conv_plain", "downsample2d", "fused_epi_enabled",
    "fused_leaky_relu",
    "launch_counts", "make_resample_kernel", "modulated_conv2d",
    "modulated_conv2d_multi", "reset_launch_counts", "s2d", "s2d_plain",
    "scaled_leaky_relu", "upfirdn2d", "upsample2d",
]
