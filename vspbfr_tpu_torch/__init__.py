"""vspbfr_tpu_torch: the PyTorch / CUDA port of `vspbfr_tpu`.

The serving path (encode -> 4-step DDPM -> decode -> RestoreNet) and
stage-2 code-diffuser training (`train/diffuser_train.py`,
`cli/train_diffuser.py`) in PyTorch, NHWC throughout, with the JAX
package's Pallas kernels on those paths rewritten as CUDA C++ for Hopper
(`ops/dense_conv.py` with its gradient, `ops/dilated_conv.py`,
`ops/d2s.py` with its inverse; sources in `csrc/`). Each module names its
JAX counterpart; the JAX package is the reference the tests hold this port
against. This package imports torch and never JAX.
"""

from vspbfr_tpu_torch.pipeline import RestorationPipeline

__all__ = ["RestorationPipeline"]
