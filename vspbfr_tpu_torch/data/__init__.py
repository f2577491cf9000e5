"""Data of the PyTorch port (counterpart of `vspbfr_tpu/data`): the
inference reader and writer, the training set with its host degradation
chain (numpy, or the C++ engine of `native.py`) and its threaded loader,
and the degradation chain on the device."""

from vspbfr_tpu_torch.data.datasets import (
    DataLoader,
    RestoreTestDataset,
    RestoreTrainDataset,
    list_images,
    load_image,
    save_image,
)
from vspbfr_tpu_torch.data.degradations import (
    DegradationConfig,
    add_gaussian_noise,
    add_jpeg_compression,
    add_poisson_noise,
    bivariate_gaussian_kernel,
    bivariate_generalized_gaussian_kernel,
    bivariate_plateau_kernel,
    circular_lowpass_kernel,
    degrade_image,
    random_mixed_kernel,
)
from vspbfr_tpu_torch.data.device_degrade import (
    DeviceDegrader,
    DeviceDegradeLoader,
    sample_params,
)
from vspbfr_tpu_torch.data.host_jpeg import jpeg_roundtrip

__all__ = ["DataLoader", "DegradationConfig", "DeviceDegradeLoader",
           "DeviceDegrader", "RestoreTestDataset", "RestoreTrainDataset",
           "add_gaussian_noise", "add_jpeg_compression", "add_poisson_noise",
           "bivariate_gaussian_kernel",
           "bivariate_generalized_gaussian_kernel",
           "bivariate_plateau_kernel", "circular_lowpass_kernel",
           "degrade_image", "jpeg_roundtrip", "list_images", "load_image",
           "random_mixed_kernel", "sample_params", "save_image"]
