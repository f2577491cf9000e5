"""Data of the PyTorch port (counterpart of `vspbfr_tpu/data`): the
inference reader and writer, the training set's GT side with its threaded
loader, and the degradation chain on the device."""

from vspbfr_tpu_torch.data.datasets import (
    DataLoader,
    RestoreTestDataset,
    RestoreTrainDataset,
    list_images,
    load_image,
    save_image,
)
from vspbfr_tpu_torch.data.degradations import DegradationConfig
from vspbfr_tpu_torch.data.device_degrade import (
    DeviceDegrader,
    DeviceDegradeLoader,
    sample_params,
)

__all__ = ["DataLoader", "DegradationConfig", "DeviceDegradeLoader",
           "DeviceDegrader", "RestoreTestDataset", "RestoreTrainDataset",
           "list_images", "load_image", "sample_params", "save_image"]
