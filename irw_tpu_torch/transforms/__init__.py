"""The host transform stage (PIL's arithmetic in numpy) and the device
transform stage."""

from irw_tpu_torch.transforms.host import HostTransform
from irw_tpu_torch.transforms.pipeline import DeviceTransform, build_transforms

__all__ = ["DeviceTransform", "HostTransform", "build_transforms"]
