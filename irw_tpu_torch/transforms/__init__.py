"""Device-side transform stage."""

from irw_tpu_torch.transforms.pipeline import DeviceTransform

__all__ = ["DeviceTransform"]
