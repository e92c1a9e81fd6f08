"""Device transform stage (port of ``irw_tpu/transforms/pipeline.py:379-496``,
``DeviceTransform``).

Input (B, H, W, 3) uint8 (numpy or tensor); ``x.float() / 255`` then the
configured ops, in order:

- ``Normalize`` (ImageNet mean/std by default);
- ``SWTTransform`` with ``wavelet="haar"``, ``level=1``: kernel K1 on the
  card (``ops.wavelets.haar_swt2``) → (B, 4, H, W, C), bands [LL, LH, HL, HH];
- ``RGBToBGR``.

``CustomTransform``, ``DWTTransform``, ``ResizeSubBands`` and SWT with
another wavelet or level wait for ROADMAP A9.  The host stage (PIL
geometry) waits for A8: the served datasets hold images at their final size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.ops.wavelets.swt import haar_swt2

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_LATER = ("CustomTransform", "DWTTransform", "ResizeSubBands")


class DeviceTransform:
    """``ops``: list of (name, kwargs).  ``device=None`` means the card."""

    def __init__(self, ops: Sequence[tuple[str, dict]] = (), device=None):
        self.ops = [(name, dict(kw or {})) for name, kw in ops]
        for name, kw in self.ops:
            if name in _LATER:
                raise NotImplementedError(f"device transform {name!r} waits for ROADMAP A9")
            if name == "SWTTransform" and (kw.get("wavelet", "haar") != "haar"
                                           or int(kw.get("level", 1)) != 1):
                raise NotImplementedError("SWTTransform other than haar level 1 "
                                          "waits for ROADMAP A9")
            if name not in ("Normalize", "SWTTransform", "RGBToBGR"):
                raise ValueError(f"unknown device transform {name!r}")
        self.device = resolve_device(device)

    def __call__(self, images) -> torch.Tensor:
        x = images if torch.is_tensor(images) else torch.from_numpy(np.ascontiguousarray(images))
        x = x.to(self.device).float() / 255.0
        for name, kw in self.ops:
            if name == "Normalize":
                mean = torch.tensor(kw.get("mean", IMAGENET_MEAN), dtype=torch.float32,
                                    device=x.device)
                std = torch.tensor(kw.get("std", IMAGENET_STD), dtype=torch.float32,
                                   device=x.device)
                x = (x - mean) / std
            elif name == "SWTTransform":
                b, h, w, c = x.shape
                flat = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
                x = haar_swt2(flat).reshape(b, c, 4, h, w).permute(0, 2, 3, 4, 1)
            elif name == "RGBToBGR":
                x = x.flip(-1)
        return x
