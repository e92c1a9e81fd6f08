"""Device transform stage (port of ``irw_tpu/transforms/pipeline.py:379-496``,
``DeviceTransform``) and ``build_transforms`` (``pipeline.py:499-544``),
which splits a transform config between the host stage
(``transforms/host.py``) and this one.

Input (B, H, W, 3) uint8 (numpy or tensor); ``x.float() / 255`` then the
configured ops, in order:

- ``Normalize`` (ImageNet mean/std by default);
- ``SWTTransform``: haar at level 1 on kernel K1 on the card
  (``ops.wavelets.haar_swt2``), any other wavelet or level the coarsest
  tuple of ``ops.wavelets.swt2`` → (B, 4, H, W, C), bands [LL, LH, HL, HH];
- ``DWTTransform``: ``ops.wavelets.wavedec2`` (mode ``symmetric`` unless
  given, pywt's default), its ``coeffs[0]`` and ``coeffs[1]`` → (B, 4, h, w, C);
- ``CustomTransform`` (the lifting DWT, ``pipeline.py:401-447``): kernel K4
  (``ops.wavelets.lifting_multi_level``) where the JAX package calls its
  Pallas kernel, else the plain lifting stack → (B, 4, h, w, C), or
  (B, h, w, C) with ``ll_only``, or the 3·levels + 1 band stack with
  ``coarse_only=False``;
- ``ResizeSubBands``: every band of (B, S, h, w, C) resized to ``size`` (an
  int or a pair) as ``jax.image.resize(method="bilinear")``
  (``ops.wavelets.resize_bilinear``);
- ``RGBToBGR``.

The JAX package has no kernel for ``swt2``, ``wavedec2`` or the resize:
they are plain PyTorch on every device, in full f32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.transforms.host import HostTransform
from irw_tpu_torch.ops.wavelets.dwt import swt2, wavedec2
from irw_tpu_torch.ops.wavelets.lifting import BASES, lifting_decompose, subband_stack
from irw_tpu_torch.ops.wavelets.lifting_dwt import lifting_multi_level
from irw_tpu_torch.ops.wavelets.resize import resize_bilinear
from irw_tpu_torch.ops.wavelets.swt import haar_swt2

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DeviceTransform:
    """``ops``: list of (name, kwargs).  ``device=None`` means the card."""

    def __init__(self, ops: Sequence[tuple[str, dict]] = (), device=None):
        self.ops = [(name, dict(kw or {})) for name, kw in ops]
        for name, _ in self.ops:
            if name not in DEVICE_OPS:
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
                x = swt_transform(x, **kw)
            elif name == "DWTTransform":
                x = dwt_transform(x, **kw)
            elif name == "CustomTransform":
                x = custom_transform(x, **kw)
            elif name == "ResizeSubBands":
                size = kw.get("size", 224)
                b, s = x.shape[:2]
                flat = resize_bilinear(x.reshape((b * s,) + tuple(x.shape[2:])), size)
                x = flat.reshape((b, s) + tuple(flat.shape[1:]))
            elif name == "RGBToBGR":
                x = x.flip(-1)
        return x


def swt_transform(x: torch.Tensor, level=1, wavelet: str = "haar", **_) -> torch.Tensor:
    """``SWTTransform`` on (B, H, W, C) → (B, 4, H, W, C): haar level 1 on
    kernel K1, as the JAX package's Pallas kernel; else the coarsest tuple
    of ``swt2``, ``(ca, (lh, hl, hh)), *_`` (``pipeline.py:448-461``)."""
    b, h, w, c = x.shape
    if wavelet == "haar" and int(level) == 1:
        flat = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
        return haar_swt2(flat).reshape(b, c, 4, h, w).permute(0, 2, 3, 4, 1)
    (ca, (lh, hl, hh)), *_ = swt2(x.permute(0, 3, 1, 2), wavelet, level=int(level))
    return torch.stack([ca, lh, hl, hh], dim=1).movedim(2, -1)


def dwt_transform(x: torch.Tensor, level=1, wavelet: str = "haar", mode: str = "symmetric",
                  **_) -> torch.Tensor:
    """``DWTTransform`` on (B, H, W, C) → (B, 4, h, w, C): ``wavedec2``'s
    ``coeffs[0]`` and ``coeffs[1]`` (``pipeline.py:462-475``).  pywt's
    default extension is ``symmetric``; for haar on even sizes it equals
    periodization."""
    coeffs = wavedec2(x.permute(0, 3, 1, 2), wavelet, level=int(level), mode=mode)
    ca, (lh, hl, hh) = coeffs[0], coeffs[1]
    return torch.stack([ca, lh, hl, hh], dim=1).movedim(2, -1)


def custom_transform(x: torch.Tensor, decompose_levels=None, levels=1, basis: str = "haar",
                     ll_only: bool = False, coarse_only: bool = True, **_) -> torch.Tensor:
    """The ``CustomTransform`` branch of the JAX ``DeviceTransform``
    (``pipeline.py:401-447``) on (B, H, W, C), with its own dispatch:

    1. the coarsest level's four bands of H, W divisible by 2ˡ: kernel K4;
    2. otherwise ``coarse_only`` or one level: ``subband_stack`` (pads H and
       W to a multiple first), also for ``ll_only``;
    3. otherwise the full stack: coarsest LL, then every level's details
       from coarse to fine, finer levels average-pooled to the coarsest size
       (the 7-band input of ``WCNN_ALL`` at two levels).

    Routes 2 and 3 are plain PyTorch on every device because the JAX package
    computes them in jnp, outside its kernel: that is its dispatch, not a
    fallback (``chip_smoke.py`` counts K4's launches on the served path)."""
    levels = int(levels if decompose_levels is None else decompose_levels)
    if basis not in BASES:
        raise ValueError(f"CustomTransform: unknown lifting basis {basis!r}; one of {list(BASES)}")
    b, h, w, c = x.shape
    divisible = h % 2 ** levels == 0 and w % 2 ** levels == 0
    if (coarse_only or levels == 1) and not ll_only and divisible:
        flat = lifting_multi_level(x.permute(0, 3, 1, 2).reshape(b * c, h, w), levels, basis)
        ho, wo = flat.shape[-2:]
        return flat.reshape(b, c, 4, ho, wo).permute(0, 2, 3, 4, 1)
    if coarse_only or levels == 1:
        return subband_stack(x, levels=levels, basis=basis, ll_only=ll_only)
    approx, details = lifting_decompose(x.permute(0, 3, 1, 2), levels=levels, basis=basis)
    th, tw = approx[-1].shape[-2:]
    bands = [approx[-1]]
    for lvl in range(levels - 1, -1, -1):
        for det in details[lvl]:
            factor = det.shape[-1] // tw
            if factor > 1:
                det = det.reshape(b, c, th, factor, tw, factor).mean(dim=(3, 5))
            bands.append(det)
    return torch.stack(bands, dim=1).movedim(2, -1)


HOST_OPS = {"Resize", "CenterCrop", "RandomCrop", "RandomResizedCrop", "RandomHorizontalFlip",
            "ColorJitter", "RandomGrayscale", "GaussianBlur", "FixSize", "MultiCrop"}
DEVICE_OPS = {"Normalize", "CustomTransform", "SWTTransform", "DWTTransform", "ResizeSubBands",
              "RGBToBGR"}
SKIP_OPS = {"ToTensor"}  # implicit in the device stage


def build_transforms(transform_config: dict | None, image_size: int = 224, device=None):
    """Split a transform config (ordered name → kwargs, one split of
    ``configs/transform/*.yaml``) into (HostTransform, DeviceTransform).
    SWT and DWT put a host-side ``FixSize`` at their level first; with no
    host op the host stage is ``Resize(image_size)``."""
    host_ops, device_ops = [], []
    for name, kw in (transform_config or {}).items():
        kw = dict(kw or {})
        if name in SKIP_OPS:
            continue
        if name in HOST_OPS:
            host_ops.append((name, kw))
        elif name in DEVICE_OPS:
            if name in ("SWTTransform", "DWTTransform"):
                host_ops.append(("FixSize", {"level": int(kw.get("level", 1))}))
            device_ops.append((name, kw))
        else:
            raise ValueError(f"unknown transform {name!r}")
    if not host_ops:
        host_ops = [("Resize", {"size": (image_size, image_size)})]
    return HostTransform(host_ops, image_size), DeviceTransform(device_ops, device=device)
