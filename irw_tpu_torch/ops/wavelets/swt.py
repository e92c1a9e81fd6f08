"""Level-1 stationary Haar transform (the flagship VOC study's SWT).

Port of ``irw_tpu/ops/wavelets/pallas_dwt.py:247-295`` (``haar_swt2_pallas``).
``haar_swt2`` is the custom op ``irw_tpu_torch::haar_swt2`` (``ops.library``):
it launches the CUDA kernel K1 (``csrc/haar_swt2.cu``) for a CUDA tensor and
runs ``haar_swt2_plain`` for a CPU tensor; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.library import kernel_op

SQRT2 = math.sqrt(2.0)


def haar_swt2_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) → (N, 4, H, W) ordered [cA, cH, cV, cD], periodic extension.

    Computes in f32 and casts back (pallas_dwt.py:271-275, 295); the
    neighbour is x[i+1] with wrap-around (pallas_dwt.py:253-258).
    """
    in_dtype = x.dtype
    x = x.float()
    s = SQRT2 / 2.0
    xn = torch.roll(x, -1, dims=1)
    lo_h = s * (x + xn)
    hi_h = s * (x - xn)
    lo_hn = torch.roll(lo_h, -1, dims=2)
    hi_hn = torch.roll(hi_h, -1, dims=2)
    out = torch.stack([s * (lo_h + lo_hn), s * (hi_h + hi_hn),
                       s * (lo_h - lo_hn), s * (hi_h - hi_hn)], dim=1)
    return out.to(in_dtype)


_SIGNATURES = {
    "irw_haar_swt2_f32": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}


def _swt_cpu(x: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return haar_swt2_plain(x)


def _swt_cuda(x: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: kernel K1 (f32 inside, cast back)."""
    in_dtype = x.dtype
    xf = x.float().contiguous()
    n, h, w = xf.shape
    out = torch.empty((n, 4, h, w), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.to(in_dtype)
    lib = cuda_lib.load("haar_swt2", _SIGNATURES)
    with cuda_lib.on_device(xf):
        status = lib.irw_haar_swt2_f32(xf.data_ptr(), out.data_ptr(), n, h, w,
                                       cuda_lib.stream_of(xf))
    cuda_lib.check(status, "haar_swt2", lib)
    haar_swt2.launches += 1
    return out.to(in_dtype)


def _swt_fake(x: torch.Tensor) -> torch.Tensor:
    n, h, w = x.shape
    return x.new_empty((n, 4, h, w))


_OP = kernel_op("haar_swt2", "(Tensor x) -> Tensor", _swt_cpu, _swt_cuda, _swt_fake)


def haar_swt2(x: torch.Tensor) -> torch.Tensor:
    """Level-1 stationary Haar transform: (N, H, W) → (N, 4, H, W).

    The op ``irw_tpu_torch::haar_swt2``: on a CPU tensor the plain version;
    on a CUDA tensor kernel K1 (f32 inside, cast back to the input dtype),
    counted in ``haar_swt2.launches``.  A CPU input that needs a gradient
    takes the plain version directly (the kernel has no backward).
    """
    if x.dim() != 3 or not x.is_floating_point():
        raise ValueError(f"haar_swt2 takes a floating (N, H, W) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"haar_swt2: no kernel for device {x.device}; the kernel takes "
                         "floating (N, H, W) planes on a CUDA device")
    if x.device.type == "cpu" and x.requires_grad and torch.is_grad_enabled():
        return haar_swt2_plain(x)
    return _OP(x)


haar_swt2.launches = 0
