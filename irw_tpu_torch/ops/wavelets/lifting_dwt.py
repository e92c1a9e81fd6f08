"""Fused multi-level 2D lifting DWT, coarsest level only (kernel K4).

Port of ``irw_tpu/ops/wavelets/pallas_dwt.py:134-220``
(``lifting_multi_level_pallas``, body ``_dwt_kernel``): per level, lift
along H, then along W on both halves, then the v6 scales (0.5, 1, 1, √2);
recurse on the scaled LL; return the last level's [LL, LH, HL, HH].

``lifting_multi_level`` launches the CUDA kernel K4 (``csrc/lifting_dwt.cu``)
for a CUDA f32 tensor and runs ``lifting_multi_level_plain`` (built from
``ops.wavelets.lifting``) for a CPU tensor; it never falls back from one to
the other.  The kernel takes every basis as a table of lifting steps, so one
kernel serves haar, cdf97 and the 13 families.
"""

from __future__ import annotations

import ctypes

import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.wavelets.lifting import (
    BASES,
    CDF97_A1,
    CDF97_A2,
    CDF97_A3,
    CDF97_A4,
    CDF97_K,
    SQRT2,
    _lifting_dwt2,
)
from irw_tpu_torch.ops.wavelets.lifting_families import resolve_family

MAX_STEPS = 8          # csrc/lifting_dwt.cu kMaxSteps, kMaxTaps, kStrip,
MAX_TAPS = 9           # kRowsW and the shared memory a block may take
STRIP = 32
ROWS_W = 8
MAX_SHARED_BYTES = 232448


def _check(x: torch.Tensor, levels: int, basis: str) -> None:
    if x.dim() != 3 or not x.is_floating_point():
        raise ValueError(f"lifting_multi_level takes a floating (N, H, W) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if basis not in BASES:
        raise ValueError(f"unknown lifting basis {basis!r}; one of {list(BASES)}")
    if levels < 1 or x.shape[1] % 2 ** levels or x.shape[2] % 2 ** levels:
        raise ValueError(f"lifting_multi_level: H and W {tuple(x.shape[1:])} must divide "
                         f"by 2**levels (levels={levels})")


def lifting_multi_level_plain(x: torch.Tensor, levels: int = 1,
                              basis: str = "haar") -> torch.Tensor:
    """(N, H, W) → (N, 4, H/2ˡ, W/2ˡ) [LL, LH, HL, HH], in x's dtype."""
    _check(x, levels, basis)
    for _ in range(levels):
        ll, lh, hl, hh = _lifting_dwt2(x, basis)
        x = ll
    return torch.stack([ll, lh, hl, hh], dim=1)


def kernel_steps(basis: str):
    """The basis as K4's table: ([(target, pair, shifts, coeffs), ...], k).

    ``target`` is 0 (even) or 1 (odd).  A taps step adds Σ c·src[i + n] in
    tap order; a pair step (cdf97) adds c·(src[i + a] + src[i + b]), the sum
    first, as ``_cdf97_lift_1d`` does.  Haar is the taps program
    odd += −1·even; even += 0.5·odd, which rounds exactly as d = odd − even,
    s = even + 0.5·d."""
    if basis == "haar":
        return [(1, 0, (0,), (-1.0,)), (0, 0, (0,), (0.5,))], SQRT2
    if basis == "cdf97":
        return [(1, 1, (0, 1), (CDF97_A1,)), (0, 1, (-1, 0), (CDF97_A2,)),
                (1, 1, (0, 1), (CDF97_A3,)), (0, 1, (-1, 0), (CDF97_A4,))], CDF97_K
    _, (steps, k) = resolve_family(basis)
    return [(int(target == "odd"), 0, tuple(n for n, _ in taps), tuple(c for _, c in taps))
            for target, taps in steps], k


def _step_arrays(basis: str):
    steps, k = kernel_steps(basis)
    meta, coeffs = [], []
    for target, pair, shifts, cs in steps:
        meta += [target, pair, len(shifts), *shifts, *[0] * (MAX_TAPS - len(shifts))]
        coeffs += [*cs, *[0.0] * (MAX_TAPS - len(cs))]
    return (len(steps), (ctypes.c_int * len(meta))(*meta),
            (ctypes.c_float * len(coeffs))(*coeffs), k)


_SIGNATURES = {
    "irw_lifting_dwt_f32": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_void_p],
                            ctypes.c_int),
}


def lifting_multi_level(x: torch.Tensor, levels: int = 1, basis: str = "haar") -> torch.Tensor:
    """Multi-level lifting DWT, coarsest level: (N, H, W) → (N, 4, H/2ˡ, W/2ˡ).

    CPU tensor: the plain version, in x's dtype.  CUDA f32 tensor: kernel K4,
    counted in ``lifting_multi_level.launches`` (one per call, whatever the
    number of levels).  Other dtypes on the card raise: nothing on the
    served path gives one (``DeviceTransform`` is f32 from /255 on)."""
    _check(x, levels, basis)
    if x.device.type == "cpu":
        return lifting_multi_level_plain(x, levels, basis)
    if x.device.type != "cuda":
        raise ValueError(f"lifting_multi_level: no kernel for device {x.device}; the kernel "
                         "takes float32 (N, H, W) planes on a CUDA device")
    if x.dtype != torch.float32:
        raise NotImplementedError(f"lifting_multi_level: kernel K4 takes float32; {x.dtype} "
                                  "on the card waits for ROADMAP B4-remainder")
    n, h, w = x.shape
    if max(h * STRIP, ROWS_W * w) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"lifting_multi_level: a {h} x {w} plane does not fit K4's shared "
                         f"memory ({MAX_SHARED_BYTES} bytes per block)")
    x = x.contiguous()
    out = torch.empty((n, 4, h >> levels, w >> levels), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lift_ws = torch.empty((n, h, w), dtype=x.dtype, device=x.device)
    ll_ws = (torch.empty((n, h // 2, w // 2), dtype=x.dtype, device=x.device)
             if levels > 1 else None)
    nsteps, meta, coeffs, k = _step_arrays(basis)
    lib = cuda_lib.load("lifting_dwt", _SIGNATURES)
    status = lib.irw_lifting_dwt_f32(x.data_ptr(), out.data_ptr(), lift_ws.data_ptr(),
                                     None if ll_ws is None else ll_ws.data_ptr(),
                                     n, h, w, levels, nsteps, meta, coeffs, k,
                                     cuda_lib.stream_of(x))
    cuda_lib.check(status, "lifting_multi_level", lib)
    lifting_multi_level.launches += 1
    return out


lifting_multi_level.launches = 0
