"""Lifting-scheme DWT in plain PyTorch: Haar, CDF-9/7 and the 13 families,
forward and inverse (port of ``irw_tpu/ops/wavelets/lifting.py:32-297``).

Semantics of the reference's transform-pipeline wavelets:

- split even/odd samples along an axis, apply the lifting steps (rows pass
  along H, then cols pass along W on both halves);
- neighbour shifts are zero-padded at the boundary;
- the 1D normalisation multiplies s by √2 (Haar) / K (CDF-9/7) / the
  family's k and divides d by it;
- the four subbands get the "v6" scales LL·0.5, LH·1, HL·1, HH·√2.

Tensors have trailing spatial dims (..., H, W) and compute in their own
dtype, every constant rounded to it first as jnp does
(``lifting_families.scalar``), so bf16 results equal the JAX package's bit
for bit.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from irw_tpu_torch.ops.wavelets.lifting_families import (
    FAMILY_ALIASES,
    LIFTING_FAMILIES,
    divide,
    family_lift_1d,
    family_unlift_1d,
    interleave,
    multiply,
    shift,
    split_even_odd,
)

SQRT2 = math.sqrt(2.0)

# "v6" 2D subband scales (reference utils.py:58-77)
COEFFS_SCALES_2D = (0.5, 1.0, 1.0, SQRT2)

# CDF-9/7 lifting coefficients (Getreuer / Daubechies-Sweldens factorisation)
CDF97_A1 = -1.58613432
CDF97_A2 = -0.05298011854
CDF97_A3 = 0.8829110762
CDF97_A4 = 0.4435068522
CDF97_K = 1.149604398


def _haar_lift_1d(x, dim: int):
    even, odd = split_even_odd(x, dim)
    d = odd - even
    s = even + multiply(d, 0.5)
    return multiply(s, SQRT2), divide(d, SQRT2)


def _haar_unlift_1d(s, d, dim: int):
    s, d = divide(s, SQRT2), multiply(d, SQRT2)
    even = s - multiply(d, 0.5)
    return interleave(even, d + even, dim)


def _cdf97_lift_1d(x, dim: int):
    even, odd = split_even_odd(x, dim)
    odd = odd + multiply(even + shift(even, 1, dim), CDF97_A1)
    even = even + multiply(shift(odd, -1, dim) + odd, CDF97_A2)
    odd = odd + multiply(even + shift(even, 1, dim), CDF97_A3)
    even = even + multiply(shift(odd, -1, dim) + odd, CDF97_A4)
    return multiply(even, CDF97_K), divide(odd, CDF97_K)


def _cdf97_unlift_1d(s, d, dim: int):
    s, d = divide(s, CDF97_K), multiply(d, CDF97_K)
    even = s - multiply(shift(d, -1, dim) + d, CDF97_A4)
    odd = d - multiply(even + shift(even, 1, dim), CDF97_A3)
    even = even - multiply(shift(odd, -1, dim) + odd, CDF97_A2)
    odd = odd - multiply(even + shift(even, 1, dim), CDF97_A1)
    return interleave(even, odd, dim)


# basis → (1D lift, 1D inverse, the multiple the reference pads H and W to)
_LIFT_1D = {"haar": (_haar_lift_1d, _haar_unlift_1d, 2),
            "cdf97": (_cdf97_lift_1d, _cdf97_unlift_1d, 4)}
_LIFT_1D.update({key: (partial(family_lift_1d, family=fam),
                       partial(family_unlift_1d, family=fam), 2)
                 for key, fam in LIFTING_FAMILIES.items()})
_LIFT_1D.update({alias: _LIFT_1D[key] for alias, key in FAMILY_ALIASES.items()})

BASES = tuple(sorted(_LIFT_1D))


def _basis(basis: str):
    """(1D lift, 1D inverse, pad multiple) of a basis; ValueError for an
    unknown one."""
    try:
        return _LIFT_1D[basis]
    except KeyError:
        raise ValueError(f"unknown lifting basis {basis!r}; one of {list(BASES)}") from None


def lift_1d(x, basis: str, dim: int):
    """One 1D lifting pass along ``dim``: the scaled (s, d) halves."""
    return _basis(basis)[0](x, dim=dim)


def _lifting_dwt2(x, basis: str, scales_2d=COEFFS_SCALES_2D):
    """One-level 2D lifting DWT on (..., H, W), H and W even.  Returns
    (ll, lh, hl, hh), each (..., H/2, W/2)."""
    low_h, high_h = lift_1d(x, basis, -2)      # rows pass (along H)
    ll, hl = lift_1d(low_h, basis, -1)         # cols pass (along W) on each half
    lh, hh = lift_1d(high_h, basis, -1)
    return tuple(multiply(band, s) for band, s in zip((ll, lh, hl, hh), scales_2d))


def _lifting_idwt2(ll, lh, hl, hh, basis: str, scales_2d=COEFFS_SCALES_2D):
    """Inverse of ``_lifting_dwt2`` (``lifting.py:176-183``)."""
    unlift = _basis(basis)[1]
    ll, lh, hl, hh = (divide(band, s) for band, s in zip((ll, lh, hl, hh), scales_2d))
    low_h = unlift(ll, hl, dim=-1)
    high_h = unlift(lh, hh, dim=-1)
    return unlift(low_h, high_h, dim=-2)


def _pad_to_multiple(x, multiple: int):
    """Zero-pad H and W up to a multiple, at the bottom and right
    (reference HaarLifting/Cdf97Lifting, custom_transforms.py:20-23,42-45)."""
    h, w = x.shape[-2], x.shape[-1]
    pad_h = (multiple - h % multiple) % multiple
    pad_w = (multiple - w % multiple) % multiple
    if pad_h or pad_w:
        x = torch.nn.functional.pad(x, (0, pad_w, 0, pad_h))
    return x


def lifting_dwt2(x, basis: str = "haar", scales_2d=COEFFS_SCALES_2D):
    """One-level 2D lifting DWT for any basis (haar, cdf97 and the 13
    families with their aliases), padding H and W first as the reference
    does (to 4 for cdf97, else 2).  (..., H, W) → 4 × (..., H'/2, W'/2)."""
    return _lifting_dwt2(_pad_to_multiple(x, _basis(basis)[2]), basis, scales_2d)


def lifting_idwt2(ll, lh, hl, hh, basis: str = "haar", scales_2d=COEFFS_SCALES_2D):
    """Inverse of ``lifting_dwt2`` (of its padded input)."""
    return _lifting_idwt2(ll, lh, hl, hh, basis, scales_2d)


def haar_dwt2(x, scales_2d=COEFFS_SCALES_2D):
    """One-level Haar lifting DWT.  (..., H, W) → 4 × (..., H/2, W/2)."""
    return lifting_dwt2(x, "haar", scales_2d)


def haar_idwt2(ll, lh, hl, hh, scales_2d=COEFFS_SCALES_2D):
    return _lifting_idwt2(ll, lh, hl, hh, "haar", scales_2d)


def cdf97_dwt2(x, scales_2d=COEFFS_SCALES_2D):
    """One-level CDF-9/7 lifting DWT (H and W padded to a multiple of 4)."""
    return lifting_dwt2(x, "cdf97", scales_2d)


def cdf97_idwt2(ll, lh, hl, hh, scales_2d=COEFFS_SCALES_2D):
    return _lifting_idwt2(ll, lh, hl, hh, "cdf97", scales_2d)


def lifting_decompose(x, levels: int = 1, basis: str = "haar"):
    """Multi-level decomposition recursing on LL (reference
    HaarLifting.forward, custom_transforms.py:48-55).

    Returns (approx, details): per-level LL tensors and (lh, hl, hh) tuples,
    coarsest last."""
    approx, details = [], []
    for _ in range(levels):
        ll, lh, hl, hh = lifting_dwt2(x, basis)
        approx.append(ll)
        details.append((lh, hl, hh))
        x = ll
    return approx, details


def subband_stack(images, levels: int = 1, basis: str = "haar", ll_only: bool = False):
    """The ``CustomTransform`` stack of the coarsest level.

    images: (B, H, W, C).  Returns (B, 4, H/2ˡ, W/2ˡ, C) ordered [LL, LH, HL,
    HH] (``out[:, s]`` is an NHWC image per band), or with ``ll_only`` the
    LL band alone, (B, H/2ˡ, W/2ˡ, C)."""
    x = images.movedim(-1, 1)  # (B, C, H, W)
    approx, details = lifting_decompose(x, levels=levels, basis=basis)
    ll = approx[-1]
    if ll_only:
        return ll.movedim(1, -1)
    stack = torch.stack([ll, *details[-1]], dim=1)  # (B, 4, C, h, w)
    return stack.movedim(2, -1)
