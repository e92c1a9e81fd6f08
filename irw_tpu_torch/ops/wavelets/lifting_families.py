"""The declarative lifting families (port of
``irw_tpu/ops/wavelets/lifting_families.py:30-270``).

A family is data: a tuple of lifting steps, each updating one parity from
zero-padded shifted taps of the other, plus the final (s·k, d/k)
normalisation.  The tables are a copy of the JAX package's (the port
imports nothing of it); the coefficients follow the reference files cited on
each spec.  ``family_lift_1d`` runs any family along one axis of a tensor and
``family_unlift_1d`` inverts it; kernel K4 (``csrc/lifting_dwt.cu``) takes
the same tables as arguments.

Every constant multiplies or divides as a 0-d tensor of x's dtype on x's
device (``scalar``): jnp rounds a weakly typed Python float to the array's
dtype before the operation, where PyTorch would multiply a bf16 or f16
tensor by the float in f32 and round once.  In f32 the two are the same.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
SQRT3 = math.sqrt(3.0)

# A lifting step: (target_parity, ((shift, coeff), ...)).  The target is
# updated in place: target += Σ coeff · other_parity[i + shift], where the
# shifted reads are zero-padded at the boundary.  A family is
# (steps, k): after the steps, s = even · k and d = odd / k.

# Daubechies-4 (main/transforms/wavelets/daub_4.py:13-18,36-56)
DAUB4 = (
    (
        ("odd", ((0, -SQRT3),)),
        ("even", ((0, SQRT3 / 4), (1, SQRT3 / 4 - 0.5))),
        ("odd", ((-1, 1.0),)),
    ),
    SQRT2 / (SQRT3 - 1.0),
)

# CDF-5/3 / LeGall (main/transforms/wavelets/cdf_53.py:12-16,33-48)
CDF53 = (
    (
        ("even", ((0, 0.5), (-1, 0.5))),
        ("odd", ((0, -0.25), (1, -0.25))),
    ),
    1.0 / SQRT2,
)

# Coiflet-12 (main/transforms/wavelets/coif_12.py:13-31,49-92)
COIF12 = (
    (
        ("odd", ((0, -0.39520948862008249600415913266649),)),
        ("even", ((-1, -0.48655312628154701078674682416871),
                  (0, 0.34182037906645991456878962138632))),
        ("odd", ((0, 0.10235638480685384291527469685450),
                 (1, 0.49406182054950645910185125597459))),
        ("even", ((-1, 1.4797286989698764170787088773944),
                  (0, -0.13092196383207654932078039205548))),
        ("odd", ((0, -0.052511342781614624300382842518317),
                 (1, -0.42871598963852709829190509623418))),
        ("even", ((0, 0.48314673498579849761338161048476),
                  (1, -0.13167038803475010475940887807146))),
        ("odd", ((-1, 0.014654934661776989040780649404570),)),
    ),
    0.57731685148133084859470943250514,
)

# Biorthogonal spline 3/3 (main/transforms/wavelets/bior_spline_33.py:12-19,37-58)
BIOR33 = (
    (
        ("even", ((-1, -1.0 / 3),)),
        ("odd", ((0, -9.0 / 8), (1, -3.0 / 8))),
        ("even", ((-1, 1.0 / 12), (0, 4.0 / 9), (1, -1.0 / 12))),
    ),
    3.0 / SQRT2,
)

# Biorthogonal spline 3/5 (bior_spline_35.py:12-21,39-62)
BIOR35 = (
    (
        ("even", ((-1, -1.0 / 3),)),
        ("odd", ((0, -9.0 / 8), (1, -3.0 / 8))),
        ("even", ((-2, -5.0 / 288), (-1, 17.0 / 144), (0, 4.0 / 9),
                  (1, -17.0 / 144), (2, 5.0 / 288))),
    ),
    3.0 / SQRT2,
)

# Biorthogonal spline 3/7 (bior_spline_37.py:12-23,41-68).  NB the first
# two steps read the opposite-side neighbours vs 3/3 / 3/5.
BIOR37 = (
    (
        ("even", ((1, -1.0 / 3),)),
        ("odd", ((-1, -3.0 / 8), (0, -9.0 / 8))),
        ("even", ((-3, -35.0 / 9216), (-2, 25.0 / 768), (-1, -421.0 / 3072),
                  (0, 4.0 / 9), (1, 421.0 / 3072), (2, -25.0 / 768),
                  (3, 35.0 / 9216))),
    ),
    3.0 / SQRT2,
)

# Biorthogonal spline 3/9 (bior_spline_39.py:12-25,43-74)
BIOR39 = (
    (
        ("even", ((1, -1.0 / 3),)),
        ("odd", ((-1, -3.0 / 8), (0, -9.0 / 8))),
        ("even", ((-4, 7.0 / 8192), (-3, -329.0 / 36864), (-2, 547.0 / 12288),
                  (-1, -1831.0 / 12288), (0, 4.0 / 9), (1, 1831.0 / 12288),
                  (2, -547.0 / 12288), (3, 329.0 / 36864), (4, -7.0 / 8192))),
    ),
    3.0 / SQRT2,
)

# Biorthogonal spline 4/8 (bior_spline_48.py:12-25,43-74)
BIOR48 = (
    (
        ("even", ((-1, -0.25), (0, -0.25))),
        ("odd", ((0, -1.0), (1, -1.0))),
        ("even", ((-4, -63.0 / 32768), (-3, 595.0 / 32768),
                  (-2, -2687.0 / 32768), (-1, 8299.0 / 32768),
                  (0, 8299.0 / 32768), (1, -2687.0 / 32768),
                  (2, 595.0 / 32768), (3, -63.0 / 32768))),
    ),
    2.0 * SQRT2,
)

# Reverse biorthogonal splines: predict/update roles swap parity
# (rev_bior_spline_33.py:12-19,37-58 etc.); k = √2/3 for all of them.
REV_BIOR33 = (
    (
        ("odd", ((1, 1.0 / 3),)),
        ("even", ((-1, 3.0 / 8), (0, 9.0 / 8))),
        ("odd", ((-1, 1.0 / 12), (0, -4.0 / 9), (1, -1.0 / 12))),
    ),
    SQRT2 / 3.0,
)

REV_BIOR35 = (
    (
        ("odd", ((1, 1.0 / 3),)),
        ("even", ((-1, 3.0 / 8), (0, 9.0 / 8))),
        ("odd", ((-2, -5.0 / 288), (-1, 17.0 / 144), (0, -4.0 / 9),
                 (1, -17.0 / 144), (2, 5.0 / 288))),
    ),
    SQRT2 / 3.0,
)

REV_BIOR37 = (
    (
        ("odd", ((1, 1.0 / 3),)),
        ("even", ((-1, 3.0 / 8), (0, 9.0 / 8))),
        ("odd", ((-3, 35.0 / 9216), (-2, -25.0 / 768), (-1, 421.0 / 3072),
                 (0, -4.0 / 9), (1, -421.0 / 3072), (2, 25.0 / 768),
                 (3, -35.0 / 9216))),
    ),
    SQRT2 / 3.0,
)

REV_BIOR39 = (
    (
        ("odd", ((1, 1.0 / 3),)),
        ("even", ((-1, 3.0 / 8), (0, 9.0 / 8))),
        ("odd", ((-4, -7.0 / 8192), (-3, 329.0 / 36864), (-2, -547.0 / 12288),
                 (-1, 1831.0 / 12288), (0, -4.0 / 9), (1, -1831.0 / 12288),
                 (2, 547.0 / 12288), (3, -329.0 / 36864), (4, 7.0 / 8192))),
    ),
    SQRT2 / 3.0,
)

# rev_bior_spline_48.py:12-25,43-74 — NB the last step's taps span [-3, +4]
# (asymmetric, as in the reference).
REV_BIOR48 = (
    (
        ("odd", ((0, 0.25), (1, 0.25))),
        ("even", ((-1, 1.0), (0, 1.0))),
        ("odd", ((-3, 63.0 / 32768), (-2, -595.0 / 32768),
                 (-1, 2687.0 / 32768), (0, -8299.0 / 32768),
                 (1, -8299.0 / 32768), (2, 2687.0 / 32768),
                 (3, -595.0 / 32768), (4, 63.0 / 32768))),
    ),
    SQRT2 / 3.0,
)

LIFTING_FAMILIES = {
    "daub4": DAUB4,
    "cdf53": CDF53,
    "coif12": COIF12,
    "bior33": BIOR33,
    "bior35": BIOR35,
    "bior37": BIOR37,
    "bior39": BIOR39,
    "bior48": BIOR48,
    "rev_bior33": REV_BIOR33,
    "rev_bior35": REV_BIOR35,
    "rev_bior37": REV_BIOR37,
    "rev_bior39": REV_BIOR39,
    "rev_bior48": REV_BIOR48,
}

# reference-style aliases (file names under main/transforms/wavelets/)
FAMILY_ALIASES = {
    "daub_4": "daub4",
    "cdf_53": "cdf53",
    "coif_12": "coif12",
    "bior_spline_33": "bior33",
    "bior_spline_35": "bior35",
    "bior_spline_37": "bior37",
    "bior_spline_39": "bior39",
    "bior_spline_48": "bior48",
    "rev_bior_spline_33": "rev_bior33",
    "rev_bior_spline_35": "rev_bior35",
    "rev_bior_spline_37": "rev_bior37",
    "rev_bior_spline_39": "rev_bior39",
    "rev_bior_spline_48": "rev_bior48",
}


def resolve_family(name: str):
    key = FAMILY_ALIASES.get(name, name)
    if key not in LIFTING_FAMILIES:
        raise ValueError(
            f"unknown lifting family {name!r}; choose from "
            f"{sorted(LIFTING_FAMILIES) + sorted(FAMILY_ALIASES)}"
        )
    return key, LIFTING_FAMILIES[key]


def shift(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x[i] -> x[i+n] along ``dim``, zero-padded (reference pos/neg_shift_4d).

    Also right where |n| reaches the length (all zeros), which the JAX
    version does not handle."""
    if n == 0:
        return x
    dim = dim % x.dim()
    size = x.shape[dim]
    keep = max(size - abs(n), 0)
    pad = [0, 0] * (x.dim() - 1 - dim)
    if n > 0:
        return F.pad(x.narrow(dim, min(n, size), keep), pad + [0, size - keep])
    return F.pad(x.narrow(dim, 0, keep), pad + [size - keep, 0])


def split_even_odd(x: torch.Tensor, dim: int):
    """Even and odd samples along ``dim`` (strided views)."""
    dim = dim % x.dim()
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(0, None, 2)
    even = x[tuple(idx)]
    idx[dim] = slice(1, None, 2)
    return even, x[tuple(idx)]


def interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of ``split_even_odd``: even and odd samples back in turn."""
    dim = dim % even.dim()
    shape = list(even.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def scalar(c: float, like: torch.Tensor) -> torch.Tensor:
    """``c`` as a 0-d tensor in ``like``'s dtype, on its device."""
    return torch.full((), c, dtype=like.dtype, device=like.device)


def multiply(x: torch.Tensor, c: float) -> torch.Tensor:
    """x · c with c rounded to x's dtype first, as jnp's ``c * x``."""
    return scalar(c, x) * x


def divide(x: torch.Tensor, k: float) -> torch.Tensor:
    """x / k as a true division in x's dtype.  (PyTorch's CUDA ``x / float``
    multiplies by the reciprocal; the JAX package and kernel K4 divide.)"""
    return x / scalar(k, x)


def _apply_taps(src, taps, dim: int):
    acc = None
    for n, coeff in taps:
        term = multiply(shift(src, n, dim), coeff)
        acc = term if acc is None else acc + term
    return acc


def family_lift_1d(x: torch.Tensor, dim: int, family):
    """One 1D lifting pass; returns the scaled (s, d) halves (not
    concatenated)."""
    steps, k = family
    even, odd = split_even_odd(x, dim)
    for target, taps in steps:
        if target == "even":
            even = even + _apply_taps(odd, taps, dim)
        else:
            odd = odd + _apply_taps(even, taps, dim)
    return multiply(even, k), divide(odd, k)


def family_unlift_1d(s: torch.Tensor, d: torch.Tensor, dim: int, family):
    """Exact inverse of ``family_lift_1d``: unscale, undo the steps in
    reverse, interleave (``lifting_families.py:273-286``)."""
    steps, k = family
    even, odd = divide(s, k), multiply(d, k)
    for target, taps in reversed(steps):
        if target == "even":
            even = even - _apply_taps(odd, taps, dim)
        else:
            odd = odd - _apply_taps(even, taps, dim)
    return interleave(even, odd, dim)
