"""Wavelet transforms of the port (``irw_tpu/ops/wavelets/__init__.py:27-72``
under the port's names):

- ``lifting``: the lifting DWT of haar, cdf97 and the 13 families, forward
  and inverse, in plain PyTorch;
- ``dwt``: the separable filter-bank ``dwt2``/``wavedec2``/``swt2`` and their
  inverses (``filters`` holds the banks), plain PyTorch in full f32;
- ``lifting_dwt``: the fused multi-level lifting DWT, kernel K4, and its
  wrappers ``haar_multi_level``, ``cdf97_multi_level`` and ``haar_dwt2_fused``
  (the JAX package's ``*_pallas`` functions);
- ``swt``: the level-1 Haar SWT, kernel K1;
- ``resize``: ``jax.image.resize(method="bilinear")``'s arithmetic, for
  ``ResizeSubBands``.
"""

from irw_tpu_torch.ops.wavelets.dwt import dwt2, idwt2, iswt2, swt2, wavedec2, waverec2
from irw_tpu_torch.ops.wavelets.filters import WAVELET_FILTERS, get_filters
from irw_tpu_torch.ops.wavelets.lifting import (
    COEFFS_SCALES_2D,
    cdf97_dwt2,
    cdf97_idwt2,
    haar_dwt2,
    haar_idwt2,
    lifting_decompose,
    lifting_dwt2,
    lifting_idwt2,
    subband_stack,
)
from irw_tpu_torch.ops.wavelets.lifting_dwt import (
    cdf97_multi_level,
    haar_dwt2_fused,
    haar_multi_level,
    lifting_multi_level,
    lifting_multi_level_plain,
)
from irw_tpu_torch.ops.wavelets.lifting_families import (
    FAMILY_ALIASES,
    LIFTING_FAMILIES,
    resolve_family,
)
from irw_tpu_torch.ops.wavelets.resize import resize_bilinear
from irw_tpu_torch.ops.wavelets.swt import haar_swt2, haar_swt2_plain

__all__ = [
    "WAVELET_FILTERS",
    "get_filters",
    "COEFFS_SCALES_2D",
    "haar_dwt2",
    "haar_idwt2",
    "cdf97_dwt2",
    "cdf97_idwt2",
    "lifting_dwt2",
    "lifting_idwt2",
    "lifting_decompose",
    "subband_stack",
    "FAMILY_ALIASES",
    "LIFTING_FAMILIES",
    "resolve_family",
    "dwt2",
    "idwt2",
    "swt2",
    "iswt2",
    "wavedec2",
    "waverec2",
    "haar_dwt2_fused",
    "haar_multi_level",
    "cdf97_multi_level",
    "lifting_multi_level",
    "lifting_multi_level_plain",
    "haar_swt2",
    "haar_swt2_plain",
    "resize_bilinear",
]
