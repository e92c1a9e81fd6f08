"""Wavelet transforms of the served slices: the level-1 Haar SWT (K1) and the
lifting DWT with its fused multi-level kernel (K4)."""

from irw_tpu_torch.ops.wavelets.lifting import (
    lifting_decompose,
    lifting_dwt2,
    subband_stack,
)
from irw_tpu_torch.ops.wavelets.lifting_dwt import (
    lifting_multi_level,
    lifting_multi_level_plain,
)
from irw_tpu_torch.ops.wavelets.swt import haar_swt2, haar_swt2_plain

__all__ = ["haar_swt2", "haar_swt2_plain", "lifting_decompose", "lifting_dwt2",
           "lifting_multi_level", "lifting_multi_level_plain", "subband_stack"]
