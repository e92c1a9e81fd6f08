"""Wavelet transforms of the served slice: the level-1 Haar SWT."""

from irw_tpu_torch.ops.wavelets.swt import haar_swt2, haar_swt2_plain

__all__ = ["haar_swt2", "haar_swt2_plain"]
