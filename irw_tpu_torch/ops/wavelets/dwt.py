"""Separable filter-bank DWT and SWT in plain PyTorch (port of
``irw_tpu/ops/wavelets/dwt.py:50-296``): ``dwt2``, ``idwt2``, ``wavedec2``,
``waverec2``, ``swt2`` and ``iswt2``, the pywt-style transforms of
``DWTTransform`` and ``SWTTransform``.

Conventions, as in the JAX package:

- filters from ``filters.get_filters`` (conv form, one even length L);
- ``periodization`` halves each axis exactly and reconstructs exactly;
  ``zero``, ``symmetric`` and ``reflect`` follow pywt's non-periodized
  algebra: extend by L − 1 a side, convolve, keep the odd phase, giving
  ``floor((n + L − 1) / 2)`` coefficients a side; synthesis trims L − 2 a
  side;
- bands in pywt's order ``(cA, (cH, cV, cD))``: cH high along H, cV high
  along W;
- ``swt2`` returns its levels coarsest first, each shaped like x.

The JAX package convolves with ``lax.conv_general_dilated`` at
``Precision.HIGHEST``.  Here every filter is a run of shifted multiply-adds
(a filter has 10 taps at most), so the card computes in full f32 whatever
the TF32 settings of cuDNN and cuBLAS: no convolution or matmul is called.
The JAX package has no kernel on this path; this module is plain PyTorch on
every device.
"""

from __future__ import annotations

import numpy as np
import torch

from irw_tpu_torch.ops.wavelets.filters import get_filters

MODES = ("periodization", "zero", "symmetric", "reflect")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown extension mode {mode!r}; one of {list(MODES)}")


def _pad_1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the last axis by (left, right) with the given signal extension
    (``dwt.py:50-70``): periodization concatenates the wrapped ends, the
    others are numpy's ``zero``/``symmetric``/``reflect`` padding."""
    if left == 0 and right == 0:
        return x
    if mode == "zero":
        return torch.nn.functional.pad(x, (left, right))
    n = x.shape[-1]
    ar = np.arange(n)
    if mode == "periodization":
        idx = np.concatenate([ar[n - left:] if left else ar[:0], ar, ar[:right]])
    else:
        idx = np.pad(ar, (left, right), mode=mode)
    return x[..., torch.from_numpy(idx).to(x.device)]


def _taps(filters, like: torch.Tensor) -> torch.Tensor:
    """A filter stack as a tensor of x's dtype on x's device: its taps are
    0-d tensors, as ``jnp.asarray(kernels, dtype=x.dtype)``."""
    return torch.as_tensor(np.asarray(filters, dtype=np.float64), dtype=like.dtype,
                           device=like.device)


def _correlate(x: torch.Tensor, taps: torch.Tensor, stride: int = 1,
               dilation: int = 1) -> torch.Tensor:
    """Valid cross-correlation of the last axis with one filter:
    out[i] = Σ_m taps[m] · x[stride·i + dilation·m]."""
    span = dilation * (len(taps) - 1)
    n_out = (x.shape[-1] - span - 1) // stride + 1
    acc = None
    for m in range(len(taps)):
        start = dilation * m
        term = taps[m] * x[..., start:start + stride * (n_out - 1) + 1:stride]
        acc = term if acc is None else acc + term
    return acc


def _analysis_1d(x, dec_lo, dec_hi, mode: str):
    """One decimating analysis pass along the last axis (``dwt.py:94-112``):
    (lo, hi), each n/2 long (periodization) or floor((n + L − 1)/2)."""
    L = len(dec_lo)
    xp = _pad_1d(x, L - 2, 0 if mode == "periodization" else L - 1, mode)
    taps = _taps(np.stack([dec_lo[::-1], dec_hi[::-1]]), x)
    return _correlate(xp, taps[0], stride=2), _correlate(xp, taps[1], stride=2)


def _synthesis_1d(lo, hi, rec_lo, rec_hi, mode: str):
    """Inverse of ``_analysis_1d`` along the last axis (``dwt.py:115-145``):
    upsample both channels with zeros, extend (periodically or with zeros),
    correlate with the reversed synthesis filters and add the channels; trim
    L − 2 a side outside periodization."""
    L = len(rec_lo)
    n = 2 * lo.shape[-1]
    ext = mode if mode == "periodization" else "zero"
    taps = _taps(np.stack([rec_lo[::-1], rec_hi[::-1]]), lo)
    out = None
    for coeffs, k in ((lo, taps[0]), (hi, taps[1])):
        up = torch.stack([coeffs, torch.zeros_like(coeffs)], dim=-1).reshape(
            coeffs.shape[:-1] + (n,))
        part = _correlate(_pad_1d(up, 1, L - 2, ext), k)
        out = part if out is None else out + part
    return out if mode == "periodization" else out[..., :n - L + 2]


def dwt2(x: torch.Tensor, wavelet: str = "haar", mode: str = "periodization"):
    """One-level 2D DWT on (..., H, W): ``(cA, (cH, cV, cD))``."""
    _check_mode(mode)
    dec_lo, dec_hi, _, _ = get_filters(wavelet)
    lo_h, hi_h = _analysis_1d(x.movedim(-2, -1), dec_lo, dec_hi, mode)   # rows pass
    lo_h, hi_h = lo_h.movedim(-1, -2), hi_h.movedim(-1, -2)
    ll, hl = _analysis_1d(lo_h, dec_lo, dec_hi, mode)                   # cols pass
    lh, hh = _analysis_1d(hi_h, dec_lo, dec_hi, mode)
    return ll, (lh, hl, hh)


def idwt2(cA: torch.Tensor, details, wavelet: str = "haar", mode: str = "periodization"):
    """Inverse of ``dwt2``."""
    _check_mode(mode)
    lh, hl, hh = details
    _, _, rec_lo, rec_hi = get_filters(wavelet)
    lo_h = _synthesis_1d(cA, hl, rec_lo, rec_hi, mode).movedim(-1, -2)
    hi_h = _synthesis_1d(lh, hh, rec_lo, rec_hi, mode).movedim(-1, -2)
    return _synthesis_1d(lo_h, hi_h, rec_lo, rec_hi, mode).movedim(-1, -2)


def wavedec2(x: torch.Tensor, wavelet: str = "haar", level: int = 1,
             mode: str = "periodization") -> list:
    """Multi-level 2D DWT in pywt's layout: ``[cA_n, (cH_n, cV_n, cD_n),
    ..., (cH_1, cV_1, cD_1)]``, coarsest first.  ``DWTTransform`` keeps
    ``coeffs[0]`` and ``coeffs[1]``."""
    coeffs = []
    for _ in range(level):
        x, details = dwt2(x, wavelet, mode)
        coeffs.append(details)
    return [x] + coeffs[::-1]


def waverec2(coeffs, wavelet: str = "haar", mode: str = "periodization") -> torch.Tensor:
    """Inverse of ``wavedec2``.  As pywt's waverec2, a level rebuilt from an
    odd length comes back one sample long an axis and is cropped to the next
    finer level's size before its synthesis."""
    x = coeffs[0]
    for details in coeffs[1:]:
        dh, dw = details[0].shape[-2:]
        if tuple(x.shape[-2:]) != (dh, dw):
            x = x[..., :dh, :dw]
        x = idwt2(x, details, wavelet, mode)
    return x


def _analysis_swt_1d(x, dec_lo, dec_hi, dilation: int):
    """Undecimated analysis along the last axis with the filters dilated
    (à trous) and periodic extension (``dwt.py:229-257``)."""
    L = len(dec_lo)
    n = x.shape[-1]
    xp = _pad_1d(x, (L - 2) * dilation, dilation, "periodization")
    taps = _taps(np.stack([dec_lo[::-1], dec_hi[::-1]]), x)
    return (_correlate(xp, taps[0], dilation=dilation)[..., :n],
            _correlate(xp, taps[1], dilation=dilation)[..., :n])


def swt2(x: torch.Tensor, wavelet: str = "haar", level: int = 1) -> list:
    """Stationary 2D wavelet transform on (..., H, W), periodic extension
    (pywt.swt2): a list, coarsest level first, of ``(cA, (cH, cV, cD))``,
    every band shaped like x."""
    dec_lo, dec_hi, _, _ = get_filters(wavelet)
    out = []
    approx = x
    for j in range(level):
        d = 2 ** j
        lo_h, hi_h = _analysis_swt_1d(approx.movedim(-2, -1), dec_lo, dec_hi, d)
        lo_h, hi_h = lo_h.movedim(-1, -2), hi_h.movedim(-1, -2)
        ll, hl = _analysis_swt_1d(lo_h, dec_lo, dec_hi, d)
        lh, hh = _analysis_swt_1d(hi_h, dec_lo, dec_hi, d)
        out.append((ll, (lh, hl, hh)))
        approx = ll
    return out[::-1]


def _iswt_1d(lo, hi, rec_lo, rec_hi, dilation: int):
    """Invert one undecimated level along the last axis (``dwt.py:264-281``):
    at dilation d, split into the d interleaved phase sequences and invert
    each at d = 1, where the even-phase coefficients rebuild x and the
    odd-phase ones a copy rolled by one sample; average the two."""
    n = lo.shape[-1]
    if dilation > 1:
        lead = lo.shape[:-1]
        lo_s = lo.reshape(lead + (n // dilation, dilation)).movedim(-1, 0)
        hi_s = hi.reshape(lead + (n // dilation, dilation)).movedim(-1, 0)
        rec = _iswt_1d(lo_s, hi_s, rec_lo, rec_hi, 1)
        return rec.movedim(0, -1).reshape(lead + (n,))
    even_rec = _synthesis_1d(lo[..., 0::2], hi[..., 0::2], rec_lo, rec_hi, "periodization")
    odd_rec = _synthesis_1d(lo[..., 1::2], hi[..., 1::2], rec_lo, rec_hi, "periodization")
    half = torch.full((), 0.5, dtype=lo.dtype, device=lo.device)
    return half * (even_rec + torch.roll(odd_rec, 1, dims=-1))


def iswt2(coeffs, wavelet: str = "haar") -> torch.Tensor:
    """Inverse of ``swt2`` (its coarsest-first list)."""
    _, _, rec_lo, rec_hi = get_filters(wavelet)
    coeffs = list(coeffs)
    level = len(coeffs)
    approx = coeffs[0][0]
    for idx, (_, (lh, hl, hh)) in enumerate(coeffs):
        d = 2 ** (level - 1 - idx)
        lo_h = _iswt_1d(approx, hl, rec_lo, rec_hi, d).movedim(-1, -2)
        hi_h = _iswt_1d(lh, hh, rec_lo, rec_hi, d).movedim(-1, -2)
        approx = _iswt_1d(lo_h, hi_h, rec_lo, rec_hi, d).movedim(-1, -2)
    return approx
