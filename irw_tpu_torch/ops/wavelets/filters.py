"""Wavelet filter banks (the port's copy of
``irw_tpu/ops/wavelets/filters.py:28-168``; the port imports nothing of the
JAX package).

Standard published coefficients for the families the reference uses or
carries: Haar/Daubechies/Symlet/Coiflet (orthogonal) and the CDF
biorthogonal-spline families (cdf53 = bior2.2 = LeGall 5/3, cdf97 = bior4.4 =
the JPEG2000 9/7 filter, the reference's second lifting basis).

Each bank is ``(dec_lo, dec_hi, rec_lo, rec_hi)`` float64 arrays in
**convolution form**, normalised so that all four filters share one even
length ``L`` and the single phase rule

    analysis:   a[k] = Σ_m dec[m] · x[(2k − m + 1) mod n]
    synthesis:  x[i] += Σ_{2k+m−(L−2) ≡ i} rec[m] · c[k]

gives perfect reconstruction under periodic extension.  Odd-length
biorthogonal banks are brought into this form by zero-padding dec_lo/rec_hi
on the left and dec_hi/rec_lo on the right (this shifts the two channels'
windows by the one sample the symmetric filters require).
"""

from __future__ import annotations

import math

import numpy as np

_SQRT2 = math.sqrt(2.0)

# --- Orthogonal scaling filters (synthesis lowpass h) ------------------------

_HAAR_LO = np.array([1.0, 1.0]) / _SQRT2

_DB2_LO = np.array(
    [0.48296291314469025, 0.8365163037378079, 0.22414386804185735, -0.12940952255092145]
)

_DB4_LO = np.array(
    [
        0.23037781330885523,
        0.7148465705525415,
        0.6308807679295904,
        -0.02798376941698385,
        -0.18703481171888114,
        0.030841381835986965,
        0.032883011666982945,
        -0.010597401784997278,
    ]
)

_SYM4_LO = np.array(
    [
        0.032223100604042702,
        -0.012603967262037833,
        -0.099219543576847216,
        0.29785779560527736,
        0.80373875180591614,
        0.49761866763201545,
        -0.02963552764599851,
        -0.075765714789273325,
    ]
)

_COIF1_LO = np.array(
    [
        -0.01565572813546454,
        -0.0727326195128539,
        0.38486484686420286,
        0.8525720202122554,
        0.3378976624578092,
        -0.0727326195128539,
    ]
)

# --- Biorthogonal (analysis lowpass, synthesis lowpass) ---------------------

_CDF53_DEC_LO = np.array([-1.0, 2.0, 6.0, 2.0, -1.0]) / (4.0 * _SQRT2)
_CDF53_REC_LO = np.array([0.0, 1.0, 2.0, 1.0, 0.0]) / (2.0 * _SQRT2)

_CDF97_DEC_LO = _SQRT2 * np.array(
    [
        0.026748757410810,
        -0.016864118442875,
        -0.078223266528990,
        0.266864118442875,
        0.602949018236360,
        0.266864118442875,
        -0.078223266528990,
        -0.016864118442875,
        0.026748757410810,
    ]
)
_CDF97_REC_LO = _SQRT2 * np.array(
    [
        0.0,
        -0.045635881557125,
        -0.028771763114250,
        0.295635881557125,
        0.557543526228500,
        0.295635881557125,
        -0.028771763114250,
        -0.045635881557125,
        0.0,
    ]
)


def _orthogonal_bank(h):
    """Conv-form bank from an even-length orthogonal scaling filter."""
    rec_lo = np.asarray(h, dtype=np.float64)
    dec_lo = rec_lo[::-1].copy()
    k = np.arange(len(h))
    rec_hi = (-1.0) ** k * dec_lo
    dec_hi = (-1.0) ** (k + 1) * rec_lo
    return dec_lo, dec_hi, rec_lo, rec_hi


def _biorthogonal_bank(dec_lo, rec_lo):
    """Conv-form bank from an odd-length symmetric biorthogonal pair,
    zero-padded to the even common length that satisfies the uniform phase
    rule (see module docstring)."""
    dec_lo = np.asarray(dec_lo, dtype=np.float64)
    rec_lo = np.asarray(rec_lo, dtype=np.float64)
    k = np.arange(len(dec_lo))
    dec_hi = (-1.0) ** k * rec_lo
    rec_hi = (-1.0) ** k * dec_lo
    # normalise to common even length: highpass channel needs a +1 analysis
    # window shift and a −1 synthesis shift relative to lowpass
    dec_lo = np.insert(dec_lo, 0, 0.0)
    rec_hi = np.insert(rec_hi, 0, 0.0)
    dec_hi = np.append(dec_hi, 0.0)
    rec_lo = np.append(rec_lo, 0.0)
    return dec_lo, dec_hi, rec_lo, rec_hi


def _build_all():
    banks = {}
    for name, lo in [
        ("haar", _HAAR_LO),
        ("db1", _HAAR_LO),
        ("db2", _DB2_LO),
        ("db4", _DB4_LO),
        ("sym4", _SYM4_LO),
        ("coif1", _COIF1_LO),
    ]:
        banks[name] = _orthogonal_bank(lo)
    for name, (dlo, rlo) in [
        ("cdf53", (_CDF53_DEC_LO, _CDF53_REC_LO)),
        ("bior2.2", (_CDF53_DEC_LO, _CDF53_REC_LO)),
        ("cdf97", (_CDF97_DEC_LO, _CDF97_REC_LO)),
        ("bior4.4", (_CDF97_DEC_LO, _CDF97_REC_LO)),
    ]:
        banks[name] = _biorthogonal_bank(dlo, rlo)
    return banks


WAVELET_FILTERS = _build_all()


def get_filters(name: str):
    """Return (dec_lo, dec_hi, rec_lo, rec_hi) float64 arrays for a named
    wavelet (conv form, common even length)."""
    try:
        return WAVELET_FILTERS[name]
    except KeyError as exc:
        raise ValueError(
            f"unknown wavelet {name!r}; available: {sorted(WAVELET_FILTERS)}"
        ) from exc
