"""The port's filter-bank DWT/SWT library and bilinear resize against irw_tpu.

``filters`` is held equal to the JAX package's tables.  ``dwt2``/``idwt2``
through ``wavedec2``/``waverec2`` at two levels, per extension mode ×
wavelet × an even and an odd size, and ``swt2``/``iswt2`` per wavelet ×
level, run on the same seeded numpy input in both packages; the port also
reconstructs its own input, as tests/test_wavelets.py requires of the JAX
package.  ``resize_bilinear`` is held to ``jax.image.resize(method=
"bilinear")``, upsampling (56 → 112, as ``dwt_all_subs`` does; 56 → 256, as
``sdd_dwt_all_subs`` does) and downsampling.

Tolerances, f32, scaled by max(1, max|ref|): 1e-5 for the conv paths (the
JAX package convolves with XLA at HIGHEST precision, the port sums the taps
in tap order) and their reconstructions, 1e-6 for the resize (the same f32
weights; einsum and the port's gathered taps add them in another order).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.ops.wavelets import dwt as jax_dwt
from irw_tpu.ops.wavelets import filters as jax_filters
from irw_tpu_torch.ops.wavelets import (
    WAVELET_FILTERS,
    get_filters,
    iswt2,
    resize_bilinear,
    swt2,
    wavedec2,
    waverec2,
)
from irw_tpu_torch.ops.wavelets.dwt import dwt2, idwt2
from irw_tpu_torch.ops.wavelets.resize import weight_taps

CONV_TOL = 1e-5
RESIZE_TOL = 1e-6


def close(ours, ref, tol):
    ref = np.asarray(ref)
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def test_filter_banks_match_jax():
    assert sorted(WAVELET_FILTERS) == sorted(jax_filters.WAVELET_FILTERS)
    for name, bank in jax_filters.WAVELET_FILTERS.items():
        ours = get_filters(name)
        assert len(ours) == 4 and all(f.dtype == np.float64 for f in ours)
        for a, b in zip(ours, bank):
            np.testing.assert_array_equal(a, b)
        # one even length: the uniform phase rule's form
        assert len({len(f) for f in ours}) == 1 and len(ours[0]) % 2 == 0
    with pytest.raises(ValueError, match="unknown wavelet"):
        get_filters("db3")


MODES = ["periodization", "zero", "symmetric", "reflect"]
WAVELETS = ["haar", "db2", "cdf97", "coif1"]
DWT_CASES = [(w, m, s) for w in WAVELETS for m in MODES for s in ((16, 20), (17, 15))
             if not (m == "periodization" and s[0] % 2)]


@pytest.mark.parametrize("wavelet,mode,size", DWT_CASES)
def test_wavedec2_waverec2_match_jax(wavelet, mode, size):
    """Two levels of ``dwt2`` through ``wavedec2`` (pywt's sizes outside
    periodization: floor((n + L − 1)/2) a side), then ``waverec2`` with its
    crop of an odd level: the same coefficients as the JAX package, and the
    input back."""
    x = np.random.RandomState(len(wavelet) + size[0]).randn(2, *size).astype(np.float32)
    ours = wavedec2(torch.from_numpy(x), wavelet, level=2, mode=mode)
    ref = jax_dwt.wavedec2(jnp.asarray(x), wavelet, level=2, mode=mode)
    assert len(ours) == len(ref) == 3
    close(ours[0], ref[0], CONV_TOL)
    for details, jdetails in zip(ours[1:], ref[1:]):
        for band, jband in zip(details, jdetails):
            close(band, jband, CONV_TOL)
    back = waverec2(ours, wavelet, mode=mode)
    close(back, jax_dwt.waverec2(ref, wavelet, mode=mode), CONV_TOL)
    close(back[..., :size[0], :size[1]], x, CONV_TOL)


def test_dwt2_haar_symmetric_is_periodization_on_even_sizes():
    """The size policy ``DWTTransform`` relies on: haar halves an even axis
    in every mode, with the same numbers (``dwt.py:22-28``)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 12, 8).astype(np.float32))
    (ca, det), (ca_p, det_p) = dwt2(x, "haar", "symmetric"), dwt2(x, "haar", "periodization")
    assert ca.shape == (3, 6, 4)
    for a, b in zip((ca, *det), (ca_p, *det_p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    close(idwt2(ca, det, "haar", "symmetric"), x.numpy(), CONV_TOL)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="extension mode"):
        dwt2(torch.zeros(1, 8, 8), "haar", "wrap")


@pytest.mark.parametrize("wavelet", ["haar", "db2", "sym4"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_swt2_iswt2_match_jax(wavelet, level):
    """``swt2`` coarsest first, every band shaped like x; ``iswt2`` undoes
    the à trous levels through the phase split."""
    x = np.random.RandomState(level).randn(2, 32, 24).astype(np.float32)
    ours = swt2(torch.from_numpy(x), wavelet, level=level)
    ref = jax_dwt.swt2(jnp.asarray(x), wavelet, level=level)
    assert len(ours) == len(ref) == level
    for (ca, details), (jca, jdetails) in zip(ours, ref):
        assert ca.shape == x.shape
        close(ca, jca, CONV_TOL)
        for band, jband in zip(details, jdetails):
            close(band, jband, CONV_TOL)
    back = iswt2(ours, wavelet)
    close(back, jax_dwt.iswt2(ref, wavelet), CONV_TOL)
    close(back, x, CONV_TOL)


@pytest.mark.parametrize("src,dst", [(56, 112), (56, 256), (56, 24), (16, 16), (10, 7),
                                     ((20, 30), (40, 12))])
def test_resize_matches_jax(src, dst):
    h, w = (src, src) if isinstance(src, int) else src
    oh, ow = (dst, dst) if isinstance(dst, int) else dst
    x = np.random.RandomState(h + w).randn(3, h, w, 3).astype(np.float32)
    ours = resize_bilinear(torch.from_numpy(x), dst)
    ref = jax.image.resize(jnp.asarray(x), (3, oh, ow, 3), method="bilinear")
    close(ours, ref, RESIZE_TOL)


def test_resize_weights_are_the_antialiased_triangle():
    """Upsampling reads two samples an output, downsampling widens the
    triangle by 1/scale; each output's weights sum to 1."""
    index, taps = weight_taps(56, 112)
    assert index.shape == (112, 2)
    np.testing.assert_allclose(taps.sum(axis=1), 1.0, atol=1e-6)
    index, taps = weight_taps(56, 24)
    assert index.shape[1] > 2
    np.testing.assert_allclose(taps.sum(axis=1), 1.0, atol=1e-6)
