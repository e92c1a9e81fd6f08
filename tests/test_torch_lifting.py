"""The port's lifting DWT and K4's plain version against irw_tpu.

``lifting_dwt2``, ``lifting_decompose`` and ``subband_stack`` against
``irw_tpu.ops.wavelets.lifting`` for haar, cdf97 and every family and alias;
``lifting_multi_level_plain`` against ``lifting_multi_level_pallas`` in
interpret mode, as tests/test_wavelets.py runs it.  Inputs are unit normal.

Tolerances, in f32, scaled by max(1, max|ref|) (bands reach about 5):
1e-6 for haar and 1e-5 for the rest against the jnp lifting (XLA fuses the
jitted chain and contracts some multiply-adds: up to two ulps apart), 1e-5
for haar and 1e-4 for the rest against the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.ops.wavelets import lifting as jax_lifting
from irw_tpu.ops.wavelets.lifting_families import FAMILY_ALIASES, LIFTING_FAMILIES
from irw_tpu.ops.wavelets.pallas_dwt import lifting_multi_level_pallas
from irw_tpu_torch.ops.wavelets import lifting
from irw_tpu_torch.ops.wavelets import lifting_families as families
from irw_tpu_torch.ops.wavelets.lifting_dwt import kernel_steps, lifting_multi_level_plain

BASES = ["haar", "cdf97", *LIFTING_FAMILIES, *FAMILY_ALIASES]


def close(ours, ref, tol):
    ref = np.asarray(ref)
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def tol_of(basis, haar=1e-6, other=1e-5):
    return haar if basis == "haar" else other


def test_family_tables_match():
    import irw_tpu.ops.wavelets.lifting_families as jax_families

    assert families.LIFTING_FAMILIES == jax_families.LIFTING_FAMILIES
    assert families.FAMILY_ALIASES == jax_families.FAMILY_ALIASES
    assert families.resolve_family("bior_spline_48") == jax_families.resolve_family("bior_spline_48")
    with pytest.raises(ValueError, match="unknown lifting family"):
        families.resolve_family("db2")
    for name in ("CDF97_A1", "CDF97_A2", "CDF97_A3", "CDF97_A4", "CDF97_K", "COEFFS_SCALES_2D"):
        assert getattr(lifting, name) == getattr(jax_lifting, name)


@pytest.mark.parametrize("n", [-5, -2, 0, 1, 3, 7])
def test_shift_is_zero_padded(n):
    x = torch.arange(1.0, 7.0).reshape(1, 6).repeat(2, 1)
    ref = np.array([(i + n + 1.0) if 0 <= i + n < 6 else 0.0 for i in range(6)])
    np.testing.assert_array_equal(families.shift(x, n, dim=-1).numpy(), np.tile(ref, (2, 1)))
    np.testing.assert_array_equal(families.shift(x.T, n, dim=0).numpy(), np.tile(ref, (2, 1)).T)


@pytest.mark.parametrize("basis", BASES)
def test_dwt2_decompose_and_stack_match_jax(basis):
    rng = np.random.RandomState(0)
    tol = tol_of(basis)
    # 30 x 22: haar and the families lift it as is, cdf97 pads it to 32 x 24
    x = rng.randn(2, 3, 30, 22).astype(np.float32)
    for ours, ref in zip(lifting.lifting_dwt2(torch.from_numpy(x), basis),
                         jax_lifting.lifting_dwt2(jnp.asarray(x), basis)):
        close(ours, ref, tol)
    x = rng.randn(2, 3, 32, 24).astype(np.float32)
    approx, details = lifting.lifting_decompose(torch.from_numpy(x), levels=2, basis=basis)
    japprox, jdetails = jax_lifting.lifting_decompose(jnp.asarray(x), levels=2, basis=basis)
    for lvl in range(2):
        close(approx[lvl], japprox[lvl], tol)
        for ours, ref in zip(details[lvl], jdetails[lvl]):
            close(ours, ref, tol)
    images = rng.randn(2, 32, 24, 3).astype(np.float32)
    close(lifting.subband_stack(torch.from_numpy(images), 2, basis),
          jax_lifting.subband_stack(jnp.asarray(images), 2, basis), tol)
    close(lifting.subband_stack(torch.from_numpy(images), 1, basis, ll_only=True),
          jax_lifting.subband_stack(jnp.asarray(images), 1, basis, ll_only=True), tol)


def test_unknown_basis_raises():
    with pytest.raises(ValueError, match="unknown lifting basis"):
        lifting.lifting_dwt2(torch.zeros(4, 4), "db2")
    with pytest.raises(ValueError, match="unknown lifting basis"):
        lifting_multi_level_plain(torch.zeros(1, 4, 4), 1, "db2")
    with pytest.raises(ValueError, match="divide"):
        lifting_multi_level_plain(torch.zeros(1, 6, 8), 2, "haar")


@pytest.mark.parametrize("basis", ["haar", "cdf97", "daub4", "bior48", "rev_bior39"])
@pytest.mark.parametrize("levels", [1, 2])
def test_k4_plain_matches_pallas(basis, levels):
    x = np.random.RandomState(levels).randn(5, 32, 40).astype(np.float32)
    ours = lifting_multi_level_plain(torch.from_numpy(x), levels, basis)
    ref = lifting_multi_level_pallas(jnp.asarray(x), levels=levels, basis=basis, interpret=True)
    assert ours.shape == (5, 4, 32 >> levels, 40 >> levels) and ours.dtype == torch.float32
    close(ours, ref, tol_of(basis, 1e-5, 1e-4))


def test_k4_plain_computes_in_the_input_dtype():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 8).astype(np.float64))
    assert lifting_multi_level_plain(x, 1, "cdf97").dtype == torch.float64
    assert lifting_multi_level_plain(x.to(torch.bfloat16), 1, "haar").dtype == torch.bfloat16


@pytest.mark.parametrize("basis", ["haar", "cdf97", "coif12", "bior39"])
def test_kernel_tables_compute_the_lift(basis):
    """K4's step table, run by a plain interpreter, gives the plain lift bit
    for bit: the table is what the kernel executes (csrc/lifting_dwt.cu)."""
    x = torch.from_numpy(np.random.RandomState(3).randn(3, 20).astype(np.float32))
    steps, k = kernel_steps(basis)
    halves = list(families.split_even_odd(x, -1))
    for target, pair, shifts, coeffs in steps:
        src = halves[1 - target]
        if pair:
            upd = coeffs[0] * (families.shift(src, shifts[0], -1) + families.shift(src, shifts[1], -1))
        else:
            upd = None
            for n, c in zip(shifts, coeffs):
                term = c * families.shift(src, n, -1)
                upd = term if upd is None else upd + term
        halves[target] = halves[target] + upd
    s, d = lifting.lift_1d(x, basis, -1)
    assert torch.equal(halves[0] * k, s) and torch.equal(families.divide(halves[1], k), d)
