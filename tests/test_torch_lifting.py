"""The port's lifting DWT and K4's plain version against irw_tpu.

``lifting_dwt2``, ``lifting_decompose`` and ``subband_stack`` against
``irw_tpu.ops.wavelets.lifting`` for haar, cdf97 and every family and alias;
``lifting_multi_level_plain`` against ``lifting_multi_level_pallas`` in
interpret mode, as tests/test_wavelets.py runs it.  Inputs are unit normal.
Then K4's path rule and the reach its tile path loads (no card needed):
``kernel_reach`` held by perturbing the plain version, ``lifting_kernel_variants``
held to its cases and to the constants of csrc/lifting_dwt.cu.

Tolerances, in f32, scaled by max(1, max|ref|) (bands reach about 5):
1e-6 for haar and 1e-5 for the rest against the jnp lifting (XLA fuses the
jitted chain and contracts some multiply-adds: up to two ulps apart), 1e-5
for haar and 1e-4 for the rest against the Pallas kernel; the inverses
against the JAX inverses as the forward, and back to the input to 1e-5.

In bf16 the port rounds every constant to the dtype before it multiplies or
divides, as jnp rounds a weakly typed Python float, and computes each
operation in f32 rounded once, as XLA's CPU backend does for bf16: the
plain version and ``lifting_decompose`` equal the JAX functions bit for bit.

In f16 the reference's arithmetic depends on jit.  Op by op
(``jax.disable_jit``) each jnp operation rounds to f16 once, and the port
equals it bit for bit at every level.  Jitted, XLA's algebraic simplifier
rewrites the chain before it runs: ``d / √2`` becomes ``d · 0.70703`` (the reciprocal
rounded to f16) and consecutive constant products fold into one (the
optimised HLO of ``haar_dwt2`` in f16 shows both; bf16 is normalised to f32
op by op first and keeps the division).  No order of plain PyTorch ops
reproduces a rewrite that the compiler picks per fusion, so the jitted
reference is held at ``F16_ULPS`` units in the last place of each band's
max |ref| (measured: at most 9.0 over these cases and two more seeds).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.ops.wavelets import lifting as jax_lifting
from irw_tpu.ops.wavelets.lifting_families import FAMILY_ALIASES, LIFTING_FAMILIES
from irw_tpu.ops.wavelets.pallas_dwt import lifting_multi_level_pallas
from irw_tpu_torch.ops.wavelets import lifting
from irw_tpu_torch.ops.wavelets import lifting_families as families
from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.wavelets import lifting_dwt
from irw_tpu_torch.ops.wavelets.lifting_dwt import (
    kernel_reach,
    kernel_steps,
    lifting_kernel_variants,
    lifting_multi_level_plain,
)

BASES = ["haar", "cdf97", *LIFTING_FAMILIES, *FAMILY_ALIASES]


def close(ours, ref, tol):
    ref = np.asarray(ref)
    ours = ours.numpy() if torch.is_tensor(ours) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def tol_of(basis, haar=1e-6, other=1e-5):
    return haar if basis == "haar" else other


def equal(ours, ref):
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref).astype(np.float32))


def within_ulps(ours, ref, ulps):
    ref = np.asarray(ref).astype(np.float32)
    ours = ours.float().numpy()
    assert ours.shape == ref.shape
    unit = float(np.spacing(np.float16(np.abs(ref).max())))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ulps * unit)


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


# the C7 cases: the four bases of the probe, and a family alias
LOW_BASES = ["haar", "cdf97", "bior48", "daub4", "rev_bior_spline_39"]
LOW_DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
F16_ULPS = 16
LOW_LEVELS = 3


def _bands(approx, details):
    return [band for lvl in range(len(approx)) for band in (approx[lvl], *details[lvl])]


@functools.lru_cache(maxsize=None)
def _low_references(basis, dtype):
    """One (2, 32, 32) plane in ``dtype`` and the JAX package's results on
    it, computed once for the three level cases of a basis: the jitted
    ``lifting_decompose`` at LOW_LEVELS levels (its first l levels are the
    jnp calls of ``lifting_decompose`` at l levels, one level after the
    other), the same op by op in f16, and the Pallas kernel in interpret
    mode at LOW_LEVELS levels."""
    tdtype, jdtype = LOW_DTYPES[dtype]
    x = np.random.RandomState(3).randn(2, 32, 32).astype(np.float32)
    xj = jnp.asarray(x).astype(jdtype)
    jitted = jax_lifting.lifting_decompose(xj, LOW_LEVELS, basis)
    op_by_op = None
    if dtype == "float16":
        with jax.disable_jit():
            op_by_op = jax_lifting.lifting_decompose(xj, LOW_LEVELS, basis)
    pallas = lifting_multi_level_pallas(xj, levels=LOW_LEVELS, basis=basis, interpret=True)
    return torch.from_numpy(x).to(tdtype), jitted, op_by_op, pallas


def _first_levels(result, levels):
    approx, details = result
    return _bands(approx[:levels], details[:levels])


def _coarsest(result, levels):
    return np.stack([np.asarray(b).astype(np.float32)
                     for b in _first_levels(result, levels)[-4:]], axis=1)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("basis", LOW_BASES)
def test_bf16_lifting_matches_jax_bit_for_bit(basis, levels):
    """``lifting_decompose`` against the jitted JAX function, and
    ``lifting_multi_level_plain`` against the coarsest level of it and, at
    LOW_LEVELS, against the Pallas kernel."""
    x, jitted, _, pallas = _low_references(basis, "bfloat16")
    for ours, ref in zip(_bands(*lifting.lifting_decompose(x, levels, basis)),
                         _first_levels(jitted, levels), strict=True):
        assert ours.dtype == torch.bfloat16
        equal(ours, ref)
    plain = lifting_multi_level_plain(x, levels, basis)
    equal(plain, _coarsest(jitted, levels))
    if levels == LOW_LEVELS:
        equal(plain, pallas)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("basis", LOW_BASES)
def test_f16_lifting_matches_jax(basis, levels):
    """Bit for bit against jnp op by op at every level, the plain version
    against the coarsest level of it: this is the case that guards C7 in
    f16.  Within F16_ULPS of the jitted function and, at LOW_LEVELS, of the
    Pallas kernel (the module docstring says why)."""
    x, jitted, op_by_op, pallas = _low_references(basis, "float16")
    ours = _bands(*lifting.lifting_decompose(x, levels, basis))
    for band, ref in zip(ours, _first_levels(op_by_op, levels), strict=True):
        assert band.dtype == torch.float16
        equal(band, ref)
    for band, ref in zip(ours, _first_levels(jitted, levels), strict=True):
        within_ulps(band, ref, F16_ULPS)
    plain = lifting_multi_level_plain(x, levels, basis)
    equal(plain, _coarsest(op_by_op, levels))
    if levels == LOW_LEVELS:
        within_ulps(plain, pallas, F16_ULPS)


def test_constants_round_as_jnp():
    """Every constant of the lift, rounded to bf16 and f16 as the port rounds
    it (``scalar``), is the value jnp gives the weakly typed float."""
    consts = {0.5, lifting.SQRT2, lifting.CDF97_A1, lifting.CDF97_A2, lifting.CDF97_A3,
              lifting.CDF97_A4, lifting.CDF97_K}
    for steps, k in families.LIFTING_FAMILIES.values():
        consts |= {k, *(c for _, taps in steps for _, c in taps)}
    for dtype, jdtype in [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)]:
        like = torch.zeros((), dtype=dtype)
        for c in consts:
            ref = float((jnp.ones((), jdtype) * c).astype(jnp.float32))
            assert families.scalar(c, like).item() == ref, c


@pytest.mark.parametrize("basis", ["haar", "cdf97", "daub4", "coif12", "bior_spline_48",
                                   "rev_bior37"])
def test_lifting_inverses_match_jax(basis):
    """``lifting_idwt2`` (through ``family_unlift_1d``, ``_haar_unlift_1d`` or
    ``_cdf97_unlift_1d``) against the JAX package, and back to the input."""
    x = np.random.RandomState(5).randn(2, 3, 32, 24).astype(np.float32)
    bands = lifting.lifting_dwt2(torch.from_numpy(x), basis)
    jbands = jax_lifting.lifting_dwt2(jnp.asarray(x), basis)
    back = lifting.lifting_idwt2(*bands, basis)
    close(back, jax_lifting.lifting_idwt2(*jbands, basis), tol_of(basis))
    close(back, x, 1e-5)


def test_haar_and_cdf97_with_scales_match_jax():
    x = np.random.RandomState(6).randn(2, 20, 16).astype(np.float32)
    scales = (1.0, 0.5, 2.0, 1.0)
    for fwd, inv, jfwd, jinv in [(lifting.haar_dwt2, lifting.haar_idwt2, jax_lifting.haar_dwt2,
                                  jax_lifting.haar_idwt2),
                                 (lifting.cdf97_dwt2, lifting.cdf97_idwt2,
                                  jax_lifting.cdf97_dwt2, jax_lifting.cdf97_idwt2)]:
        tol = tol_of("haar" if fwd is lifting.haar_dwt2 else "cdf97")
        for s in (lifting.COEFFS_SCALES_2D, scales):
            bands = fwd(torch.from_numpy(x), s)
            jbands = jfwd(jnp.asarray(x), s)
            for ours, ref in zip(bands, jbands):
                close(ours, ref, tol)
            close(inv(*bands, s), jinv(*jbands, s), tol)
            close(inv(*bands, s), x, 1e-5)


def test_interleave_inverts_the_split():
    x = torch.arange(24.0).reshape(2, 3, 4)
    for dim in (0, 1, -1):
        even, odd = families.split_even_odd(x.narrow(dim, 0, x.shape[dim] // 2 * 2), dim)
        torch.testing.assert_close(families.interleave(even, odd, dim),
                                   x.narrow(dim, 0, x.shape[dim] // 2 * 2), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_wrappers_on_the_cpu(dtype):
    """``haar_multi_level``, ``cdf97_multi_level`` and ``haar_dwt2_fused`` are
    ``lifting_multi_level`` of their basis (the plain version on the CPU) and
    the JAX package's ``*_pallas`` wrappers."""
    from irw_tpu.ops.wavelets.pallas_dwt import (
        cdf97_multi_level_pallas,
        haar_dwt2_pallas,
        haar_multi_level_pallas,
    )

    x = torch.from_numpy(np.random.RandomState(7).randn(3, 32, 16).astype(np.float32)).to(dtype)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    for ours, ref, plain in [
            (lifting_dwt.haar_multi_level(x, 2), haar_multi_level_pallas(xj, 2, interpret=True),
             lifting_multi_level_plain(x, 2, "haar")),
            (lifting_dwt.cdf97_multi_level(x, 2), cdf97_multi_level_pallas(xj, 2, interpret=True),
             lifting_multi_level_plain(x, 2, "cdf97")),
            (lifting_dwt.haar_dwt2_fused(x), haar_dwt2_pallas(xj, interpret=True),
             lifting_multi_level_plain(x, 1, "haar"))]:
        assert torch.equal(ours, plain) and ours.dtype == dtype
        if dtype == torch.bfloat16:
            equal(ours, ref)
        else:
            close(ours, ref, 1e-4)


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


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("basis", lifting.BASES)
def test_kernel_reach_is_exact(basis, levels):
    """An interior 4 x 4 tile of coarsest outputs depends on the input rows
    and columns [2ˡ·o0 − left, 2ˡ·o1 − 1 + right] and on nothing outside:
    changing one sample just outside that span leaves the tile's four bands
    bitwise equal; changing the sample at either end of it, along H or W,
    changes them.  So the halo the tile path loads (from the same walk) is
    enough, and no wider than it must be."""
    size = 256
    x = torch.from_numpy(np.random.RandomState(levels).randn(1, size, size).astype(np.float32))
    left, right = kernel_reach(basis, levels)
    scale = 2 ** levels
    o0 = (size // scale) // 2 - 2
    o1 = o0 + 4
    first, end = scale * o0 - left, scale * o1 - 1 + right
    assert 0 < first and end < size - 1          # the span lies inside the plane
    tile = (slice(None), slice(None), slice(o0, o1), slice(o0, o1))
    ref = lifting_multi_level_plain(x, levels, basis)[tile]
    mid = scale * o0 + 1

    def moved(row, col):
        y = x.clone()
        y[0, row, col] += 100.0
        return lifting_multi_level_plain(y, levels, basis)[tile]

    for row, col in [(first - 1, mid), (end + 1, mid), (mid, first - 1), (mid, end + 1)]:
        assert torch.equal(moved(row, col), ref), (row, col)
    for row, col in [(first, mid), (end, mid), (mid, first), (mid, end)]:
        assert not torch.equal(moved(row, col), ref), (row, col)


def test_kernel_reach_walks_the_steps():
    # cdf97's 9/7 filters: s[i] reads x[2i − 4 .. 2i + 4]; two levels add the
    # first level's reach twice over (2 · 4 + 4, 2 · 3 + 3)
    assert kernel_reach("cdf97", 1) == (4, 3) and kernel_reach("cdf97", 2) == (12, 9)
    assert kernel_reach("haar", 3) == (0, 0)
    # rev_bior39's s reads one pair either side, its d nine samples: the
    # inner level adds the short reach
    assert kernel_reach("rev_bior39", 1) == (9, 9) and kernel_reach("rev_bior39", 2) == (19, 19)


@pytest.mark.parametrize("basis,levels,hw,path", [
    ("haar", 1, (224, 224), "register"),            # the WCNN route's served planes
    ("haar", 1, (6, 2), "register"),                # W % 4 == 2: 8-byte loads
    ("haar", 3, (224, 224), "register"),
    ("haar", 4, (224, 224), "tile"),                # past the register path's levels
    ("cdf97", 1, (448, 448), "tile"),               # cub_dwt_cdf97.yaml
    ("daub4", 3, (224, 224), "tile"),              # a narrow halo: the region 1.43 x the tile
    ("cdf97", 3, (448, 448), "two_pass"),          # 2.25 x: the halo costs more than it saves
    ("bior39", 2, (224, 224), "tile"),              # the widest halo at level 2
    ("coif12", 1, (8192, 8192), "tile"),            # any plane: tiles walk it
    ("cdf97", 5, (256, 256), "two_pass"),           # the halo outgrows a tile
    ("bior48", 2, (32, 32), "tile"),                # one tile spans the plane: no halo
    ("cdf97", 5, (8192, 64), "tile"),               # no two-pass strip fits: the tile runs
    ("bior39", 4, (224, 224), "two_pass"),
    ("haar", 8, (256, 256), "two_pass"),
])
def test_lifting_kernel_variants_name_the_path(basis, levels, hw, path):
    assert lifting_kernel_variants(*hw, levels, basis) == {"path": path}


def test_lifting_kernel_variants_refuse_what_no_path_takes():
    with pytest.raises(ValueError, match="shared memory"):
        lifting_kernel_variants(8192, 4096, 5, "cdf97")
    with pytest.raises(ValueError, match="unknown lifting basis"):
        lifting_kernel_variants(224, 224, 1, "db2")
    with pytest.raises(ValueError, match="divide"):
        lifting_kernel_variants(12, 8, 3, "haar")


# every shape the card tests, chip_smoke.py's dwt phase and the configs give K4
CARD_SHAPES = [(20, 12), (72, 200), (224, 224), (448, 448)]
SMOKE_CASES = [("haar", 1, (224, 224)), ("haar", 2, (224, 224)), ("haar", 3, (224, 224)),
               ("cdf97", 1, (448, 448)), ("cdf97", 2, (448, 448)), ("bior48", 2, (224, 224)),
               ("daub4", 2, (224, 224)), ("haar", 2, (72, 200)), ("coif12", 2, (72, 200)),
               ("rev_bior_spline_39", 1, (20, 12)), ("cdf97", 2, (40, 24)),
               ("bior48", 2, (64, 32)), ("coif12", 1, (6, 2)), ("rev_bior_spline_39", 2, (36, 100)),
               ("haar", 3, (72, 200)), ("haar", 3, (24, 16))]


def test_every_used_shape_takes_a_one_launch_path():
    cases = [(b, lvl, hw) for b in lifting.BASES for lvl in (1, 2) for hw in CARD_SHAPES]
    cases += [("haar", 3, hw) for hw in CARD_SHAPES if hw[0] % 8 == 0 and hw[1] % 8 == 0]
    for basis, levels, hw in cases + SMOKE_CASES:
        assert lifting_kernel_variants(*hw, levels, basis)["path"] in ("register", "tile"), \
            (basis, levels, hw)
    # at least two blocks an SM at cdf97's served 448² (228 KiB an SM, 1 KiB
    # of it reserved per block)
    _, _, nbytes, _, _ = lifting_dwt._tile_plan(448, 448, 1, "cdf97")
    assert 2 * (nbytes + 1024) <= 228 * 1024


def test_lifting_kernel_variants_follow_the_kernel_source():
    """The envelope in Python is the one ``irw_lifting_dwt_variant`` applies."""
    src = (cuda_lib.CSRC / "lifting_dwt.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRegMaxLevels") == lifting_dwt.REG_MAX_LEVELS
    assert const("kTileMaxLevels") == lifting_dwt.TILE_MAX_LEVELS
    assert const("kTileMaxPairs") == lifting_dwt.TILE_MAX_PAIRS
    assert const("kTileMaxShared") == lifting_dwt.TILE_MAX_SHARED_BYTES
    assert const("kMaxShift") == lifting_dwt.TILE_MAX_SHIFT
    assert const("kTileMaxHalo") == lifting_dwt.TILE_MAX_HALO
    assert const("kTileAnyHaloLevels") == lifting_dwt.TILE_ANY_HALO_LEVELS
    assert const("kTileMaxGrowth") == lifting_dwt.TILE_MAX_GROWTH
    assert (const("kStrip"), const("kRowsW"), const("kMaxShared")) == (
        lifting_dwt.STRIP, lifting_dwt.ROWS_W, lifting_dwt.MAX_SHARED_BYTES)
    rule = re.findall(r"return (\d);", src[src.index("int variant("):])[:3]
    assert [lifting_dwt.PATHS[int(c)] for c in rule] == ["register", "tile", "two_pass"]

