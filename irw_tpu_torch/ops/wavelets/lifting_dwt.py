"""Fused multi-level 2D lifting DWT, coarsest level only (kernel K4).

Port of ``irw_tpu/ops/wavelets/pallas_dwt.py:134-220``
(``lifting_multi_level_pallas``, body ``_dwt_kernel``): per level, lift
along H, then along W on both halves, then the v6 scales (0.5, 1, 1, √2);
recurse on the scaled LL; return the last level's [LL, LH, HL, HH].

``lifting_multi_level`` is the custom op ``irw_tpu_torch::lifting_multi_level``
(``ops.library``): it launches the CUDA kernel K4 (``csrc/lifting_dwt.cu``)
for a CUDA f32, bf16 or f16 tensor and runs ``lifting_multi_level_plain``
(built from ``ops.wavelets.lifting``) for a CPU tensor; it never falls back
from one to the other.  In bf16 and f16 the kernel rounds every operation to
the dtype, with the constants rounded to it first, as the plain version
does: the two agree bit for bit in every dtype.  ``haar_multi_level``,
``cdf97_multi_level`` and ``haar_dwt2_fused`` are the JAX package's thin
wrappers (``pallas_dwt.py:223-237``), one K4 launch each.  The kernel takes
every basis as a table of lifting steps, so one kernel serves haar, cdf97
and the 13 families.  ``lifting_kernel_variants``
names the path a shape takes on the card: ``register`` (haar, levels 1-3),
``tile`` (every other basis, all levels in one launch, the halo from
``kernel_reach``) or ``two_pass`` (what a tile cannot hold).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from irw_tpu_torch import cuda_lib
from irw_tpu_torch.ops.library import kernel_op
from irw_tpu_torch.ops.wavelets.lifting import (
    BASES,
    CDF97_A1,
    CDF97_A2,
    CDF97_A3,
    CDF97_A4,
    CDF97_K,
    SQRT2,
    _lifting_dwt2,
)
from irw_tpu_torch.ops.wavelets.lifting_families import resolve_family, scalar

MAX_STEPS = 8          # csrc/lifting_dwt.cu kMaxSteps, kMaxTaps, kStrip,
MAX_TAPS = 9           # kRowsW and the shared memory a block may take
STRIP = 32
ROWS_W = 8
MAX_SHARED_BYTES = 232448
REG_MAX_LEVELS = 3     # kRegMaxLevels; kTileMaxLevels, kTileMaxPairs, kTileMaxShared,
TILE_MAX_LEVELS = 8    # kMaxShift and kTileMaxHalo: the tile path's envelope
TILE_MAX_PAIRS = 64
TILE_MAX_SHARED_BYTES = 115712
TILE_MAX_SHIFT = 4
TILE_MAX_HALO = 5
TILE_ANY_HALO_LEVELS = 2   # kTileAnyHaloLevels, kTileMaxGrowth: where the tile path pays
TILE_MAX_GROWTH = 2
PATHS = {2: "register", 1: "tile", 0: "two_pass"}   # irw_lifting_dwt_variant's codes


def _check(x: torch.Tensor, levels: int, basis: str) -> None:
    if x.dim() != 3 or not x.is_floating_point():
        raise ValueError(f"lifting_multi_level takes a floating (N, H, W) tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if basis not in BASES:
        raise ValueError(f"unknown lifting basis {basis!r}; one of {list(BASES)}")
    if levels < 1 or x.shape[1] % 2 ** levels or x.shape[2] % 2 ** levels:
        raise ValueError(f"lifting_multi_level: H and W {tuple(x.shape[1:])} must divide "
                         f"by 2**levels (levels={levels})")


def lifting_multi_level_plain(x: torch.Tensor, levels: int = 1,
                              basis: str = "haar") -> torch.Tensor:
    """(N, H, W) → (N, 4, H/2ˡ, W/2ˡ) [LL, LH, HL, HH], in x's dtype."""
    _check(x, levels, basis)
    for _ in range(levels):
        ll, lh, hl, hh = _lifting_dwt2(x, basis)
        x = ll
    return torch.stack([ll, lh, hl, hh], dim=1)


def kernel_steps(basis: str):
    """The basis as K4's table: ([(target, pair, shifts, coeffs), ...], k).

    ``target`` is 0 (even) or 1 (odd).  A taps step adds Σ c·src[i + n] in
    tap order; a pair step (cdf97) adds c·(src[i + a] + src[i + b]), the sum
    first, as ``_cdf97_lift_1d`` does.  Haar is the taps program
    odd += −1·even; even += 0.5·odd, which rounds exactly as d = odd − even,
    s = even + 0.5·d."""
    if basis == "haar":
        return [(1, 0, (0,), (-1.0,)), (0, 0, (0,), (0.5,))], SQRT2
    if basis == "cdf97":
        return [(1, 1, (0, 1), (CDF97_A1,)), (0, 1, (-1, 0), (CDF97_A2,)),
                (1, 1, (0, 1), (CDF97_A3,)), (0, 1, (-1, 0), (CDF97_A4,))], CDF97_K
    _, (steps, k) = resolve_family(basis)
    return [(int(target == "odd"), 0, tuple(n for n, _ in taps), tuple(c for _, c in taps))
            for target, taps in steps], k


@functools.lru_cache(maxsize=None)
def _level_reach(basis: str, ll_only: bool) -> tuple[int, int]:
    """Samples of one level's input that the lift reads before a pair
    (2i, 2i + 1) and after it, for both of its outputs (s, d) or for s alone.

    Walks the steps backwards with the interval of even[i + n] and odd[i + n]
    each output needs: a step that updates one parity from the other at
    shifts n needs the other over the target's interval widened by
    [min n, max n]."""
    steps, _ = kernel_steps(basis)
    need = [(0, 0), None if ll_only else (0, 0)]      # even, odd: [lo, hi] of n
    for target, _, shifts, _ in reversed(steps):
        if need[target] is None:
            continue
        lo, hi = need[target][0] + min(shifts), need[target][1] + max(shifts)
        have = need[1 - target]
        need[1 - target] = (lo, hi) if have is None else (min(have[0], lo), max(have[1], hi))
    samples = [2 * n + parity for parity, span in enumerate(need) if span for n in span]
    return max(0, -min(samples)), max(0, max(samples) - 1)


def kernel_reach(basis: str, levels: int) -> tuple[int, int]:
    """(left, right): input samples before and after the 2ˡ × 2ˡ patch of a
    coarsest output that its four bands depend on, along H and along W.

    The last level reads its reach with all four bands, in samples of its
    input, each 2ˡ⁻¹ input samples; every level below it feeds LL alone and
    reads the (often shorter) reach of s, each of its samples 2ʲ⁻¹ input
    samples at level j.  0 for haar.  The tile path's halo comes from the
    same walk (``_reach_args``)."""
    (al, ar), (il, ir) = _level_reach(basis, False), _level_reach(basis, True)
    inner = 2 ** (levels - 1) - 1
    return 2 ** (levels - 1) * al + inner * il, 2 ** (levels - 1) * ar + inner * ir


@functools.lru_cache(maxsize=None)
def _reach_args(basis: str):
    """The kernel's reach argument: (left, right) with all four bands, then
    with LL alone, in samples of one level's input."""
    return (ctypes.c_int * 4)(*_level_reach(basis, False), *_level_reach(basis, True))


def _axis_pairs(levels: int, t: int, inner: int, last: int) -> list[int]:
    pairs = [t + last]
    for _ in range(levels - 1):
        pairs.insert(0, 2 * pairs[0] + inner)
    return pairs


def _tile_takes(basis: str) -> bool:
    """csrc/lifting_dwt.cu ``tile_takes``: each step's shifts are a range
    within ±``TILE_MAX_SHIFT``, each once and, for three taps or more, in
    order (the order the tile path sums them in; two taps sum alike either
    way)."""
    steps, _ = kernel_steps(basis)
    for _, _, shifts, _ in steps:
        lo, hi = min(shifts), max(shifts)
        if max(-lo, hi) > TILE_MAX_SHIFT or sorted(shifts) != list(range(lo, hi + 1)):
            return False
        if len(shifts) > 2 and list(shifts) != sorted(shifts):
            return False
    return True


def _tile_plan(h: int, w: int, levels: int, basis: str):
    """(rows, columns) of coarsest pairs a tile owns, its shared-memory
    bytes and the pairs its level-1 region holds (rows, columns), or None
    where no tile of 2 pairs a side fits: csrc/lifting_dwt.cu ``tile_plan``,
    line for line."""
    if levels > TILE_MAX_LEVELS:
        return None
    halo = []                                 # pairs before + after: inner, last level
    for left, right in (_level_reach(basis, True), _level_reach(basis, False)):
        before, after = (left + 1) // 2, (right + 1) // 2
        if max(before, after) > TILE_MAX_HALO:
            return None
        halo.append(before + after)
    hc, wc = max(h >> levels, 1), max(w >> levels, 1)
    t = TILE_MAX_PAIRS
    while t >= 2:
        tr = -(-hc // -(-hc // t))            # the side evened out over the tiles
        tc = -(-wc // -(-wc // t))
        # no halo along an axis one tile spans
        pr, pc = (_axis_pairs(levels, side, *(halo if side < n else (0, 0)))
                  for side, n in ((tr, hc), (tc, wc)))
        a = 0 if levels == 1 else 2 * pr[1] * (2 * pc[1] + 1)
        b = (2 * tr if levels == 1 else 2 * pr[1]) * (2 * pc[0] + 1)
        if 4 * (a + b) <= TILE_MAX_SHARED_BYTES:
            return tr, tc, 4 * (a + b), pr[0], pc[0]
        t //= 2
    return None


def _tile_pays(levels: int, plan) -> bool:
    """csrc/lifting_dwt.cu ``tile_pays``: up to ``TILE_ANY_HALO_LEVELS``
    levels, or while the level-1 region is at most ``TILE_MAX_GROWTH`` times
    the tile's own input (deeper, a wide halo made the tile path slower
    than the two-pass kernels)."""
    tr, tc, _, pr0, pc0 = plan
    return levels <= TILE_ANY_HALO_LEVELS or 4 * pr0 * pc0 <= TILE_MAX_GROWTH * (
        (tr << levels) * (tc << levels))


@functools.lru_cache(maxsize=1024)
def _kernel_path(h: int, w: int, levels: int, basis: str) -> str:
    """The path of ``lifting_kernel_variants``, once held against the one the
    built kernel takes (``irw_lifting_dwt_variant``)."""
    path = lifting_kernel_variants(h, w, levels, basis)["path"]
    nsteps, meta, _, _ = _step_arrays(basis)
    lib = cuda_lib.load("lifting_dwt", _SIGNATURES)
    taken = PATHS.get(lib.irw_lifting_dwt_variant(h, w, levels, nsteps, meta, _reach_args(basis)))
    if taken != path:
        raise RuntimeError(f"lifting_multi_level: the kernel takes path {taken} for {basis} "
                           f"l={levels} at {h} x {w}, lifting_kernel_variants names {path}")
    return path


def lifting_kernel_variants(h: int, w: int, levels: int, basis: str) -> dict:
    """Which path K4 runs on the card for (N, ``h``, ``w``) planes:
    ``{"path": "register" | "tile" | "two_pass"}``; raises where none takes
    the shape.

    ``register`` for a table whose every tap has shift 0 (haar) at levels
    1-3; ``tile`` where a tile of at least 2 coarsest pairs a side, with its
    halo, fits ``TILE_MAX_SHARED_BYTES`` (levels ≤ ``TILE_MAX_LEVELS``,
    halos ≤ ``TILE_MAX_HALO`` pairs, a table ``_tile_takes``) and the tile
    path pays (``_tile_pays``) or no two-pass strip fits;
    else ``two_pass`` where a 32-column strip of the whole height and 8 rows
    of the whole width fit a block's shared memory.  Plain Python; the C
    side's ``irw_lifting_dwt_variant``, which picks the kernel, applies the
    same rule."""
    if basis not in BASES:
        raise ValueError(f"unknown lifting basis {basis!r}; one of {list(BASES)}")
    if levels < 1 or h % 2 ** levels or w % 2 ** levels:
        raise ValueError(f"lifting_multi_level: H and W {(h, w)} must divide by 2**levels "
                         f"(levels={levels})")
    steps, _ = kernel_steps(basis)
    if levels <= REG_MAX_LEVELS and all(n == 0 for _, _, shifts, _ in steps for n in shifts):
        return {"path": "register"}
    two_pass = max(h * STRIP, ROWS_W * w) * 4 <= MAX_SHARED_BYTES
    plan = _tile_plan(h, w, levels, basis) if _tile_takes(basis) else None
    if plan is not None and (_tile_pays(levels, plan) or not two_pass):
        return {"path": "tile"}
    if two_pass:
        return {"path": "two_pass"}
    raise ValueError(f"lifting_multi_level: a {h} x {w} plane at {levels} levels of {basis} "
                     f"fits no K4 path: the tile's halo and a two-pass strip both exceed "
                     f"the shared memory of a block ({MAX_SHARED_BYTES} bytes)")


@functools.lru_cache(maxsize=None)
def _step_arrays(basis: str, dtype: torch.dtype = torch.float32):
    """The step table as the kernel's arguments, every coefficient and k
    rounded to ``dtype``."""
    steps, k = kernel_steps(basis)
    like = torch.empty((), dtype=dtype)
    meta, coeffs = [], []
    for target, pair, shifts, cs in steps:
        meta += [target, pair, len(shifts), *shifts, *[0] * (MAX_TAPS - len(shifts))]
        coeffs += [*(scalar(c, like).item() for c in cs), *[0.0] * (MAX_TAPS - len(cs))]
    return (len(steps), (ctypes.c_int * len(meta))(*meta),
            (ctypes.c_float * len(coeffs))(*coeffs), scalar(k, like).item())


# the kernel's entry point for each dtype it takes
ENTRY = {torch.float32: "irw_lifting_dwt_f32", torch.bfloat16: "irw_lifting_dwt_bf16",
         torch.float16: "irw_lifting_dwt_f16"}
_LAUNCH_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                 ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                 ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
                ctypes.c_int)
_SIGNATURES = {
    **{entry: _LAUNCH_ARGS for entry in ENTRY.values()},
    "irw_lifting_dwt_variant": ([ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)],
                                ctypes.c_int),
}


def _lifting_cpu(x: torch.Tensor, levels: int, basis: str) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return lifting_multi_level_plain(x, levels, basis)


def _lifting_cuda(x: torch.Tensor, levels: int, basis: str) -> torch.Tensor:
    """The op's CUDA implementation: kernel K4 in x's dtype."""
    if x.dtype not in ENTRY:
        raise NotImplementedError(f"lifting_multi_level: kernel K4 takes float32, bfloat16 or "
                                  f"float16, not {x.dtype}")
    n, h, w = x.shape
    path = _kernel_path(h, w, levels, basis)
    x = x.contiguous()
    if x.data_ptr() % 16:           # the kernel's 16-byte loads
        x = x.clone()
    out = torch.empty((n, 4, h >> levels, w >> levels), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lift_ws = ll_ws = None
    if path == "two_pass":
        lift_ws = torch.empty((n, h, w), dtype=x.dtype, device=x.device)
        if levels > 1:
            ll_ws = torch.empty((n, h // 2, w // 2), dtype=x.dtype, device=x.device)
    nsteps, meta, coeffs, k = _step_arrays(basis, x.dtype)
    reach = _reach_args(basis)
    lib = cuda_lib.load("lifting_dwt", _SIGNATURES)
    with cuda_lib.on_device(x):
        status = getattr(lib, ENTRY[x.dtype])(x.data_ptr(), out.data_ptr(),
                                              None if lift_ws is None else lift_ws.data_ptr(),
                                              None if ll_ws is None else ll_ws.data_ptr(),
                                              n, h, w, levels, nsteps, meta, coeffs, k, reach,
                                              cuda_lib.stream_of(x))
    cuda_lib.check(status, "lifting_multi_level", lib)
    lifting_multi_level.launches += 1
    lifting_multi_level.last_path = path
    return out


def _lifting_fake(x: torch.Tensor, levels: int, basis: str) -> torch.Tensor:
    n, h, w = x.shape
    return x.new_empty((n, 4, h // 2 ** levels, w // 2 ** levels))


_OP = kernel_op("lifting_multi_level", "(Tensor x, int levels, str basis) -> Tensor",
                _lifting_cpu, _lifting_cuda, _lifting_fake)


def lifting_multi_level(x: torch.Tensor, levels: int = 1, basis: str = "haar") -> torch.Tensor:
    """Multi-level lifting DWT, coarsest level: (N, H, W) → (N, 4, H/2ˡ, W/2ˡ).

    The op ``irw_tpu_torch::lifting_multi_level``.  CPU tensor: the plain
    version, in x's dtype (directly when x needs a gradient: the kernel has
    no backward).  CUDA f32, bf16 or f16 tensor: kernel K4 in that dtype,
    counted in ``lifting_multi_level.launches`` (one per call, whatever the
    number of levels), on the path ``lifting_kernel_variants`` names (held
    once a shape against the one the C side takes; kept in
    ``lifting_multi_level.last_path``).  Other dtypes on the card raise."""
    _check(x, levels, basis)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lifting_multi_level: no kernel for device {x.device}; the kernel "
                         "takes float32, bfloat16 or float16 (N, H, W) planes on a CUDA device")
    if x.device.type == "cuda" and x.dtype not in ENTRY:
        raise NotImplementedError(f"lifting_multi_level: kernel K4 takes float32, bfloat16 or "
                                  f"float16, not {x.dtype}")
    if x.device.type == "cpu" and x.requires_grad and torch.is_grad_enabled():
        return lifting_multi_level_plain(x, levels, basis)
    return _OP(x, int(levels), basis)


lifting_multi_level.launches = 0
lifting_multi_level.last_path = None


def haar_multi_level(x: torch.Tensor, levels: int = 1) -> torch.Tensor:
    """``lifting_multi_level`` for haar (``haar_multi_level_pallas``)."""
    return lifting_multi_level(x, levels, "haar")


def cdf97_multi_level(x: torch.Tensor, levels: int = 1) -> torch.Tensor:
    """``lifting_multi_level`` for cdf97 (``cdf97_multi_level_pallas``)."""
    return lifting_multi_level(x, levels, "cdf97")


def haar_dwt2_fused(x: torch.Tensor) -> torch.Tensor:
    """One Haar level in one K4 launch: (N, H, W) → (N, 4, H/2, W/2)
    (``haar_dwt2_pallas``; named so as not to shadow ``lifting.haar_dwt2``)."""
    return lifting_multi_level(x, 1, "haar")
