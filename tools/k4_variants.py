#!/usr/bin/env python3
"""Time variants of kernel K4's tile and register paths on one CUDA card.

    python3 tools/k4_variants.py [--only BASIS,...] PATCH=cp_async PATCH=tma RUN=16

Each argument names one variant of ``irw_tpu_torch/csrc/lifting_dwt.cu`` by
what it changes: a constant (``RUN``: ``kTileRun``, the pairs a thread's run
yields; ``THREADS``: ``kTileThreads``; ``SHARED``: ``kTileMaxShared`` and
``PAIRS``: ``kTileMaxPairs``, which set the tile side) or ``PATCH``, one of
the named source edits in ``PATCHES`` (a ``probe_`` edit breaks the result
on purpose, to see what a part of the kernel costs: it is timed, not
checked); several join with commas.  The committed source is always timed
too, as ``committed``.  An edit that no longer applies to the source stops
the tool before anything is built.

Every variant is built from a copy of the sources (one nvcc each, in
parallel, into ``build/lifting_dwt_variants/``), checked bit for bit against
``lifting_multi_level_plain`` and timed with CUDA events, calling the C
entry directly, at ``CASES`` (those of the bases ``--only`` names, if
given: a variant that faults takes the process down with it, so such a
case runs on its own).  Variants run in turns, three rounds of 20
calls after 3 warm-ups each; the median of the rounds is printed.  One JSON
line per variant with the tile kernels' registers from ptxas, then the
card's name and power limit.  Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import cu_variants  # noqa: E402

CONSTANTS = {"RUN": "kTileRun", "THREADS": "kTileThreads", "SHARED": "kTileMaxShared",
             "PAIRS": "kTileMaxPairs"}

# The level-1 region a tile depends on, staged in shared memory before the
# H phase reads it, the committed kernel reading the plane straight into
# each thread's run instead (on the H100 the cp.async copy ran 1.4-2.3 x
# its time at cdf97, daub4 and bior48, the TMA one 1.4 x at cdf97 and daub4
# and faults in the wide-halo kernel, bior48).  The region, 2 pr[0] rows of
# the plane from the tile's first pair row br, and its columns from 2 bc
# (rounded down to 16 bytes for cp.async), takes the start of shared
# memory, where A, the level-2 input, reuses it; the tile side shrinks until
# region, A and B fit kTileMaxShared.  Zero outside the plane (cp.async's
# source size 0, TMA's out-of-bounds fill), and rows outside the region read
# 0 as the buffers of later levels do.  Both assume W % 4 == 0 (every case
# below).
_PLAN_FIT = """\
        const long long a = levels == 1 ? 0LL : 2LL * pl->pr[1] * (2 * pl->pc[1] + 1);
        const long long b = (levels == 1 ? 2LL * pl->tr : 2LL * pl->pr[1]) * (2 * pl->pc[0] + 1);
        if ((a + b) * 4 <= kTileMaxShared) {
            pl->tiles_c = (wc1 + pl->tc - 1) / pl->tc;
            pl->a_floats = static_cast<int>(a);
            return static_cast<int>((a + b) * 4);
        }"""
_PLAN_STRUCT = "    int a_floats;               // floats before B: level 2's input (A), if any\n};"
_H_LOAD = """\
                        const ptrdiff_t col =
                            static_cast<ptrdiff_t>(2 * (br + r0)) * w + 2 * bc + c;
#pragma unroll
                        for (int i = 0; i < NP; ++i) {
                            const bool in = cin && (rows_in >> i & 1u);
                            ev[i] = in ? __ldg(plane + col + static_cast<ptrdiff_t>(2 * i) * w)
                                       : 0.f;
                            od[i] = in ? __ldg(plane + col +
                                               static_cast<ptrdiff_t>(2 * i + 1) * w)
                                       : 0.f;
                        }"""
_LEVEL_START = """\
        const int sa_next = last ? 0 : 2 * pl.pc[j + 1] + 1;
"""


def _region_patches(tma: bool) -> list[tuple[str, str]]:
    offset = "0" if tma else "(2 * bc - ((2 * bc) & ~3))"
    extra = " + 128" if tma else ""            # TMA: the mbarrier's 128 bytes first
    rs = "(2 * pl->pc[0] + 3) / 4 * 4" if tma else "(2 * pl->pc[0] + 2 + 3) / 4 * 4"
    rows = ("pl->nrb = (pl->rrows + 255) / 256;\n"
            "        pl->bh = ((pl->rrows + pl->nrb - 1) / pl->nrb + 7) / 8 * 8;\n"
            "        const long long region = 1LL * pl->nrb * pl->bh * pl->rs;\n"
            if tma else "const long long region = 1LL * pl->rrows * pl->rs;\n")
    edits = [
        (_PLAN_STRUCT, "    int a_floats;\n    int rs, rrows, bh, nrb;     // the staged region\n"
                       + ("    CUtensorMap map;\n" if tma else "") + "};"),
        (_PLAN_FIT, f"""\
        long long a = levels == 1 ? 0LL : 2LL * pl->pr[1] * (2 * pl->pc[1] + 1);
        const long long b = (levels == 1 ? 2LL * pl->tr : 2LL * pl->pr[1]) * (2 * pl->pc[0] + 1);
        pl->rs = {rs};
        pl->rrows = 2 * pl->pr[0];
        {rows}        a = ((a > region ? a : region) + 31) / 32 * 32;
        if ((a + b) * 4{extra} <= kTileMaxShared{" && pl->rs <= 256" if tma else ""}) {{
            pl->tiles_c = (wc1 + pl->tc - 1) / pl->tc;
            pl->a_floats = static_cast<int>(a);
            return static_cast<int>((a + b) * 4{extra});
        }}"""),
        (_H_LOAD, f"""\
                        const float* rcol = A + 2 * r0 * pl.rs + {offset} + c;
#pragma unroll
                        for (int i = 0; i < NP; ++i) {{
                            const bool in = cin && (rows_in >> i & 1u) &&
                                            static_cast<unsigned>(r0 + i) <
                                                static_cast<unsigned>(P);
                            ev[i] = in ? rcol[(2 * i) * pl.rs] : 0.f;
                            od[i] = in ? rcol[(2 * i + 1) * pl.rs] : 0.f;
                        }}"""),
    ]
    if not tma:
        stage = """\
        if (j == 0) {
            const int c0 = (2 * bc) & ~3, q4 = pl.rs / 4;
            for (int e = threadIdx.x; e < pl.rrows * q4; e += kTileThreads) {
                const int r = e / q4, gr = 2 * br + r, gc = c0 + 4 * (e - r * q4);
                const bool in = static_cast<unsigned>(gr) < static_cast<unsigned>(h) &&
                                static_cast<unsigned>(gc) < static_cast<unsigned>(w);
                const float* src = in ? plane + static_cast<ptrdiff_t>(gr) * w + gc : plane;
                const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(A + 4 * e));
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"
                             :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
            }
            asm volatile("cp.async.commit_group;\\ncp.async.wait_group 0;\\n" ::: "memory");
            __syncthreads();
        }
"""
        return edits + [(_LEVEL_START, _LEVEL_START + stage)]
    stage = """\
        if (j == 0) {
            const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(tile_sm));
            if (threadIdx.x == 0) {
                asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" :: "r"(bar) : "memory");
                asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                             :: "r"(bar), "r"(pl.nrb * pl.bh * pl.rs * 4) : "memory");
                for (int q = 0; q < pl.nrb; ++q)
                    asm volatile(
                        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
                        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\\n"
                        :: "r"(static_cast<unsigned>(
                               __cvta_generic_to_shared(A + q * pl.bh * pl.rs))),
                           "l"(reinterpret_cast<unsigned long long>(&pl.map)), "r"(2 * bc),
                           "r"(2 * br + q * pl.bh), "r"(p), "r"(bar)
                        : "memory");
            }
            asm volatile(
                "{\\n.reg .pred done;\\nWAIT_REGION:\\n"
                "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\\n"
                "@!done bra WAIT_REGION;\\n}\\n" :: "r"(bar) : "memory");
        }
"""
    encode = """\
// the plane stack (w, h, n) as a TMA tensor map of region boxes (rs x bh);
// cuTensorMapEncodeTiled of libcuda through the runtime's entry point
bool encode_region(CUtensorMap* map, const float* x, int n, int h, int w, int rs, int bh) {
    using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
    static Encode fn = [] {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                       &found) == cudaSuccess &&
                       found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<Encode>(ptr) : nullptr;
    }();
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[2] = {4ULL * w, 4ULL * w * h};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(rs), static_cast<cuuint32_t>(bh), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims,
                    strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
int launch_tile(Kernel kernel,"""
    launch = ("    kernel<<<static_cast<unsigned>(tiles), kTileThreads, bytes, strm>>>"
              "(x, out, h, w, fam, pl);")
    return edits + [
        ("#include <cuda_runtime.h>\n", "#include <cuda.h>\n#include <cuda_runtime.h>\n"),
        # the mbarrier in the first 128 bytes, the region (128-byte aligned) after
        ("    extern __shared__ __align__(16) float tile_sm[];\n"
         "    float* const A = tile_sm;                   // levels 2 and up: the level's input\n"
         "    float* const B = tile_sm + pl.a_floats;",
         "    extern __shared__ __align__(128) float tile_sm[];\n"
         "    float* const A = tile_sm + 32;\n"
         "    float* const B = tile_sm + 32 + pl.a_floats;"),
        (_LEVEL_START, _LEVEL_START + stage),
        ("template <typename Kernel>\nint launch_tile(Kernel kernel,", encode),
        (launch, "    TilePlan q = pl;\n"
                 "    if (!encode_region(&q.map, x, n, h, w, q.rs, q.bh))\n"
                 "        return static_cast<int>(cudaErrorInvalidValue);\n"
                 + launch.replace("fam, pl)", "fam, q)")),
    ]


# named edits of the source a variant may also take (PATCH=name): each a
# list of (text, replacement)
PATCHES = {
    # the level-1 region staged in shared memory by 16-byte cp.async, or by TMA
    "cp_async": _region_patches(tma=False),
    "tma": _region_patches(tma=True),
    # the blocks an SM each tile kernel asks of the compiler (launch bounds),
    # and the pairs a run yields in the wide-halo kernel
    "minb_2_3": [("lift_tile_kernel<2, kTileRun, 4>", "lift_tile_kernel<2, kTileRun, 3>")],
    "minb_5_3": [("lift_tile_kernel<kTileMaxHalo, 2 * kTileRun, 2>",
                  "lift_tile_kernel<kTileMaxHalo, 2 * kTileRun, 3>")],
    "run_5_8": [("lift_tile_kernel<kTileMaxHalo, 2 * kTileRun, 2>",
                 "lift_tile_kernel<kTileMaxHalo, kTileRun, 2>")],
    # the W phase's items with a row's runs on neighbouring lanes at every
    # level, or at none (the kernel: at one level only)
    "w_rows_all": [("const bool by_row = wphase && L == 1;", "const bool by_row = wphase;")],
    "w_rows_none": [("const bool by_row = wphase && L == 1;", "const bool by_row = false;")],
    # probes (wrong results, timed but not checked): the tile path without
    # its lifting steps, without its divisions, without its stores to B or
    # to the output
    "probe_nolift": [("lift_run(fam, ev, od, valid);\n", "\n")],
    "probe_nodiv_h": [("col[(2 * row + 1) * sb] = cin ? __fdiv_rn(od[i], fam.k) : 0.f;",
                       "col[(2 * row + 1) * sb] = cin ? __fmul_rn(od[i], fam.k) : 0.f;")],
    "probe_nodiv_w": [("hi[i] = __fmul_rn(__fdiv_rn(od[HALO + i], fam.k),",
                       "hi[i] = __fmul_rn(__fmul_rn(od[HALO + i], fam.k),")],
    "probe_nob": [("if (row < nr) {", "if (row < 0) {")],
    "probe_nostore": [("if (vec_out && nq == R) {", "if (nq < 0) {")],
    "probe_nostore2": [("if (i < nq) {", "if (i < 0) {")],
}
CASES = [("cdf97", 1, (192, 448, 448)), ("cdf97", 2, (192, 448, 448)),
         ("bior48", 2, (192, 224, 224)), ("daub4", 2, (192, 224, 224)),
         ("haar", 1, (192, 224, 224))]


def main(argv=None) -> int:
    import torch

    from irw_tpu_torch import cuda_lib
    from irw_tpu_torch.ops.wavelets import lifting_dwt

    if not torch.cuda.is_available():
        print("k4_variants: needs a CUDA card", file=sys.stderr)
        return 1
    args = list(argv if argv is not None else sys.argv[1:])
    cases = CASES
    if args[:1] == ["--only"]:
        cases = [case for case in CASES if case[0] in args[1].split(",")]
        args = args[2:]
    specs = [""] + args
    t0 = time.perf_counter()
    built = cu_variants.build("lifting_dwt.cu", specs, CONSTANTS, PATCHES, entries="tile")
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    calls = {tag: cu_variants.load(path, lifting_dwt._SIGNATURES)
             for tag, (path, _) in built.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {case: torch.rand(case[2], generator=gen, device="cuda") * 2 - 1 for case in cases}
    outs = {case: torch.empty(case[2][0], 4, case[2][1] >> case[1], case[2][2] >> case[1],
                              device="cuda") for case in cases}

    def launcher(lib, case):
        basis, levels, (n, h, w) = case
        nsteps, meta, coeffs, k = lifting_dwt._step_arrays(basis)
        reach = lifting_dwt._reach_args(basis)
        x, out = inputs[case], outs[case]
        stream = cuda_lib.stream_of(x)

        def call():
            status = lib.irw_lifting_dwt_f32(x.data_ptr(), out.data_ptr(), None, None, n, h, w,
                                             levels, nsteps, meta, coeffs, k, reach, stream)
            cuda_lib.check(status, "k4 variant", lib)
        return call

    exact = {}
    for case in cases:
        ref = lifting_dwt.lifting_multi_level_plain(inputs[case], case[1], case[0])
        for tag, lib in calls.items():
            outs[case].fill_(float("nan"))
            launcher(lib, case)()
            torch.cuda.synchronize()
            exact[tag] = exact.get(tag, True) and torch.equal(outs[case], ref)
            if not exact[tag] and "probe_" not in tag:
                raise AssertionError(f"variant {tag} differs from the plain version at {case}")

    times = cu_variants.time_in_turns(list(calls), cases,
                                      lambda tag, case: launcher(calls[tag], case))
    for tag in calls:
        ms = {f"{b} l={lv} {s}": times[tag][(b, lv, s)] for b, lv, s in cases}
        print(json.dumps({"variant": tag, "ms": ms, "bit_exact": exact[tag],
                          "ptxas": built[tag][1]}), flush=True)
    print(cu_variants.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
