// Fused multi-level 2-D lifting DWT, coarsest level only:
// x (N, H, W) -> out (N, 4, H/2^l, W/2^l), bands [LL, LH, HL, HH], in f32,
// bf16 or f16 (the storage type T; every path is a template on it).
//
// Replaces: irw_tpu/ops/wavelets/pallas_dwt.py, lifting_multi_level_pallas
// (kernel body _dwt_kernel, lifts _pair_lift_sublane,
// _cdf97_pair_lift_sublane, _make_family_pair_lift).  Per level: lift along
// H, then along W on both halves, then the "v6" scales (0.5, 1, 1, sqrt 2);
// the next level lifts the scaled LL.  Every basis is a table of lifting
// steps (Family below), built by irw_tpu_torch/ops/wavelets/lifting_dwt.py:
//   taps step:  target[i] += sum_t c_t * src[i + n_t]   (in tap order)
//   pair step:  target[i] += c * (src[i + a] + src[i + b])   (cdf97)
// with src read as 0 outside [0, m) of the half-length sequence (no
// wrap-around), then s = even * k and d = odd / k (a division, as on the
// TPU).  Every product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn: nvcc contracts nothing into an FMA),
// in the order the plain PyTorch version computes them, so the two agree
// bit for bit on every path.  In bf16 and f16 the values are loaded into
// f32 and every product, sum and quotient is rounded to T right after it
// (mul / add / dvd below), the lifting coefficients, k and sqrt 2 being
// values of T already: that is the plain version's arithmetic in T, whose
// constants are 0-d tensors of x's dtype (each op on two values of T,
// taken in f32 and rounded once; f32 carries 24 bits >= 2 * 11 + 2, so the
// double rounding is exact).  Registers, shared memory and the path rule
// stay f32; loads and stores move T, half the bytes of f32.
//
// Bound on the H100: memory.  A level does a few flops per element; the
// input is read once and the output written once: at the served shape
// (N = 3 * 64 = 192 planes of 224 x 224, haar, one level) 38.5 MB + 38.5 MB,
// about 23 us at 3.35 TB/s; half that in bf16 or f16, where the two
// conversions that round each operation add instructions the f32 paths
// do not have.
//
// Three paths; irw_lifting_dwt_variant picks one from the shape and the step
// table (lifting_kernel_variants in the wrapper applies the same rule).  The
// first two take one launch for all levels and no device workspace.
//
// 1. register: tables whose every tap has shift 0 (haar), levels 1-3.  No
//    neighbour is read, so each 2^l x 2^l input patch maps to its four
//    outputs alone.  A thread owns C coarsest columns of one coarsest row
//    (C = 2 at level 1 when W % 4 == 0, else 1), loads its 2^l rows with
//    16-byte loads contiguous across the warp (8-byte ones at level 1 when
//    W % 4 == 2, where odd rows do not start on 16 bytes), lifts every level
//    in registers and writes each band with one float2 (C = 2) or one float.
//    No shared memory, no barrier.
// 2. tile: every other table whose steps each read a range of shifts within
//    +-4 (every basis the wrapper knows), all levels, while a tile fits
//    shared memory and beats the two-pass kernels (tile_pays: at most 2
//    levels, or a region at most twice the tile's own input) or they
//    cannot run.  A block owns a tile of the coarsest level's four bands
//    of one plane (64 x 64 pairs at most, evened out over the plane); one
//    block a tile, since a persistent grid walking the tiles measured 7 %
//    slower.  The region the tile depends on is 2^l times the tile plus a
//    halo each side, from the reach the wrapper reckons (kernel_reach: the
//    cone of LL alone below the last level); none along an axis one tile
//    spans, where past the plane every level reads 0.  Per level, two phases: H,
//    where a thread lifts one column over a run of 8 pair rows (16 in the
//    wide-halo kernel) plus the halo either side, entirely in registers (no
//    barrier between steps), and writes the scaled s and d into B, even
//    columns first; then W, where a thread lifts one row of B over a run of
//    pair columns the same way and writes the four bands to the output with
//    float4 stores (last level) or the scaled LL into A as the next level's
//    input.  Level 1 reads the plane straight into those registers (a warp
//    reads 32 consecutive floats a row; a run's halo rows are the next
//    run's and come from L1): a copy of the region into shared memory first
//    (16-byte cp.async, or TMA with its out-of-bounds zeros) measured 1.4 to
//    2.3 x slower: with B beside it a block takes twice the shared memory,
//    so half the blocks fit an SM, and a block's copy does not overlap its
//    own arithmetic.  A step's taps are one compile-time register offset each (a jump
//    to the first shift, then a compare a tap), and both phases run one
//    loop body, so the lifting code is in the kernel once: the kernel with a
//    copy per phase and per parity ran at half the speed, its instructions
//    no longer held by the instruction cache.  Zero padding is per level
//    and per step: a cell whose level index lies outside that level's plane
//    reads as 0 and is never updated, as the plain version's zero-padded
//    shifts read it.  Runs past the level's buffer read 0; the halo holds
//    the cone of the outputs, so those cells feed only the halo.  A run
//    holds the lift's reach either side whatever the tile's halo: the
//    kernel is picked by the reach.  No
//    workspace goes through device memory.
// 3. two_pass: what the tile path cannot hold in shared memory (a halo too
//    wide at deep levels or wide taps) or would take longer over (a wide
//    halo at 3 levels or more), the first design.  Two kernels per
//    level.  The H pass gives a block one plane's strip of 32 columns, the
//    whole height in shared memory (H x 32 x 4 bytes: 28 KiB at 224, 56 KiB
//    at 448), loaded coalesced and split into even and odd rows as it lands;
//    the lifting steps run in place with a barrier between steps, and the
//    scaled s and d halves go to a workspace.  The W pass gives a block 8
//    rows of that workspace, split into even and odd columns in shared
//    memory, lifts them, scales, and writes the four subbands (the last
//    level) or LL alone into a second workspace (an earlier level, which
//    also lifts only the rows LL needs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxSteps = 8;
constexpr int kMaxTaps = 9;
constexpr int kStrip = 32;      // columns per block of the H pass = threads in x
constexpr int kRowsY = 8;       // threads in y of the H pass
constexpr int kRowsW = 8;       // rows per block of the W pass
constexpr int kThreadsW = 256;
constexpr int kMaxShared = 232448;
constexpr int kDefaultShared = 48 * 1024;
constexpr int kRegMaxLevels = 3;        // register path: levels 1 .. 3
constexpr int kRegThreads = 256;
constexpr int kTileThreads = 256;
constexpr int kTileRun = 8;             // pairs a thread's run yields
constexpr int kMaxShift = 4;            // tile path: |shift| of every tap at most
constexpr int kTileMaxHalo = 5;         // and its halo, in pairs of a level, at most
constexpr int kTileMaxLevels = 8;
constexpr int kTileMaxPairs = 64;       // a tile's side, in coarsest pairs, at most
constexpr int kTileMaxShared = 115712;  // 113 KiB a block: two blocks an SM at least
constexpr int kTileAnyHaloLevels = 2;   // levels at which any halo pays; deeper,
constexpr int kTileMaxGrowth = 2;       // the region at most this x the tile's input

constexpr float kSqrt2 = 1.41421356237309504880f;

// The storage types: f32 values pass as they are; a bf16 or f16 value is
// widened on load and each operation's f32 result rounded back to T.
template <typename T>
constexpr bool kF32 = std::is_same_v<T, float>;

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
    if constexpr (kF32<T>) return v;
    else if constexpr (std::is_same_v<T, __nv_bfloat16>) return __bfloat162float(v);
    else return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
    if constexpr (kF32<T>) return v;
    else if constexpr (std::is_same_v<T, __nv_bfloat16>) return __float2bfloat16_rn(v);
    else return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ float rnd(float v) {
    if constexpr (kF32<T>) return v;
    else return to_f32<T>(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return rnd<T>(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float add(float a, float b) { return rnd<T>(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float dvd(float a, float b) { return rnd<T>(__fdiv_rn(a, b)); }

template <typename T>
__device__ __forceinline__ float ldg(const T* p) {
    if constexpr (kF32<T>) return __ldg(p);
    else return to_f32<T>(__ldg(p));
}

// the 16 bits of a 2-byte T, and back
template <typename T>
__device__ __forceinline__ unsigned short bits(float v) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) return __bfloat16_as_ushort(from_f32<T>(v));
    else return __half_as_ushort(from_f32<T>(v));
}

template <typename T>
__device__ __forceinline__ float unbits(unsigned int b) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
    else return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// N consecutive elements of a 2-byte T (4, 8 or 16 bytes, aligned to their
// size) into f32 registers with one load
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* src, float* v) {
    static_assert(!kF32<T> && (N == 2 || N == 4 || N == 8), "2, 4 or 8 two-byte elements");
    unsigned int u[N / 2];
    if constexpr (N == 8) {
        const uint4 t = *reinterpret_cast<const uint4*>(src);
        u[0] = t.x; u[1] = t.y; u[2] = t.z; u[3] = t.w;
    } else if constexpr (N == 4) {
        const uint2 t = *reinterpret_cast<const uint2*>(src);
        u[0] = t.x; u[1] = t.y;
    } else {
        u[0] = *reinterpret_cast<const unsigned int*>(src);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = unbits<T>(u[i / 2] >> (16 * (i % 2)) & 0xffffu);
}

// N = 2 or 4 values (of T already) to consecutive elements, one store
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const float* v) {
    static_assert(N == 2 || N == 4, "2 or 4 elements");
    if constexpr (kF32<T>) {
        if constexpr (N == 4)
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        else
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
        unsigned int u[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            u[i] = bits<T>(v[2 * i]) | static_cast<unsigned int>(bits<T>(v[2 * i + 1])) << 16;
        if constexpr (N == 4)
            *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
        else
            *reinterpret_cast<unsigned int*>(dst) = u[0];
    }
}

struct Step {
    int target;                 // 0: even, 1: odd
    int pair;                   // 1: c * (src[i + a] + src[i + b])
    int ntaps;
    int lo, hi;                 // smallest and largest shift
    int shift[kMaxTaps];
    float coeff[kMaxTaps];
    // the tile path's view: the coefficient of shift n at cn[n + kMaxShift]
    // (a pair step's is coeff[0])
    float cn[2 * kMaxShift + 1];
};

struct Family {
    int nsteps;
    float k;
    Step step[kMaxSteps];
};

// The tile path's geometry.  Halos are in pairs of a level, [0] along H and
// [1] along W, then [0] for an inner level (LL alone is needed) and [1] for
// the last (all four bands); 0 along an axis one tile spans.
struct TilePlan {
    int levels;
    int tr, tc;                 // coarsest pairs a tile owns: rows, columns
    int tiles_r, tiles_c;       // tiles a plane
    int before[2][2], after[2][2];  // halo pairs before and after a tile's own
    int reach;                  // pairs a level's lift reads either side: a run's halo
    int pr[kTileMaxLevels];     // pairs held at each level: rows
    int pc[kTileMaxLevels];     //   and columns
    int a_floats;               // floats before B: level 2's input (A), if any
};

// The new value of target element i of a half-length sequence of m elements
// whose other parity is src (element j at src[j * stride]).
template <typename T>
__device__ __forceinline__ float lifted(const Step& s, const float* src, int i, int m,
                                        int stride, float target) {
    if (s.pair) {
        const int a = i + s.shift[0], b = i + s.shift[1];
        const float va = (a >= 0 && a < m) ? src[a * stride] : 0.f;
        const float vb = (b >= 0 && b < m) ? src[b * stride] : 0.f;
        return add<T>(target, mul<T>(s.coeff[0], add<T>(va, vb)));
    }
    float acc = 0.f;
    for (int t = 0; t < s.ntaps; ++t) {
        const int j = i + s.shift[t];
        const float term = mul<T>(s.coeff[t], (j >= 0 && j < m) ? src[j * stride] : 0.f);
        acc = t == 0 ? term : add<T>(acc, term);
    }
    return add<T>(target, acc);
}

// H pass: src (n, h, w) -> dst (n, h, w) with rows [0, h/2) = s * k and,
// when write_high, rows [h/2, h) = d / k.  Block (kStrip, kRowsY), one
// column strip of one plane; dynamic shared memory h * kStrip floats.
template <typename T>
__global__ void __launch_bounds__(kStrip * kRowsY)
lift_h_kernel(const T* __restrict__ src, T* __restrict__ dst, int n, int h, int w,
              const __grid_constant__ Family fam, int write_high) {
    extern __shared__ float sm[];           // [h][kStrip]: even rows, then odd rows
    const int m = h / 2;
    const int c = threadIdx.x;
    const int col = blockIdx.x * kStrip + c;
    float* even = sm;
    float* odd = sm + m * kStrip;
    const size_t hw = static_cast<size_t>(h) * w;
    for (int p = blockIdx.y; p < n; p += gridDim.y) {
        const T* plane = src + p * hw;
        for (int i = threadIdx.y; i < h; i += kRowsY)
            sm[((i & 1) * m + (i >> 1)) * kStrip + c] =
                col < w ? to_f32<T>(plane[static_cast<size_t>(i) * w + col]) : 0.f;
        __syncthreads();
        for (int s = 0; s < fam.nsteps; ++s) {
            const Step& st = fam.step[s];
            float* tgt = st.target ? odd : even;
            const float* other = (st.target ? even : odd) + c;
            for (int i = threadIdx.y; i < m; i += kRowsY)
                tgt[i * kStrip + c] = lifted<T>(st, other, i, m, kStrip, tgt[i * kStrip + c]);
            __syncthreads();
        }
        if (col < w) {
            T* out = dst + p * hw;
            for (int i = threadIdx.y; i < m; i += kRowsY) {
                out[static_cast<size_t>(i) * w + col] =
                    from_f32<T>(mul<T>(even[i * kStrip + c], fam.k));
                if (write_high)
                    out[static_cast<size_t>(m + i) * w + col] =
                        from_f32<T>(dvd<T>(odd[i * kStrip + c], fam.k));
            }
        }
        __syncthreads();                    // the next plane overwrites the strip
    }
}

// W pass over the first `rows` rows of the H pass output src (n, h, w).
// all_bands: dst is (n, 4, h/2, w/2); else dst is LL alone, (n, h/2, w/2).
// Block kThreadsW threads, kRowsW rows of one plane; dynamic shared memory
// kRowsW * w floats.
template <typename T>
__global__ void __launch_bounds__(kThreadsW)
lift_w_kernel(const T* __restrict__ src, T* __restrict__ dst, int n, int h, int w,
              int rows, const __grid_constant__ Family fam, int all_bands) {
    extern __shared__ float sm[];           // [kRowsW][w]: per row even cols, then odd
    const float v6[4] = {0.5f, 1.0f, 1.0f, rnd<T>(kSqrt2)};
    const int mw = w / 2, mh = h / 2;
    const int r0 = blockIdx.x * kRowsW;
    const int nr = min(kRowsW, rows - r0);
    for (int p = blockIdx.y; p < n; p += gridDim.y) {
        const T* plane = src + (static_cast<size_t>(p) * h + r0) * w;
        for (int e = threadIdx.x; e < nr * w; e += kThreadsW) {
            const int r = e / w, j = e - r * w;
            sm[r * w + (j & 1) * mw + (j >> 1)] = to_f32<T>(plane[e]);
        }
        __syncthreads();
        for (int s = 0; s < fam.nsteps; ++s) {
            const Step& st = fam.step[s];
            const int toff = st.target ? mw : 0;
            const int ooff = st.target ? 0 : mw;
            for (int e = threadIdx.x; e < nr * mw; e += kThreadsW) {
                const int r = e / mw, i = e - r * mw;
                float* row = sm + r * w;
                row[toff + i] = lifted<T>(st, row + ooff, i, mw, 1, row[toff + i]);
            }
            __syncthreads();
        }
        for (int e = threadIdx.x; e < nr * w; e += kThreadsW) {
            const int r = e / w, j = e - r * w;
            const int gr = r0 + r;
            const bool high_w = j >= mw, high_h = gr >= mh;
            const int band = (high_h ? 1 : 0) + (high_w ? 2 : 0);
            if (!all_bands && band != 0) continue;
            const float v = high_w ? dvd<T>(sm[r * w + j], fam.k)
                                   : mul<T>(sm[r * w + j], fam.k);
            const size_t o = (static_cast<size_t>(all_bands ? p * 4 + band : p) * mh +
                              (high_h ? gr - mh : gr)) * mw + (high_w ? j - mw : j);
            dst[o] = from_f32<T>(mul<T>(v, v6[band]));
        }
        __syncthreads();
    }
}

// A shift-0 step on one (even, odd) pair: target plus its update from src.
template <typename T>
__device__ __forceinline__ float lift0(const Step& s, float target, float src) {
    if (s.pair) return add<T>(target, mul<T>(s.coeff[0], add<T>(src, src)));
    float acc = mul<T>(s.coeff[0], src);
    for (int t = 1; t < s.ntaps; ++t) acc = add<T>(acc, mul<T>(s.coeff[t], src));
    return add<T>(target, acc);
}

// One level of the register path on the top-left R x CW corner of v: lift
// along H and scale; lift along W every row (last level) or the s rows
// alone (inner level: LL is all the next needs), then, inner, leave the
// scaled LL in the top-left (R/2) x (CW/2) corner.
template <typename T, int PH, int PW, int R, int CW, bool LAST>
__device__ __forceinline__ void reg_level(float (&v)[PH][PW], const Family& fam) {
    for (int s = 0; s < fam.nsteps; ++s) {
        const Step& st = fam.step[s];
        if (st.target) {
#pragma unroll
            for (int r = 0; r < R; r += 2)
#pragma unroll
                for (int c = 0; c < CW; ++c) v[r + 1][c] = lift0<T>(st, v[r + 1][c], v[r][c]);
        } else {
#pragma unroll
            for (int r = 0; r < R; r += 2)
#pragma unroll
                for (int c = 0; c < CW; ++c) v[r][c] = lift0<T>(st, v[r][c], v[r + 1][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < R; r += 2)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
            v[r][c] = mul<T>(v[r][c], fam.k);
            v[r + 1][c] = dvd<T>(v[r + 1][c], fam.k);
        }
    constexpr int kRowStep = LAST ? 1 : 2;
    for (int s = 0; s < fam.nsteps; ++s) {
        const Step& st = fam.step[s];
        if (st.target) {
#pragma unroll
            for (int r = 0; r < R; r += kRowStep)
#pragma unroll
                for (int c = 0; c < CW; c += 2) v[r][c + 1] = lift0<T>(st, v[r][c + 1], v[r][c]);
        } else {
#pragma unroll
            for (int r = 0; r < R; r += kRowStep)
#pragma unroll
                for (int c = 0; c < CW; c += 2) v[r][c] = lift0<T>(st, v[r][c], v[r][c + 1]);
        }
    }
    if constexpr (!LAST) {
#pragma unroll
        for (int r = 0; r < R / 2; ++r)
#pragma unroll
            for (int c = 0; c < CW / 2; ++c)
                v[r][c] = mul<T>(mul<T>(v[2 * r][2 * c], fam.k), 0.5f);
    }
}

template <typename T, int PH, int PW, int LVL, int L>
__device__ __forceinline__ void reg_levels(float (&v)[PH][PW], const Family& fam) {
    reg_level<T, PH, PW, (PH >> LVL), (PW >> LVL), LVL == L - 1>(v, fam);
    if constexpr (LVL + 1 < L) reg_levels<T, PH, PW, LVL + 1, L>(v, fam);
}

// Register path: L levels, C coarsest columns a thread.  Grid (coarsest
// rows x column groups / kRegThreads, planes), planes walked past 65535.
template <typename T, int L, int C>
__global__ void __launch_bounds__(kRegThreads)
lift_reg_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int h, int w,
                const __grid_constant__ Family fam) {
    constexpr int PH = 1 << L, PW = C << L;     // the input patch a thread reads
    const int hc = h >> L, wc = w >> L, groups = wc / C;
    const int e = blockIdx.x * kRegThreads + threadIdx.x;
    if (e >= hc * groups) return;
    const int i = e / groups, g = e - i * groups;
    const size_t hw = static_cast<size_t>(h) * w, band = static_cast<size_t>(hc) * wc;
    for (int p = blockIdx.y; p < n; p += gridDim.y) {
        const T* src = x + p * hw + static_cast<size_t>(i) * PH * w + g * PW;
        float v[PH][PW];
#pragma unroll
        for (int r = 0; r < PH; ++r) {
            if constexpr (!kF32<T>) {
                // PW two-byte elements: 4, 8 or 16 bytes, aligned as the f32
                // path's 8 and 16 (W % 4 == 0 where PW = 4)
                load_vec<T, PW>(src + static_cast<size_t>(r) * w, v[r]);
            } else if constexpr (PW % 4 == 0) {
#pragma unroll
                for (int c = 0; c < PW; c += 4) {
                    const float4 t =
                        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * w + c);
                    v[r][c] = t.x;
                    v[r][c + 1] = t.y;
                    v[r][c + 2] = t.z;
                    v[r][c + 3] = t.w;
                }
            } else {
                const float2 t = *reinterpret_cast<const float2*>(src + static_cast<size_t>(r) * w);
                v[r][0] = t.x;
                v[r][1] = t.y;
            }
        }
        reg_levels<T, PH, PW, 0, L>(v, fam);
        // the last level's W scale, then v6: [LL, LH, HL, HH]
        float b[4][C];
#pragma unroll
        for (int q = 0; q < C; ++q) {
            b[0][q] = mul<T>(mul<T>(v[0][2 * q], fam.k), 0.5f);
            b[1][q] = mul<T>(mul<T>(v[1][2 * q], fam.k), 1.0f);
            b[2][q] = mul<T>(dvd<T>(v[0][2 * q + 1], fam.k), 1.0f);
            b[3][q] = mul<T>(dvd<T>(v[1][2 * q + 1], fam.k), rnd<T>(kSqrt2));
        }
        T* o = out + p * 4 * band + static_cast<size_t>(i) * wc + g * C;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if constexpr (C == 2)
                store_vec<T, 2>(o + k * band, b[k]);
            else
                o[k * band] = from_f32<T>(b[k][0]);
        }
    }
}

__host__ __device__ constexpr int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The taps of shift N of a step on a run in registers: acc[i] = (or +=) the
// term from src[i + N] (c * src for a taps step, src alone for a pair step,
// whose sum is scaled after).  Elements whose source lies past the run are
// left alone (0 on the first tap): the run's halo holds the outputs' cone,
// so they feed only the halo's own pairs.
template <typename T, int N, int NP, bool PAIR, bool FIRST>
__device__ __forceinline__ void tap(float (&acc)[NP], const float (&src)[NP], float c) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
        if (i + N < 0 || i + N >= NP) {
            if (FIRST) acc[i] = 0.f;
            continue;
        }
        const float v = src[clamp_index(i + N, NP)];
        const float term = PAIR ? v : mul<T>(c, v);
        acc[i] = FIRST ? term : add<T>(acc[i], term);
    }
}

// acc = the update of every element of the run: the taps of shifts lo..hi,
// in that order (the tile path takes only a step whose shifts are such a
// range, in the table's order but for two taps, whose sum is the same
// either way).  Each shift is a compile-time register offset: one jump to
// lo's case, then one compare a further tap.
template <typename T, int NP, bool PAIR>
__device__ __forceinline__ void taps(const Step& st, float (&acc)[NP], const float (&src)[NP]) {
    const int hi = st.hi;
    const float* cn = st.cn;
    switch (st.lo) {
        case -4: tap<T, -4, NP, PAIR, true>(acc, src, cn[0]); if (hi > -4) goto add_m3; goto done;
        case -3: tap<T, -3, NP, PAIR, true>(acc, src, cn[1]); if (hi > -3) goto add_m2; goto done;
        case -2: tap<T, -2, NP, PAIR, true>(acc, src, cn[2]); if (hi > -2) goto add_m1; goto done;
        case -1: tap<T, -1, NP, PAIR, true>(acc, src, cn[3]); if (hi > -1) goto add_0; goto done;
        case 0: tap<T, 0, NP, PAIR, true>(acc, src, cn[4]); if (hi > 0) goto add_p1; goto done;
        case 1: tap<T, 1, NP, PAIR, true>(acc, src, cn[5]); if (hi > 1) goto add_p2; goto done;
        case 2: tap<T, 2, NP, PAIR, true>(acc, src, cn[6]); if (hi > 2) goto add_p3; goto done;
        case 3: tap<T, 3, NP, PAIR, true>(acc, src, cn[7]); if (hi > 3) goto add_p4; goto done;
        default: tap<T, 4, NP, PAIR, true>(acc, src, cn[8]); goto done;
    }
add_m3:
    tap<T, -3, NP, PAIR, false>(acc, src, cn[1]);
    if (hi == -3) goto done;
add_m2:
    tap<T, -2, NP, PAIR, false>(acc, src, cn[2]);
    if (hi == -2) goto done;
add_m1:
    tap<T, -1, NP, PAIR, false>(acc, src, cn[3]);
    if (hi == -1) goto done;
add_0:
    tap<T, 0, NP, PAIR, false>(acc, src, cn[4]);
    if (hi == 0) goto done;
add_p1:
    tap<T, 1, NP, PAIR, false>(acc, src, cn[5]);
    if (hi == 1) goto done;
add_p2:
    tap<T, 2, NP, PAIR, false>(acc, src, cn[6]);
    if (hi == 2) goto done;
add_p3:
    tap<T, 3, NP, PAIR, false>(acc, src, cn[7]);
    if (hi == 3) goto done;
add_p4:
    tap<T, 4, NP, PAIR, false>(acc, src, cn[8]);
done:
    if (PAIR) {
#pragma unroll
        for (int i = 0; i < NP; ++i) acc[i] = mul<T>(st.coeff[0], acc[i]);
    }
}

// One lifting step on a run of NP pairs held in registers: tgt[i] plus its
// update for each i set in `valid` (the pairs inside the level's plane).
template <typename T, int NP>
__device__ __forceinline__ void run_step(const Step& st, float (&tgt)[NP], const float (&src)[NP],
                                         unsigned valid) {
    float acc[NP];
    if (st.pair)
        taps<T, NP, true>(st, acc, src);
    else
        taps<T, NP, false>(st, acc, src);
#pragma unroll
    for (int i = 0; i < NP; ++i)
        if (valid >> i & 1u) tgt[i] = add<T>(tgt[i], acc[i]);
}

template <typename T, int NP>
__device__ __forceinline__ void lift_run(const Family& fam, float (&e)[NP], float (&o)[NP],
                                         unsigned valid) {
    for (int s = 0; s < fam.nsteps; ++s) {
        const Step& st = fam.step[s];
        if (st.target)
            run_step<T>(st, o, e, valid);
        else
            run_step<T>(st, e, o, valid);
    }
}

// bits i of [0, NP) whose pair g0 + i lies in [0, m)
__device__ __forceinline__ unsigned plane_bits(int g0, int m, int np) {
    const int lo = max(0, -g0), hi = min(np, m - g0);
    return hi <= lo ? 0u : ((hi >= 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u));
}

// Plane p of tile t and the first pair its level-1 region holds (br, bc)
__device__ __forceinline__ void tile_origin(const TilePlan& pl, int t, int* p, int* br, int* bc) {
    const int per_plane = pl.tiles_r * pl.tiles_c;
    *p = t / per_plane;
    const int rem = t - *p * per_plane;
    const int ti = rem / pl.tiles_c, tj = rem - ti * pl.tiles_c;
    *br = ti * pl.tr - pl.before[0][1];
    *bc = tj * pl.tc - pl.before[1][1];
    for (int j = pl.levels - 2; j >= 0; --j) {
        *br = 2 * *br - pl.before[0][0];
        *bc = 2 * *bc - pl.before[1][0];
    }
}

// Tile path: kTileThreads threads; dynamic shared memory from tile_plan.
// HALO: the pairs a run holds on each side of its R (at least every halo of
// the plan).
//
// Per level, two phases and two barriers.  H: a thread owns one column of
// the level's input and a run of R pair rows the W lift needs; it reads the
// run with HALO pairs either side (level 1 from the plane, a warp's reads a
// row of 32 consecutive floats; later levels from A), lifts every step in
// registers, scales, and writes s (and, at the last level, d) into B, even
// columns first.  W: a thread owns one row of B and a run of R pair
// columns; it reads them with their halo, lifts, scales, and writes the
// four bands (last level) or the scaled LL into A, the next level's input.
// A and B rows have an odd stride, so the W phase's threads, one a row, hit
// distinct banks.  Both phases run one loop body, so the lifting code, the
// bulk of the kernel, is there once.
template <typename T, int HALO, int R, int MIN_BLOCKS>
__global__ void __launch_bounds__(kTileThreads, MIN_BLOCKS)
lift_tile_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                 const __grid_constant__ Family fam, const __grid_constant__ TilePlan pl) {
    constexpr int NP = R + 2 * HALO;
    extern __shared__ __align__(16) float tile_sm[];
    float* const A = tile_sm;                   // levels 2 and up: the level's input
    float* const B = tile_sm + pl.a_floats;
    const int L = pl.levels;
    const int hc = h >> L, wc = w >> L;
    const size_t band = static_cast<size_t>(hc) * wc;
    const bool vec_out = wc % 4 == 0 && pl.tc % 4 == 0;
    int p, br, bc;
    tile_origin(pl, blockIdx.x, &p, &br, &bc);
    const T* plane = x + static_cast<size_t>(p) * h * w;
    int sa = 0;                                 // A's row stride, in floats
    for (int j = 0; j < L; ++j) {
        const int last = j == L - 1;
        const int P = pl.pr[j], Q = pl.pc[j];              // pairs held: rows, columns
        const int mr = (h >> j) / 2, mc = (w >> j) / 2;    // pairs in this level's plane
        const int top = pl.before[0][last], left = pl.before[1][last];  // the tile's first pairs
        const int nr = last ? pl.tr : 2 * pl.pr[j + 1];    // pair rows needed, from `top`
        const int ncol = last ? pl.tc : 2 * pl.pc[j + 1];  // pair columns needed, from `left`
        const int brows = last ? 2 * nr : nr;              // B: s and d rows, or s alone
        const int sb = 2 * Q + 1;
        const int sa_next = last ? 0 : 2 * pl.pc[j + 1] + 1;
#pragma unroll 1
        for (int wphase = 0; wphase < 2; ++wphase) {
            // H: items (run k, column c); W: items (run k, row r)
            const int lanes = wphase ? brows : 2 * Q;
            const int items = lanes * (((wphase ? ncol : nr) + R - 1) / R);
            for (int e = threadIdx.x; e < items; e += kTileThreads) {
                // H: a warp's lanes on neighbouring columns (its loads are a row
                // of the plane); W at one level: a row's runs on neighbouring
                // lanes (its stores are rows of a band: 12 % faster at cdf97's
                // 448², a few % slower below a first level)
                const int runs = items / lanes;
                const bool by_row = wphase && L == 1;
                const int k = by_row ? e % runs : e / lanes;
                const int c = by_row ? e / runs : e - k * lanes;
                float ev[NP], od[NP];
                unsigned valid;
                if (!wphase) {
                    const int r0 = top + k * R - HALO;     // local pair row of run index 0
                    const bool cin =
                        static_cast<unsigned>(2 * bc + c) < static_cast<unsigned>(2 * mc);
                    const unsigned rows_in = plane_bits(br + r0, mr, NP);
                    if (j == 0) {
                        const ptrdiff_t col =
                            static_cast<ptrdiff_t>(2 * (br + r0)) * w + 2 * bc + c;
#pragma unroll
                        for (int i = 0; i < NP; ++i) {
                            const bool in = cin && (rows_in >> i & 1u);
                            ev[i] = in ? ldg<T>(plane + col + static_cast<ptrdiff_t>(2 * i) * w)
                                       : 0.f;
                            od[i] = in ? ldg<T>(plane + col +
                                                static_cast<ptrdiff_t>(2 * i + 1) * w)
                                       : 0.f;
                        }
                    } else {
#pragma unroll
                        for (int i = 0; i < NP; ++i) {
                            const bool in =
                                static_cast<unsigned>(r0 + i) < static_cast<unsigned>(P);
                            ev[i] = in ? A[(2 * (r0 + i)) * sa + c] : 0.f;
                            od[i] = in ? A[(2 * (r0 + i) + 1) * sa + c] : 0.f;
                        }
                    }
                    valid = cin ? rows_in : 0u;
                } else {
                    const int q0 = left + k * R - HALO;    // local pair column of index 0
                    const bool rin = static_cast<unsigned>(br + top + (last ? c >> 1 : c)) <
                                     static_cast<unsigned>(mr);
                    const float* brow = B + c * sb;
#pragma unroll
                    for (int i = 0; i < NP; ++i) {
                        const bool in = static_cast<unsigned>(q0 + i) < static_cast<unsigned>(Q);
                        ev[i] = in ? brow[q0 + i] : 0.f;
                        od[i] = in ? brow[Q + q0 + i] : 0.f;
                    }
                    valid = rin ? plane_bits(bc + q0, mc, NP) : 0u;
                }
                lift_run<T>(fam, ev, od, valid);
                if (!wphase) {
                    // s * k (and d / k) into B, the column's even or odd half
                    const bool cin = valid != 0u;
                    float* col = B + (c & 1) * Q + (c >> 1);
#pragma unroll
                    for (int i = HALO; i < HALO + R; ++i) {
                        const int row = k * R + i - HALO;
                        if (row < nr) {
                            const float s = cin ? mul<T>(ev[i], fam.k) : 0.f;
                            if (last) {
                                col[(2 * row) * sb] = s;
                                col[(2 * row + 1) * sb] = cin ? dvd<T>(od[i], fam.k) : 0.f;
                            } else {
                                col[row * sb] = s;
                            }
                        }
                    }
                } else if (last) {
                    // W scale, then v6: row c of the tile's [LL, HL] or [LH, HH]
                    const int gi = br + top + (c >> 1), par = c & 1;
                    const int gq0 = bc + left + k * R;     // first output column
                    if (valid == 0u || gi >= hc) continue;
                    float lo[R], hi[R];
#pragma unroll
                    for (int i = 0; i < R; ++i) {
                        lo[i] = mul<T>(mul<T>(ev[HALO + i], fam.k), par ? 1.0f : 0.5f);
                        hi[i] = mul<T>(dvd<T>(od[HALO + i], fam.k),
                                       par ? rnd<T>(kSqrt2) : 1.0f);
                    }
                    T* o_lo = out + (static_cast<size_t>(p) * 4 + par) * band +
                              static_cast<size_t>(gi) * wc + gq0;
                    T* o_hi = o_lo + 2 * band;
                    const int nq = min(R, min(ncol - k * R, wc - gq0));
                    if (vec_out && nq == R) {
#pragma unroll
                        for (int i = 0; i < R; i += 4) {
                            store_vec<T, 4>(o_lo + i, lo + i);
                            store_vec<T, 4>(o_hi + i, hi + i);
                        }
                    } else {
#pragma unroll
                        for (int i = 0; i < R; ++i)
                            if (i < nq) {
                                o_lo[i] = from_f32<T>(lo[i]);
                                o_hi[i] = from_f32<T>(hi[i]);
                            }
                    }
                } else {
                    // the scaled LL into A, the next level's input; 0 outside the plane
                    float* arow = A + c * sa_next + k * R;
#pragma unroll
                    for (int i = 0; i < R; ++i)
                        if (k * R + i < ncol)
                            arow[i] = valid >> (HALO + i) & 1u
                                          ? mul<T>(mul<T>(ev[HALO + i], fam.k), 0.5f)
                                          : 0.f;
                }
            }
            __syncthreads();
        }
        if (!last) {
            br = (br + top) / 2;
            bc = (bc + left) / 2;
            sa = sa_next;
        }
    }
}

template <typename Kernel>
int set_shared(Kernel kernel, int bytes) {
    if (bytes <= kDefaultShared) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// pairs each level's buffer holds along one axis for t coarsest pairs a
// tile, with `last` pairs of halo at the last level and `inner` below it
void axis_pairs(int levels, int t, int inner, int last, int* p) {
    p[levels - 1] = t + last;
    for (int j = levels - 2; j >= 0; --j) p[j] = 2 * p[j + 1] + inner;
}

// The tile path's plan for an (h, w) plane, or -1 if no tile of at least 2
// coarsest pairs a side fits kTileMaxShared; else its shared-memory bytes.
// reach: samples of one level's input the lift reads before and after a
// pair, with all four bands {left, right} then with LL alone.  Shared
// memory: A, level 2's input (2 pr[1] rows of 2 pc[1] + 1 floats; later
// levels' smaller inputs reuse it; none at one level), then B, the rows the
// W lift needs (row stride 2 pc + 1).  The tile side is the largest of 64,
// 32, 16, 8, 4, 2 that fits, evened out over the plane's tiles.  Along an
// axis one tile spans, the tile holds the plane and no halo: past it every
// level reads 0, as the plain version's zero padding does.
int tile_plan(int h, int w, int levels, const int* reach, TilePlan* pl) {
    if (levels > kTileMaxLevels) return -1;
    *pl = TilePlan{};
    pl->levels = levels;
    int before[2], after[2];
    for (int k = 0; k < 2; ++k) {           // [0] inner level, [1] last
        const int* r = reach + (k ? 0 : 2);
        before[k] = (r[0] + 1) / 2;
        after[k] = (r[1] + 1) / 2;
        if (before[k] > kTileMaxHalo || after[k] > kTileMaxHalo) return -1;
        pl->reach = before[k] > pl->reach ? before[k] : pl->reach;
        pl->reach = after[k] > pl->reach ? after[k] : pl->reach;
    }
    const int hc = h >> levels, wc = w >> levels;
    const int hc1 = hc > 1 ? hc : 1, wc1 = wc > 1 ? wc : 1;
    for (int t = kTileMaxPairs; t >= 2; t /= 2) {
        pl->tiles_r = (hc1 + t - 1) / t;
        pl->tiles_c = (wc1 + t - 1) / t;
        pl->tr = (hc1 + pl->tiles_r - 1) / pl->tiles_r;
        pl->tc = (wc1 + pl->tiles_c - 1) / pl->tiles_c;
        for (int a = 0; a < 2; ++a) {
            const bool spans = (a ? pl->tiles_c : pl->tiles_r) == 1;
            for (int k = 0; k < 2; ++k) {
                pl->before[a][k] = spans ? 0 : before[k];
                pl->after[a][k] = spans ? 0 : after[k];
            }
        }
        axis_pairs(levels, pl->tr, pl->before[0][0] + pl->after[0][0],
                   pl->before[0][1] + pl->after[0][1], pl->pr);
        axis_pairs(levels, pl->tc, pl->before[1][0] + pl->after[1][0],
                   pl->before[1][1] + pl->after[1][1], pl->pc);
        const long long a = levels == 1 ? 0LL : 2LL * pl->pr[1] * (2 * pl->pc[1] + 1);
        const long long b = (levels == 1 ? 2LL * pl->tr : 2LL * pl->pr[1]) * (2 * pl->pc[0] + 1);
        if ((a + b) * 4 <= kTileMaxShared) {
            pl->tiles_c = (wc1 + pl->tc - 1) / pl->tc;
            pl->a_floats = static_cast<int>(a);
            return static_cast<int>((a + b) * 4);
        }
    }
    return -1;
}

// Whether the tile path beats the two-pass kernels at this plan.  Up to
// kTileAnyHaloLevels levels it did at every shape measured; deeper, the
// halo compounds level by level (cdf97 at 3 levels reads a region 2.25 x
// the tile's input, and ran 1.08-1.28 x the two-pass time), so the tile
// path takes a plan whose level-1 region is at most kTileMaxGrowth x the
// tile's own input (haar: 1; daub4 at 3 levels: 1.43, 0.50 x).
bool tile_pays(const TilePlan& pl) {
    if (pl.levels <= kTileAnyHaloLevels) return true;
    const long long own = (static_cast<long long>(pl.tr) << pl.levels) *
                          (static_cast<long long>(pl.tc) << pl.levels);
    return 4LL * pl.pr[0] * pl.pc[0] <= kTileMaxGrowth * own;
}

bool shift_zero(const Family& fam) {
    for (int s = 0; s < fam.nsteps; ++s)
        if (fam.step[s].lo != 0 || fam.step[s].hi != 0) return false;
    return true;
}

// The tile path sums a step's taps in order of their shift: it takes a
// table whose steps each have the shifts of a range in [-kMaxShift,
// kMaxShift], each once and, for three taps or more, in that order (the sum
// of two does not depend on it).
bool tile_takes(const Family& fam) {
    for (int s = 0; s < fam.nsteps; ++s) {
        const Step& st = fam.step[s];
        if (st.lo < -kMaxShift || st.hi > kMaxShift || st.hi - st.lo + 1 != st.ntaps)
            return false;
        for (int t = 1; t < st.ntaps; ++t) {
            for (int u = 0; u < t; ++u)
                if (st.shift[u] == st.shift[t]) return false;
            if (st.ntaps > 2 && st.shift[t] < st.shift[t - 1]) return false;
        }
    }
    return true;
}

// 2 register, 1 tile, 0 two_pass, -1 none
int variant(int h, int w, int levels, const Family& fam, const int* reach, TilePlan* pl,
            int* bytes) {
    if (shift_zero(fam) && levels <= kRegMaxLevels) return 2;
    const bool two_pass = static_cast<long long>(h) * kStrip * 4 <= kMaxShared &&
                          static_cast<long long>(w) * kRowsW * 4 <= kMaxShared;
    if (tile_takes(fam) && (*bytes = tile_plan(h, w, levels, reach, pl)) >= 0 &&
        (tile_pays(*pl) || !two_pass))
        return 1;
    if (two_pass) return 0;
    return -1;
}

// meta: nsteps rows of (target, pair, ntaps, shift[kMaxTaps]); coeffs (may
// be null): nsteps rows of kMaxTaps.  Returns 0, or cudaErrorInvalidValue.
int read_family(int nsteps, const int* meta, const float* coeffs, float k, Family* fam) {
    if (nsteps < 1 || nsteps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
    *fam = Family{};
    fam->nsteps = nsteps;
    fam->k = k;
    for (int s = 0; s < nsteps; ++s) {
        const int* row = meta + s * (3 + kMaxTaps);
        Step& st = fam->step[s];
        st.target = row[0];
        st.pair = row[1];
        st.ntaps = row[2];
        if (st.ntaps < 1 || st.ntaps > kMaxTaps || (st.pair && st.ntaps != 2))
            return static_cast<int>(cudaErrorInvalidValue);
        for (int t = 0; t < kMaxTaps; ++t) {
            st.shift[t] = row[3 + t];
            st.coeff[t] = coeffs ? coeffs[s * kMaxTaps + t] : 0.f;
        }
        st.lo = st.hi = st.shift[0];
        for (int t = 1; t < st.ntaps; ++t) {
            st.lo = st.shift[t] < st.lo ? st.shift[t] : st.lo;
            st.hi = st.shift[t] > st.hi ? st.shift[t] : st.hi;
        }
        if (st.lo >= -kMaxShift && st.hi <= kMaxShift)
            for (int t = 0; t < st.ntaps; ++t) st.cn[st.shift[t] + kMaxShift] = st.coeff[t];
    }
    return 0;
}

template <typename T>
int launch_register(const T* x, T* out, int n, int h, int w, int levels, const Family& fam,
                    cudaStream_t strm) {
    const int c = levels == 1 && w % 4 == 0 ? 2 : 1;
    const long long items = static_cast<long long>(h >> levels) * ((w >> levels) / c);
    const dim3 grid(static_cast<unsigned>((items + kRegThreads - 1) / kRegThreads),
                    n < 65535 ? n : 65535);
    if (levels == 1 && c == 2)
        lift_reg_kernel<T, 1, 2><<<grid, kRegThreads, 0, strm>>>(x, out, n, h, w, fam);
    else if (levels == 1)
        lift_reg_kernel<T, 1, 1><<<grid, kRegThreads, 0, strm>>>(x, out, n, h, w, fam);
    else if (levels == 2)
        lift_reg_kernel<T, 2, 1><<<grid, kRegThreads, 0, strm>>>(x, out, n, h, w, fam);
    else
        lift_reg_kernel<T, 3, 1><<<grid, kRegThreads, 0, strm>>>(x, out, n, h, w, fam);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Kernel>
int launch_tile(Kernel kernel, const T* x, T* out, int n, int h, int w, const Family& fam,
                const TilePlan& pl, int bytes, cudaStream_t strm) {
    // tile indices are ints: 2^31 tiles of 16 outputs or more (the least a
    // tile holds) would not fit the card's memory
    const long long tiles = static_cast<long long>(n) * pl.tiles_r * pl.tiles_c;
    if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int status = set_shared(kernel, bytes);
    if (status) return status;
    kernel<<<static_cast<unsigned>(tiles), kTileThreads, bytes, strm>>>(x, out, h, w, fam, pl);
    return static_cast<int>(cudaGetLastError());
}

// the tile kernel whose runs hold the lift's reach (the plan's halos may be
// narrower: none along an axis one tile spans)
template <typename T>
int launch_tile(const T* x, T* out, int n, int h, int w, const Family& fam, const TilePlan& pl,
                int bytes, cudaStream_t strm) {
    return pl.reach <= 2 ? launch_tile(lift_tile_kernel<T, 2, kTileRun, 4>, x, out, n, h, w, fam,
                                       pl, bytes, strm)
                         : launch_tile(lift_tile_kernel<T, kTileMaxHalo, 2 * kTileRun, 2>, x, out,
                                       n, h, w, fam, pl, bytes, strm);
}

template <typename T>
int launch_two_pass(const T* x, T* out, T* lift_ws, T* ll_ws, int n, int h, int w, int levels,
                    const Family& fam, cudaStream_t strm) {
    const int grid_n = n < 65535 ? n : 65535;
    for (int lvl = 0; lvl < levels; ++lvl) {
        const int hl = h >> lvl, wl = w >> lvl;
        const bool last = lvl == levels - 1;
        const T* src = lvl == 0 ? x : ll_ws;
        const int h_bytes = hl * kStrip * 4;
        int status = set_shared(lift_h_kernel<T>, h_bytes);
        if (status) return status;
        lift_h_kernel<T><<<dim3((wl + kStrip - 1) / kStrip, grid_n), dim3(kStrip, kRowsY),
                           h_bytes, strm>>>(src, lift_ws, n, hl, wl, fam, last ? 1 : 0);
        status = static_cast<int>(cudaGetLastError());
        if (status) return status;
        const int rows = last ? hl : hl / 2;   // an earlier level needs LL only
        const int w_bytes = kRowsW * wl * 4;
        status = set_shared(lift_w_kernel<T>, w_bytes);
        if (status) return status;
        lift_w_kernel<T><<<dim3((rows + kRowsW - 1) / kRowsW, grid_n), kThreadsW, w_bytes,
                           strm>>>(lift_ws, last ? out : ll_ws, n, hl, wl, rows, fam,
                                   last ? 1 : 0);
        status = static_cast<int>(cudaGetLastError());
        if (status) return status;
    }
    return 0;
}

// x (n, h, w) of T, 16-byte aligned; out (n, 4, h >> levels, w >> levels)
// of T; the workspaces of T.  The rest as irw_lifting_dwt_f32 below.
template <typename T>
int lifting_dwt(const void* x, void* out, void* lift_ws, void* ll_ws, int n, int h, int w,
                int levels, int nsteps, const int* meta, const float* coeffs, float k,
                const int* reach, void* stream) {
    Family fam;
    TilePlan pl;
    int bytes = -1;
    if (n <= 0 || levels < 1 || levels > 30 || h % (1 << levels) || w % (1 << levels) ||
        reinterpret_cast<uintptr_t>(x) % 16 || read_family(nsteps, meta, coeffs, k, &fam))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<T*>(out);
    auto strm = static_cast<cudaStream_t>(stream);
    switch (variant(h, w, levels, fam, reach, &pl, &bytes)) {
        case 2:
            return launch_register(xt, ot, n, h, w, levels, fam, strm);
        case 1:
            return launch_tile(xt, ot, n, h, w, fam, pl, bytes, strm);
        case 0:
            if (lift_ws == nullptr || (levels > 1 && ll_ws == nullptr))
                return static_cast<int>(cudaErrorInvalidValue);
            return launch_two_pass(xt, ot, static_cast<T*>(lift_ws), static_cast<T*>(ll_ws), n, h,
                                   w, levels, fam, strm);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// The path irw_lifting_dwt_f32 takes for an (h, w) plane at `levels` and the
// step table (meta as there; reach as there): 2 register, 1 tile,
// 0 two_pass, -1 none.  The same for every storage type.
extern "C" int irw_lifting_dwt_variant(int h, int w, int levels, int nsteps, const int* meta,
                                       const int* reach) {
    Family fam;
    TilePlan pl;
    int bytes = -1;
    if (levels < 1 || levels > 30 || h % (1 << levels) || w % (1 << levels) ||
        read_family(nsteps, meta, nullptr, 1.f, &fam))
        return -1;
    return variant(h, w, levels, fam, reach, &pl, &bytes);
}

// x (n, h, w), 16-byte aligned; out (n, 4, h >> levels, w >> levels).
// lift_ws (n, h, w) and ll_ws (n, h / 2, w / 2) are read by the two_pass
// path alone (ll_ws only when levels > 1) and may be null otherwise.
// meta: nsteps rows of (target, pair, ntaps, shift[kMaxTaps]); coeffs:
// nsteps rows of kMaxTaps; reach: samples of one level's input the lift
// reads before and after a pair, {left, right} for all four bands, then
// {left, right} for LL alone (lifting_dwt.py, kernel_reach).  One call = one
// launch on the register and tile paths, two a level on the two_pass path,
// on `stream`; returns the first CUDA error (0 if none).
extern "C" int irw_lifting_dwt_f32(const void* x, void* out, void* lift_ws, void* ll_ws,
                                   int n, int h, int w, int levels, int nsteps,
                                   const int* meta, const float* coeffs, float k,
                                   const int* reach, void* stream) {
    return lifting_dwt<float>(x, out, lift_ws, ll_ws, n, h, w, levels, nsteps, meta, coeffs, k,
                              reach, stream);
}

// The same in bf16 and in f16: every tensor of that type, coeffs and k
// values of it (rounded by the caller, as the plain version rounds them).
extern "C" int irw_lifting_dwt_bf16(const void* x, void* out, void* lift_ws, void* ll_ws,
                                    int n, int h, int w, int levels, int nsteps,
                                    const int* meta, const float* coeffs, float k,
                                    const int* reach, void* stream) {
    return lifting_dwt<__nv_bfloat16>(x, out, lift_ws, ll_ws, n, h, w, levels, nsteps, meta,
                                      coeffs, k, reach, stream);
}

extern "C" int irw_lifting_dwt_f16(const void* x, void* out, void* lift_ws, void* ll_ws,
                                   int n, int h, int w, int levels, int nsteps,
                                   const int* meta, const float* coeffs, float k,
                                   const int* reach, void* stream) {
    return lifting_dwt<__half>(x, out, lift_ws, ll_ws, n, h, w, levels, nsteps, meta, coeffs,
                               k, reach, stream);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
