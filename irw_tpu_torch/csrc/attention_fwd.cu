// Fused multi-head attention forward for short sequences:
//   o = softmax(q k^T * scale) v   per (batch, head),
// q, k, v, o in the public layout (B, N, H, hd), read and written through
// element strides (the last axis contiguous), bf16 or f32.  When autograd
// will need them, the row statistics (max m and sum l of exp(s - m)) are
// written to an f32 (2, B * H, N) tensor, so the backward (K3) need not
// recompute them.
//
// Replaces: irw_tpu/ops/vmem_attention.py, fused_attention -> _fwd_call
// (kernel body _fwd_kernel).  Same rounding as the TPU kernel: scores and
// softmax in f32, the NORMALISED probabilities rounded to the input dtype,
// then P.V accumulated in f32 and cast to the output dtype.
//
// Bound on the H100 at the flagship (B = 4 bands * 64 = 256, N = 257, H = 6,
// hd = 64, bf16): memory.  q, k, v read and o written are 4 * 50.5 MB =
// 202 MB, about 60 us at 3.35 TB/s; the 4 B H N^2 hd = 26 GFLOP of the two
// products take about 26 us at the 989 TFLOP/s bf16 tensor-core peak.  The
// kernel runs three products (q k^T twice, see below): 39 GFLOP.
//
// Both paths keep TWO passes over the scores.  Pass 1 computes each row's
// max and sum in f32, online over 64-key chunks.  Pass 2 recomputes the
// scores, forms the normalised P = exp(s - max) / sum, rounds it to the
// input dtype and accumulates P.V in f32.  A one-pass online softmax would
// round the unnormalised exponentials instead, which the TPU kernel never
// does.  On the bf16 paths exp is the special-function unit's 2^x
// (ex2.approx, about two f32 ulps) and the quotient is exp(s - max) times
// 1 / sum, the reciprocal rounded once per row: both within a few f32 ulps
// of libm's expf and a true division before P is rounded to bf16, where
// those cost about eight and ten dependent instructions per score (the
// limits of chip_smoke.py and the tests are unchanged).  The f32 path keeps
// expf.
//
// bf16, plane path (the flagship; whenever K and V of one (batch, head)
// plane fit in shared memory: 2 * ceil16(N) * hd * 2 bytes <= 227 KB, i.e.
// N <= 896 at hd 64, N <= 448 at hd 128): one thread block per plane.  The
// block copies the plane's K and V into shared memory once, with cp.async
// in two groups, so V's copy overlaps the first pass-1 products.  Warps then
// walk the plane's 16-row query tiles (ceil16(N) / 16 of them, 17 at
// N = 257, spread over 6 warps in 3 rounds), Q's A fragments loaded from
// device memory straight into registers; a warp whose rows lie past N does
// no work, so the ragged 257th row costs one 16-row tile, not a 64-row
// block, and each plane's K and V cross device memory once, not once per
// 64-query block.  Neither pass has a barrier: both read only the resident
// K and V.  Products are mma.sync m16n8k16 (bf16 in, f32 accumulate); the
// f32 score fragments are laid out as the A operand of P.V, so the
// normalised P is rounded and fed from registers.  What bounds it is
// latency: each score passes a dependent chain of products, exp and
// multiply, so the design buys warps.  K and V sit unpadded, their 16-byte
// chunks XOR-swizzled by row (attention_plane.cuh: fragment loads without
// bank conflicts at 69.6 KB a plane instead of 78.3 at N = 257), so three
// blocks of 6 warps share an SM at hd <= 64 (at most 96 registers a
// thread; pass 2 walks 32-key chunks to stay inside them).  Fragments
// come through ldmatrix (attention_plane.cuh).  Measured at the flagship's
// served shape: 0.22 ms against the 0.06 ms bound and SDPA's 0.17 (NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md).
//
// bf16, tiled path (planes that do not fit): one block of 4 warps per
// (batch * head, 64-row query tile), K and V walked in 64-key tiles through
// shared memory with synchronous loads; the same pass-1 update, so it saves
// the same statistics.
//
// f32: the tiled scheme with plain FMAs, 256 threads, each owning a 4 x 4
// block of the 64 x 64 score tile (rows ty + 16 i, keys tx + 16 j) and
// 4 x hd/16 outputs; rows of the f32 tiles padded by one float.
//
// Not yet: wgmma, 32-row warp tiles (registers), one pass over the scores
// held in registers at N <= 272.

#include "attention_plane.cuh"

namespace {

using namespace irw;

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile

// ------------------------------------------------------------------------
// bf16, tiled path: mma.sync, one block per (plane, 64-row query tile)
// ------------------------------------------------------------------------

// rows row0 + g and row0 + g + 8 of a warp's m, l into the (2, planes, n)
// statistics tensor, from the lanes with t = 0
__device__ __forceinline__ void write_stats(float* stats, int bh, int planes, int n, int row0,
                                            const float (&m)[2], const float (&l)[2]) {
    const int lane = threadIdx.x % 32, g = lane >> 2;
    if ((lane & 3) != 0) return;
    const long long plane = static_cast<long long>(planes) * n;
    float* st = stats + static_cast<long long>(bh) * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < n) {
            st[row] = m[r];
            st[plane + row] = l[r];
        }
    }
}

// acc (16 x HD) += bf16(P) . V for the 16 keys kk * 16 .. + 15 of a score
// chunk s: P = exp(s - m) / l (rl = 1 / l), rounded to bf16, fed from
// registers; V rows at sV (padded, chunk-relative) through ldmatrix.trans
template <int HD, int COLS>
__device__ __forceinline__ void pv_step(float (&acc)[HD / 8][4], const float (&s)[COLS / 8][4],
                                        const float (&m)[2], const float (&rl)[2],
                                        const __nv_bfloat16* sV, int kk) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32;
    uint32_t pa[4];
    const float ml2[2] = {__fmul_rn(m[0], kLog2e), __fmul_rn(m[1], kLog2e)};
    pa[0] = pack_bf16(prob_score(s[2 * kk][0], ml2[0], rl[0]),
                      prob_score(s[2 * kk][1], ml2[0], rl[0]));
    pa[1] = pack_bf16(prob_score(s[2 * kk][2], ml2[1], rl[1]),
                      prob_score(s[2 * kk][3], ml2[1], rl[1]));
    pa[2] = pack_bf16(prob_score(s[2 * kk + 1][0], ml2[0], rl[0]),
                      prob_score(s[2 * kk + 1][1], ml2[0], rl[0]));
    pa[3] = pack_bf16(prob_score(s[2 * kk + 1][2], ml2[1], rl[1]),
                      prob_score(s[2 * kk + 1][3], ml2[1], rl[1]));
    // V rows kk*16 .. +15: lanes 0-7 / 8-15 address the two 8-key halves
    // of head-dim tile jn, lanes 16-31 the same for tile jn + 1
    const int mat = lane >> 3;
    const __nv_bfloat16* vr = sV + (kk * 16 + (lane & 7) + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
#pragma unroll
    for (int jn = 0; jn < HD / 8; jn += 2) {
        uint32_t vfrag[4];
        ldmatrix_x4_trans(vfrag, vr + jn * 8);
        mma_bf16(acc[jn], pa, vfrag[0], vfrag[1]);
        mma_bf16(acc[jn + 1], pa, vfrag[2], vfrag[3]);
    }
}

constexpr int kWarps = 4;                       // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;

// at most 128 registers a thread for hd <= 64, so four blocks share an SM
// (133 uncapped left room for three; measured faster on the H100, PERF.md)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 64 ? 4 : 2)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ stats, int n, int heads, float scale, Strides sq,
                          Strides sk, Strides sv, Strides so) {
    constexpr int kLd = HD + kTilePad;
    constexpr int kKS = HD / 16;   // k-steps over head_dim
    constexpr int kNT = HD / 8;    // n-tiles over head_dim
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // kBQ x kLd
    __nv_bfloat16* sK = sQ + kBQ * kLd;                                 // kBK x kLd
    __nv_bfloat16* sV = sK + kBK * kLd;                                 // kBK x kLd

    const int bh = blockIdx.x;
    const int b = bh / heads, h = bh % heads;
    const int q0 = blockIdx.y * kBQ;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

    load_tile_bf16<HD, kBQ, kMmaThreads>(sQ, q + b * sq.b + h * sq.h, sq.n, q0, n);
    __syncthreads();
    uint32_t qa[kKS][4];
    {
        const __nv_bfloat16* qr = sQ + (warp * 16 + g) * kLd + t * 2;
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
            qa[ks][0] = ld32(qr + ks * 16);
            qa[ks][1] = ld32(qr + 8 * kLd + ks * 16);
            qa[ks][2] = ld32(qr + ks * 16 + 8);
            qa[ks][3] = ld32(qr + 8 * kLd + ks * 16 + 8);
        }
    }

    // pass 1: max and sum of exp(s - max) for rows g (index 0) and g + 8 (index 1)
    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
    const int ntiles = (n + kBK - 1) / kBK;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int k0 = tile * kBK;
        __syncthreads();  // readers of the previous tile are done
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, sk.n, k0, n);
        __syncthreads();
        float s[kBK / 8][4];
        score_tile_bf16<HD, kBK>(qa, sK, scale, k0, n, s);
        online_stats<kBK>(m, l, s);
    }
    if (stats) write_stats(stats, bh, gridDim.x, n, q0 + warp * 16, m, l);
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

    // pass 2: P = exp(s - max) / sum rounded to bf16, P.V accumulated in f32
    float acc[kNT][4];
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int k0 = tile * kBK;
        __syncthreads();
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, sk.n, k0, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sV, vb, sv.n, k0, n);
        __syncthreads();
        float s[kBK / 8][4];
        score_tile_bf16<HD, kBK>(qa, sK, scale, k0, n, s);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) pv_step<HD, kBK>(acc, s, m, rl, sV, kk);
    }

    warp_store_bf16<HD>(o + b * so.b + h * so.h, so.n, acc, q0 + warp * 16, n);
}

// ------------------------------------------------------------------------
// bf16, plane path: one block per (batch * head) plane, K and V resident
// ------------------------------------------------------------------------

constexpr int kPlaneMaxWarps = 6;

// warps of a plane block: the fewest rounds of at most kPlaneMaxWarps warps
// over the plane's 16-row query tiles, then as few warps as those rounds need
__host__ __device__ constexpr int plane_warps(int tiles) {
    return (tiles + (tiles + kPlaneMaxWarps - 1) / kPlaneMaxWarps - 1)
           / ((tiles + kPlaneMaxWarps - 1) / kPlaneMaxWarps);
}

// three blocks an SM at hd <= 64 (18 warps: at most 96 registers a thread)
template <int HD>
__global__ void __launch_bounds__(32 * kPlaneMaxWarps, HD <= 64 ? 3 : 1)
attention_fwd_plane_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                                float* __restrict__ stats, int n, int heads, float scale,
                                Strides sq, Strides sk, Strides sv, Strides so) {
    constexpr int kKS = HD / 16, kNT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nk = round_up(n, 16);
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // nk x HD, swizzled
    __nv_bfloat16* sV = sK + nk * HD;                                   // nk x HD, swizzled

    const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
    const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
    load_rows_async_swz<HD>(sK, k + b * sk.b + h * sk.h, sk.n, nk, n);
    cp_async_commit();
    load_rows_async_swz<HD>(sV, v + b * sv.b + h * sv.h, sv.n, nk, n);
    cp_async_commit();

    const int tiles = nk / 16;
    uint32_t qa[kKS][4];
    float m[2], l[2];
    // pass 1 of one query tile: the row statistics over the resident K, in
    // the 64-key chunks every kernel uses for them
    auto pass1 = [&](int tile) {
        load_a_global<HD>(qa, qb, sq.n, tile * 16, n);
        m[0] = m[1] = neg_inf();
        l[0] = l[1] = 0.f;
        for_key_chunks<64>(n, [&](auto cols, int k0) {
            constexpr int C = decltype(cols)::value;
            float s[C / 8][4];
            dot_tile_swz<HD, C>(qa, sK + k0 * HD, s);
            scale_mask<C>(s, scale, k0, n);
            online_stats<C>(m, l, s);
        });
        if (stats) write_stats(stats, bh, gridDim.x, n, tile * 16, m, l);
    };
    // pass 2: P rounded to bf16, P.V accumulated in f32, o written; 32-key
    // chunks keep the live scores to 16 registers
    auto pass2 = [&](int tile) {
        const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
        const float ml2[2] = {__fmul_rn(m[0], kLog2e), __fmul_rn(m[1], kLog2e)};
        const float sl2 = __fmul_rn(scale, kLog2e);
        float acc[kNT][4];
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
        for_key_chunks<32>(n, [&](auto cols, int k0) {
            constexpr int C = decltype(cols)::value;
            float d[C / 8][4];
            dot_tile_swz<HD, C>(qa, sK + k0 * HD, d);
            mask_dots<C>(d, k0, n);
#pragma unroll
            for (int kk = 0; kk < C / 16; ++kk)
                pv_step_swz<HD, C>(acc, d, sl2, ml2, rl, sV + k0 * HD, kk);
        });
        warp_store_bf16<HD>(o + b * so.b + h * so.h, so.n, acc, tile * 16, n);
    };

    // every warp has a first tile (plane_warps <= tiles): its pass 1 runs
    // while V is still being copied
    cp_async_wait<1>();
    __syncthreads();
    pass1(warp);
    cp_async_wait<0>();
    __syncthreads();
    pass2(warp);
    for (int tile = warp + nwarps; tile < tiles; tile += nwarps) {
        pass1(tile);
        pass2(tile);
    }
}

// ------------------------------------------------------------------------
// f32: plain FMA path
// ------------------------------------------------------------------------

constexpr int kRows = kBQ / kFmaSide;  // query rows per thread
constexpr int kCols = kBK / kFmaSide;  // keys per thread
constexpr int kLdP = kBK + 1;

// s[i][j] = scale * <q row ty+16i, k row tx+16j>, -inf for keys past n
template <int HD>
__device__ __forceinline__ void score_tile(const float* sQ, const float* sK, float scale,
                                           int k0, int n, float (&s)[kRows][kCols]) {
    const int tx = threadIdx.x % kFmaSide;
    fma_dot_f32<HD, kBQ, kBK>(sQ, sK, s);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
        const bool valid = k0 + tx + kFmaSide * j < n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = valid ? s[i][j] * scale : neg_inf();
    }
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ stats, int n, int heads, float scale, Strides sq,
                         Strides sk, Strides sv, Strides so) {
    constexpr int ld = HD + 1;
    constexpr int kOut = HD / kFmaSide;  // output columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;               // kBQ x ld
    float* sK = sQ + kBQ * ld;      // kBK x ld
    float* sV = sK + kBK * ld;      // kBK x ld
    float* sP = sV + kBK * ld;      // kBQ x kLdP

    const int bh = blockIdx.x;
    const int b = bh / heads, h = bh % heads;
    const int q0 = blockIdx.y * kBQ;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;
    float* ob = o + b * so.b + h * so.h;

    load_tile_f32<HD, kBQ>(sQ, qb, sq.n, q0, n);

    // pass 1: row max and sum of exp(s - max), f32
    float m[kRows], l[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) { m[i] = neg_inf(); l[i] = 0.f; }
    const int ntiles = (n + kBK - 1) / kBK;
    for (int t = 0; t < ntiles; ++t) {
        const int k0 = t * kBK;
        __syncthreads();  // readers of the previous tile are done
        load_tile_f32<HD, kBK>(sK, kb, sk.n, k0, n);
        __syncthreads();
        float s[kRows][kCols];
        score_tile<HD>(sQ, sK, scale, k0, n, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i) online_stats_f32<kCols>(m[i], l[i], s[i]);
    }
    float rl[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) rl[i] = __frcp_rn(l[i]);
    if (stats && tx == 0) {
        const long long plane = static_cast<long long>(gridDim.x) * n;
        float* st = stats + static_cast<long long>(bh) * n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int row = q0 + ty + kFmaSide * i;
            if (row < n) {
                st[row] = m[i];
                st[plane + row] = l[i];
            }
        }
    }

    // pass 2: normalised P (f32 needs no rounding), P.V accumulated in f32
    float acc[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
        const int k0 = t * kBK;
        __syncthreads();
        load_tile_f32<HD, kBK>(sK, kb, sk.n, k0, n);
        load_tile_f32<HD, kBK>(sV, vb, sv.n, k0, n);
        __syncthreads();
        float s[kRows][kCols];
        score_tile<HD>(sQ, sK, scale, k0, n, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                sP[(ty + kFmaSide * i) * kLdP + tx + kFmaSide * j] = prob(s[i][j], m[i], rl[i]);
        __syncthreads();
        fma_accumulate_f32<HD, kBK, kBQ>(acc, sP, kLdP, sV);
    }
    fma_store_f32<HD, kBQ>(ob, so.n, acc, q0, n);
}

// ------------------------------------------------------------------------
// launch
// ------------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

size_t plane_smem(int n, int hd) { return sizeof(__nv_bfloat16) * 2 * round_up(n, 16) * hd; }

// 1: the plane path, 0: the tiled path
int variant(int dtype, int n, int hd) { return dtype == 1 && plane_smem(n, hd) <= kMaxSmem; }

struct Launch {
    const void *q, *k, *v;
    void* o;
    float* stats;
    int batch, n, heads;
    float scale;
    Strides sq, sk, sv, so;
};

template <typename T, int HD>
int launch(const Launch& a, cudaStream_t stream) {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    T* o = static_cast<T*>(a.o);
    size_t smem;
    int threads;
    dim3 grid;
    void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, float, Strides, Strides,
                   Strides, Strides);
    if constexpr (sizeof(T) == 2) {
        if (variant(1, a.n, HD)) {
            kernel = attention_fwd_plane_bf16_kernel<HD>;
            smem = plane_smem(a.n, HD);
            threads = 32 * plane_warps(round_up(a.n, 16) / 16);
            grid = dim3(a.batch * a.heads);
        } else {
            kernel = attention_fwd_bf16_kernel<HD>;
            smem = sizeof(__nv_bfloat16) * 3 * kBK * (HD + kTilePad);
            threads = kMmaThreads;
            grid = dim3(a.batch * a.heads, (a.n + kBQ - 1) / kBQ);
        }
    } else {
        constexpr int ld = HD + 1;
        kernel = attention_fwd_f32_kernel<HD>;
        smem = sizeof(float) * (kBQ * ld + 2 * kBK * ld + kBQ * kLdP);
        threads = kFmaThreads;
        grid = dim3(a.batch * a.heads, (a.n + kBQ - 1) / kBQ);
    }
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, stream>>>(q, k, v, o, a.stats, a.n, a.heads, a.scale, a.sq, a.sk,
                                            a.sv, a.so);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const Launch& a, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(a, stream);
        case 64: return launch<T, 64>(a, stream);
        case 128: return launch<T, 128>(a, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, token,
// head) for each of q, k, v, o; the head_dim axis must be contiguous.  For
// bf16 every row start must be 16-byte aligned (strides multiples of 8).
// ``stats``: null, or an f32 (2, batch * heads, n) tensor that receives each
// row's max m and sum l of exp(s - m).  One kernel runs on ``stream``.
extern "C" int irw_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* stats, int dtype, int batch, int n, int heads, int hd,
                                 float scale,
                                 long long qsb, long long qsn, long long qsh,
                                 long long ksb, long long ksn, long long ksh,
                                 long long vsb, long long vsn, long long vsh,
                                 long long osb, long long osn, long long osh,
                                 void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Launch a{q, k, v, o, static_cast<float*>(stats), batch, n, heads, scale,
                   Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
                   Strides{osb, osn, osh}};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_hd<float>(hd, a, st);
    if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// which kernel irw_attention_fwd runs for (dtype, n, hd): 1 the plane path,
// 0 the tiled path
extern "C" int irw_attention_fwd_variant(int dtype, int n, int hd) { return variant(dtype, n, hd); }

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
