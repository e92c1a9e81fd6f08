// Fused multi-head attention backward for short sequences: given
// o = softmax(q k^T * scale) v and the output gradient g, compute
//   dq, dk, dv   per (batch, head),
// all seven tensors in the public layout (B, N, H, hd), read and written
// through element strides (the last axis contiguous), bf16 or f32.
//
// Replaces: irw_tpu/ops/vmem_attention.py, _bwd_call (kernel body
// _bwd_kernel).  Same math and rounding points as the TPU kernel, which
// recomputes P instead of saving it:
//   s  = (q k^T) * scale                     f32
//   p  = softmax(s), max subtracted, normalised, f32
//   dv = bf16(p)^T g                         f32 accumulate
//   dp = g v^T                               f32
//   t  = rowsum(dp * p)                      f32, with the f32 p (not
//        FlashAttention-2's rowsum(dO * O), which reads the rounded output)
//   ds = bf16(p * (dp - t) * scale)
//   dq = ds k,  dk = ds^T q                  f32 accumulate, cast at the end
//
// Bound on the H100 at the flagship training shape (B = 4 bands * 96 = 384,
// N = 257, H = 6, hd = 64, bf16): memory.  q, k, v, g read and dq, dk, dv
// written are 7 * 75.8 MB = 530 MB, 0.158 ms at 3.35 TB/s; the five
// products, 10 B H N^2 hd = 97 GFLOP, take 0.098 ms at the 989 TFLOP/s
// bf16 tensor-core peak.
//
// Design.  On the TPU one grid step held a whole (N, N) plane in VMEM and
// ran the five products in order.  A Hopper block has 227 KB of shared
// memory, blocks run in no order, and dq sums over keys while dk and dv sum
// over queries, so the work is split into two kernels, each of which owns
// the rows it writes and needs no atomics:
// - kernel 1, one block per (batch * head, 64-query tile): three passes
//   over the key tiles.  Pass 1: each row's max m and sum l (as K2).
//   Pass 2: t = sum_j dp * p.  Pass 3: ds, and dq = ds k accumulated in
//   registers.  It writes dq and the row statistics (m, l, t) to an f32
//   workspace of 3 B H N floats.
// - kernel 2, one block per (batch * head, 64-key tile): one pass over the
//   query tiles, recomputing s^T = k q^T and dp^T = v g^T, then p and ds
//   from the saved (m, l, t), and accumulating dv = p^T g and dk = ds^T q
//   in registers.
// The ragged tail (257 = 4 * 64 + 1) is zero-filled in shared memory;
// padded keys are masked to -inf in kernel 1, padded queries get m = +inf
// (so p = 0) in kernel 2, and neither is written.
//
// bf16 (the flagship): tensor cores through mma.sync m16n8k16, 4 warps of
// 16 rows (queries in kernel 1, keys in kernel 2); A fragments are read
// from shared memory (rows padded by 16 bytes against bank conflicts), the
// f32 score fragments are rounded to bf16 and fed back as the A operand of
// the next product, and the B operands of the transposed products come
// through ldmatrix.trans, as in K2.
// f32: plain FMAs, 256 threads each owning a 4 x 4 block of the 64 x 64
// tile, as in K2's f32 path.
//
// Not yet: wgmma, TMA, pipelined tile loads, one kernel instead of two.

#include "attention_common.cuh"

namespace {

using namespace irw;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
static_assert(kBQ == kBK, "the tile loaders stage 64 rows of either");

struct Args {
    const void *q, *k, *v, *g;
    void *dq, *dk, *dv;
    float* stats;  // (3, batch * heads, n): row max, row sum, rowsum(dp * p)
    int n, heads, bh_total;
    float scale;
    Strides sq, sk, sv, sg, sdq, sdk, sdv;
};

// ------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kPad = 8;  // bf16 elements (16 bytes) per row

using bf16 = __nv_bfloat16;

// 64 rows of hd bf16 from global (16-byte loads) into a padded smem tile;
// rows at or past n are zero
template <int HD>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src, long long row_stride,
                                               int row0, int n) {
    constexpr int kVec = 8, kPerRow = HD / kVec, kLd = HD + kPad;
    for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kMmaThreads) {
        const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
        const int row = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < n) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    }
}

// d[j] = A . B^T for this warp: A is the warp's 16 rows at sA, B the 64 rows
// of sB; d[j] is the m16n8 fragment of B rows 8 j .. 8 j + 7 (rows g and
// g + 8 of the warp's slice, columns 2 t and 2 t + 1 of the n-tile)
template <int HD>
__device__ __forceinline__ void dot_tile(const bf16* sA, const bf16* sB, float (&d)[kBK / 8][4]) {
    constexpr int kLd = HD + kPad;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    const bf16* ar = sA + g * kLd + t * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t a[4] = {ld32(ar + ks * 16), ld32(ar + 8 * kLd + ks * 16),
                               ld32(ar + ks * 16 + 8), ld32(ar + 8 * kLd + ks * 16 + 8)};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
            const bf16* br = sB + (j * 8 + g) * kLd + ks * 16 + t * 2;
            mma_bf16(d[j], a, ld32(br), ld32(br + 8));
        }
    }
}

// acc (16 x HD per warp) += X . R where X (16 x 64) is given as m16n8
// fragments x[8][4] (rounded to bf16 here) and R is the 64 x HD smem tile sR
template <int HD>
__device__ __forceinline__ void accumulate_xr(float (&acc)[HD / 8][4], const float (&x)[kBK / 8][4],
                                              const bf16* sR) {
    constexpr int kLd = HD + kPad;
    const int lane = threadIdx.x % 32, mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                                pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                                pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                                pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
        // R rows kk*16 .. +15: lanes 0-7 / 8-15 address the two 8-row halves
        // of column tile jn, lanes 16-31 the same for tile jn + 1
        const bf16* rr = sR + (kk * 16 + (lane & 7) + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
#pragma unroll
        for (int jn = 0; jn < HD / 8; jn += 2) {
            uint32_t rf[4];
            ldmatrix_x4_trans(rf, rr + jn * 8);
            mma_bf16(acc[jn], xa, rf[0], rf[1]);
            mma_bf16(acc[jn + 1], xa, rf[2], rf[3]);
        }
    }
}

// store this warp's 16 x HD f32 accumulator as bf16 rows row0 + g, row0 + g + 8
template <int HD>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long long row_stride,
                                                const float (&acc)[HD / 8][4], int row0, int n) {
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int row = row0 + g;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
        const int col = jn * 8 + t * 2;
        if (row < n)
            *reinterpret_cast<uint32_t*>(dst + row * row_stride + col) =
                pack_bf16(acc[jn][0], acc[jn][1]);
        if (row + 8 < n)
            *reinterpret_cast<uint32_t*>(dst + (row + 8) * row_stride + col) =
                pack_bf16(acc[jn][2], acc[jn][3]);
    }
}

// kernel 1: row statistics and dq for one 64-query tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_bf16_kernel(Args a) {
    constexpr int kLd = HD + kPad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBQ x kLd
    bf16* sG = sQ + kBQ * kLd;                      // kBQ x kLd
    bf16* sK = sG + kBQ * kLd;                      // kBK x kLd
    bf16* sV = sK + kBK * kLd;                      // kBK x kLd

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
    const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;

    load_rows_bf16<HD>(sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, q0, n);
    load_rows_bf16<HD>(sG, static_cast<const bf16*>(a.g) + b * a.sg.b + h * a.sg.h, a.sg.n, q0, n);
    const bf16* wQ = sQ + warp * 16 * kLd;
    const bf16* wG = sG + warp * 16 * kLd;
    const int ntiles = (n + kBK - 1) / kBK;

    // scores of one key tile, scaled, keys past n at -inf
    auto scores = [&](int k0, float (&s)[kBK / 8][4]) {
        dot_tile<HD>(wQ, sK, s);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
            const int key = k0 + j * 8 + t * 2;
            s[j][0] = key < n ? s[j][0] * a.scale : neg_inf();
            s[j][1] = key + 1 < n ? s[j][1] * a.scale : neg_inf();
            s[j][2] = key < n ? s[j][2] * a.scale : neg_inf();
            s[j][3] = key + 1 < n ? s[j][3] * a.scale : neg_inf();
        }
    };

    // pass 1: max and sum of exp(s - max) for rows g (index 0) and g + 8 (index 1)
    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
    for (int tile = 0; tile < ntiles; ++tile) {
        __syncthreads();  // readers of the previous tile are done
        load_rows_bf16<HD>(sK, kb, a.sk.n, tile * kBK, n);
        __syncthreads();
        float s[kBK / 8][4];
        scores(tile * kBK, s);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float tmax = neg_inf();
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
            const float mnew = fmaxf(m[r], quad_max(tmax));
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
                part += expf(s[j][2 * r] - mnew) + expf(s[j][2 * r + 1] - mnew);
            l[r] = l[r] * expf(m[r] - mnew) + quad_sum(part);
            m[r] = mnew;
        }
    }

    // p = exp(s - m) / l in place; dp = g v^T
    auto probs_and_dp = [&](int tile, float (&s)[kBK / 8][4], float (&dp)[kBK / 8][4]) {
        __syncthreads();
        load_rows_bf16<HD>(sK, kb, a.sk.n, tile * kBK, n);
        load_rows_bf16<HD>(sV, vb, a.sv.n, tile * kBK, n);
        __syncthreads();
        scores(tile * kBK, s);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
        dot_tile<HD>(wG, sV, dp);
    };

    // pass 2: t = rowsum(dp * p)
    float tr[2] = {0.f, 0.f};
    for (int tile = 0; tile < ntiles; ++tile) {
        float p[kBK / 8][4], dp[kBK / 8][4];
        probs_and_dp(tile, p, dp);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
                part += dp[j][2 * r] * p[j][2 * r] + dp[j][2 * r + 1] * p[j][2 * r + 1];
            tr[r] += quad_sum(part);
        }
    }

    // pass 3: ds = p (dp - t) scale, rounded to bf16; dq = ds k
    float acc[HD / 8][4];
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
        float p[kBK / 8][4], dp[kBK / 8][4];
        probs_and_dp(tile, p, dp);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - tr[e >> 1]) * a.scale;
        accumulate_xr<HD>(acc, dp, sK);
    }

    const int row0 = q0 + warp * 16;
    store_rows_bf16<HD>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, row0, n);
    if (t == 0) {
        const long long plane = static_cast<long long>(a.bh_total) * n;
        float* st = a.stats + static_cast<long long>(bh) * n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + g + 8 * r;
            if (row < n) {
                st[row] = m[r];
                st[plane + row] = l[r];
                st[2 * plane + row] = tr[r];
            }
        }
    }
}

// kernel 2: dk and dv for one 64-key tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_bf16_kernel(Args a) {
    constexpr int kLd = HD + kPad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kBK x kLd
    bf16* sV = sK + kBK * kLd;                      // kBK x kLd
    bf16* sQ = sV + kBK * kLd;                      // kBQ x kLd
    bf16* sG = sQ + kBQ * kLd;                      // kBQ x kLd
    float* sM = reinterpret_cast<float*>(sG + kBQ * kLd);  // kBQ each: m, l, t
    float* sL = sM + kBQ;
    float* sT = sL + kBQ;

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int k0 = blockIdx.y * kBK, n = a.n;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int t = lane & 3;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
    const bf16* gb = static_cast<const bf16*>(a.g) + b * a.sg.b + h * a.sg.h;
    const long long plane = static_cast<long long>(a.bh_total) * n;
    const float* st = a.stats + static_cast<long long>(bh) * n;

    load_rows_bf16<HD>(sK, static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n, k0, n);
    load_rows_bf16<HD>(sV, static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n, k0, n);
    const bf16* wK = sK + warp * 16 * kLd;
    const bf16* wV = sV + warp * 16 * kLd;

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[jn][e] = dv[jn][e] = 0.f;

    const int ntiles = (n + kBQ - 1) / kBQ;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kBQ;
        __syncthreads();  // readers of the previous tile are done
        load_rows_bf16<HD>(sQ, qb, a.sq.n, q0, n);
        load_rows_bf16<HD>(sG, gb, a.sg.n, q0, n);
        for (int i = threadIdx.x; i < kBQ; i += kMmaThreads) {
            const int row = q0 + i;
            const bool valid = row < n;
            sM[i] = valid ? st[row] : pos_inf();  // padded queries: p = 0
            sL[i] = valid ? st[plane + row] : 1.f;
            sT[i] = valid ? st[2 * plane + row] : 0.f;
        }
        __syncthreads();
        // s^T (this warp's 16 keys x 64 queries) and dp^T = v g^T
        float p[kBQ / 8][4], ds[kBQ / 8][4];
        dot_tile<HD>(wK, sQ, p);
        dot_tile<HD>(wV, sG, ds);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = j * 8 + t * 2 + (e & 1);
                p[j][e] = expf(p[j][e] * a.scale - sM[col]) / sL[col];
                ds[j][e] = p[j][e] * (ds[j][e] - sT[col]) * a.scale;
            }
        accumulate_xr<HD>(dv, p, sG);
        accumulate_xr<HD>(dk, ds, sQ);
    }

    const int row0 = k0 + warp * 16;
    store_rows_bf16<HD>(static_cast<bf16*>(a.dk) + b * a.sdk.b + h * a.sdk.h, a.sdk.n, dk, row0, n);
    store_rows_bf16<HD>(static_cast<bf16*>(a.dv) + b * a.sdv.b + h * a.sdv.h, a.sdv.n, dv, row0, n);
}

// ------------------------------------------------------------------------
// f32: plain FMA path
// ------------------------------------------------------------------------

constexpr int kTX = 16, kTY = 16;  // 256 threads
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;   // tile rows per thread
constexpr int kCols = kBK / kTX;   // tile columns per thread
constexpr int kLdP = kBK + 1;

// reduce over the 16 lanes that share a ty (a half warp)
__device__ __forceinline__ float half_warp_max(float v) {
    for (int off = kTX / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
    for (int off = kTX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int row0, int n) {
    constexpr int ld = HD + 1;
    for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
        const int r = idx / HD, d = idx % HD;
        const int row = row0 + r;
        dst[r * ld + d] = row < n ? src[row * row_stride + d] : 0.f;
    }
}

// d[i][j] = <A row ty + 16 i, B row tx + 16 j>
template <int HD>
__device__ __forceinline__ void dot_tile_f32(const float* sA, const float* sB,
                                             float (&d)[kRows][kCols]) {
    constexpr int ld = HD + 1;
    const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) d[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
        float av[kRows], bv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = sA[(ty + kTY * i) * ld + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) bv[j] = sB[(tx + kTX * j) * ld + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
    }
}

// acc[i][c] += sum_kk sX[ty + 16 i][kk] * sR[kk][tx + 16 c]
template <int HD>
__device__ __forceinline__ void accumulate_xr_f32(float (&acc)[kRows][HD / kTX], const float* sX,
                                                  const float* sR) {
    constexpr int ld = HD + 1;
    const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
        float rv[HD / kTX];
#pragma unroll
        for (int c = 0; c < HD / kTX; ++c) rv[c] = sR[kk * ld + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const float x = sX[(ty + kTY * i) * kLdP + kk];
#pragma unroll
            for (int c = 0; c < HD / kTX; ++c) acc[i][c] = fmaf(x, rv[c], acc[i][c]);
        }
    }
}

template <int HD>
__device__ __forceinline__ void store_tile(float* dst, long long row_stride,
                                           const float (&acc)[kRows][HD / kTX], int row0, int n) {
    const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = row0 + ty + kTY * i;
        if (row < n) {
#pragma unroll
            for (int c = 0; c < HD / kTX; ++c) dst[row * row_stride + tx + kTX * c] = acc[i][c];
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32_kernel(Args a) {
    constexpr int ld = HD + 1;
    extern __shared__ float smem[];
    float* sQ = smem;             // kBQ x ld
    float* sG = sQ + kBQ * ld;    // kBQ x ld
    float* sK = sG + kBQ * ld;    // kBK x ld
    float* sV = sK + kBK * ld;    // kBK x ld
    float* sP = sV + kBK * ld;    // kBQ x kLdP

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
    const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
    const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;

    load_tile<HD>(sQ, static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, q0, n);
    load_tile<HD>(sG, static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h, a.sg.n, q0, n);
    const int ntiles = (n + kBK - 1) / kBK;

    auto scores = [&](int k0, float (&s)[kRows][kCols]) {
        dot_tile_f32<HD>(sQ, sK, s);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            const bool valid = k0 + tx + kTX * j < n;
#pragma unroll
            for (int i = 0; i < kRows; ++i) s[i][j] = valid ? s[i][j] * a.scale : neg_inf();
        }
    };

    // pass 1: row max and sum of exp(s - max)
    float m[kRows], l[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) { m[i] = neg_inf(); l[i] = 0.f; }
    for (int tile = 0; tile < ntiles; ++tile) {
        __syncthreads();
        load_tile<HD>(sK, kb, a.sk.n, tile * kBK, n);
        __syncthreads();
        float s[kRows][kCols];
        scores(tile * kBK, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            float tmax = s[i][0];
#pragma unroll
            for (int j = 1; j < kCols; ++j) tmax = fmaxf(tmax, s[i][j]);
            const float mnew = fmaxf(m[i], half_warp_max(tmax));
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) part += expf(s[i][j] - mnew);
            l[i] = l[i] * expf(m[i] - mnew) + half_warp_sum(part);
            m[i] = mnew;
        }
    }

    auto probs_and_dp = [&](int tile, float (&s)[kRows][kCols], float (&dp)[kRows][kCols]) {
        __syncthreads();
        load_tile<HD>(sK, kb, a.sk.n, tile * kBK, n);
        load_tile<HD>(sV, vb, a.sv.n, tile * kBK, n);
        __syncthreads();
        scores(tile * kBK, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = expf(s[i][j] - m[i]) / l[i];
        dot_tile_f32<HD>(sG, sV, dp);
    };

    // pass 2: t = rowsum(dp * p)
    float tr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) tr[i] = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
        float p[kRows][kCols], dp[kRows][kCols];
        probs_and_dp(tile, p, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) part += dp[i][j] * p[i][j];
            tr[i] += half_warp_sum(part);
        }
    }

    // pass 3: ds = p (dp - t) scale into shared memory; dq = ds k
    float acc[kRows][HD / kTX];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < HD / kTX; ++c) acc[i][c] = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
        float p[kRows][kCols], dp[kRows][kCols];
        probs_and_dp(tile, p, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                sP[(ty + kTY * i) * kLdP + tx + kTX * j] = p[i][j] * (dp[i][j] - tr[i]) * a.scale;
        __syncthreads();
        accumulate_xr_f32<HD>(acc, sP, sK);
    }

    store_tile<HD>(static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, q0, n);
    if (tx == 0) {
        const long long plane = static_cast<long long>(a.bh_total) * n;
        float* st = a.stats + static_cast<long long>(bh) * n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int row = q0 + ty + kTY * i;
            if (row < n) {
                st[row] = m[i];
                st[plane + row] = l[i];
                st[2 * plane + row] = tr[i];
            }
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_f32_kernel(Args a) {
    constexpr int ld = HD + 1;
    extern __shared__ float smem[];
    float* sK = smem;              // kBK x ld
    float* sV = sK + kBK * ld;     // kBK x ld
    float* sQ = sV + kBK * ld;     // kBQ x ld
    float* sG = sQ + kBQ * ld;     // kBQ x ld
    float* sP = sG + kBQ * ld;     // kBK x kLdP: p^T
    float* sD = sP + kBK * kLdP;   // kBK x kLdP: ds^T
    float* sM = sD + kBK * kLdP;   // kBQ each: m, l, t
    float* sL = sM + kBQ;
    float* sT = sL + kBQ;

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int k0 = blockIdx.y * kBK, n = a.n;
    const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
    const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
    const float* gb = static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h;
    const long long plane = static_cast<long long>(a.bh_total) * n;
    const float* st = a.stats + static_cast<long long>(bh) * n;

    load_tile<HD>(sK, static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n, k0, n);
    load_tile<HD>(sV, static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n, k0, n);

    float dk[kRows][HD / kTX], dv[kRows][HD / kTX];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < HD / kTX; ++c) dk[i][c] = dv[i][c] = 0.f;

    const int ntiles = (n + kBQ - 1) / kBQ;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kBQ;
        __syncthreads();
        load_tile<HD>(sQ, qb, a.sq.n, q0, n);
        load_tile<HD>(sG, gb, a.sg.n, q0, n);
        for (int i = threadIdx.x; i < kBQ; i += kThreads) {
            const int row = q0 + i;
            const bool valid = row < n;
            sM[i] = valid ? st[row] : pos_inf();  // padded queries: p = 0
            sL[i] = valid ? st[plane + row] : 1.f;
            sT[i] = valid ? st[2 * plane + row] : 0.f;
        }
        __syncthreads();
        // s^T and dp^T: rows are keys ty + 16 i, columns queries tx + 16 j
        float s[kRows][kCols], dp[kRows][kCols];
        dot_tile_f32<HD>(sK, sQ, s);
        dot_tile_f32<HD>(sV, sG, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int col = tx + kTX * j;
                const float p = expf(s[i][j] * a.scale - sM[col]) / sL[col];
                sP[(ty + kTY * i) * kLdP + col] = p;
                sD[(ty + kTY * i) * kLdP + col] = p * (dp[i][j] - sT[col]) * a.scale;
            }
        __syncthreads();
        accumulate_xr_f32<HD>(dv, sP, sG);
        accumulate_xr_f32<HD>(dk, sD, sQ);
    }

    store_tile<HD>(static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h, a.sdk.n, dk, k0, n);
    store_tile<HD>(static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h, a.sdv.n, dv, k0, n);
}

// ------------------------------------------------------------------------
// launch
// ------------------------------------------------------------------------

template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a,
               cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
    const dim3 grid(a.bh_total, (a.n + kBQ - 1) / kBQ);
    int err;
    if constexpr (sizeof(T) == 2) {
        const size_t tiles = sizeof(bf16) * 4 * kBK * (HD + kPad);
        err = launch_one(attention_bwd_dq_bf16_kernel<HD>, grid, kMmaThreads, tiles, a, stream);
        if (err != 0) return err;
        return launch_one(attention_bwd_dkdv_bf16_kernel<HD>, grid, kMmaThreads,
                          tiles + sizeof(float) * 3 * kBQ, a, stream);
    } else {
        const size_t tiles = sizeof(float) * 4 * kBK * (HD + 1);
        err = launch_one(attention_bwd_dq_f32_kernel<HD>, grid, kThreads,
                         tiles + sizeof(float) * kBQ * kLdP, a, stream);
        if (err != 0) return err;
        return launch_one(attention_bwd_dkdv_f32_kernel<HD>, grid, kThreads,
                          tiles + sizeof(float) * (2 * kBK * kLdP + 3 * kBQ), a, stream);
    }
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(a, stream);
        case 64: return launch<T, 64>(a, stream);
        case 128: return launch<T, 128>(a, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, token,
// head) for each of q, k, v, g, dq, dk, dv; the head_dim axis must be
// contiguous, and for bf16 every row start 16-byte aligned.  ``stats`` is an
// f32 workspace of 3 * batch * heads * n floats.  Two kernels run, in order,
// on ``stream``.
extern "C" int irw_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                 void* dq, void* dk, void* dv, void* stats, int dtype,
                                 int batch, int n, int heads, int hd, float scale,
                                 long long qsb, long long qsn, long long qsh,
                                 long long ksb, long long ksn, long long ksh,
                                 long long vsb, long long vsn, long long vsh,
                                 long long gsb, long long gsn, long long gsh,
                                 long long dqsb, long long dqsn, long long dqsh,
                                 long long dksb, long long dksn, long long dksh,
                                 long long dvsb, long long dvsn, long long dvsh,
                                 void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, g, dq, dk, dv, static_cast<float*>(stats), n, heads, batch * heads,
                 scale,
                 Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
                 Strides{gsb, gsn, gsh}, Strides{dqsb, dqsn, dqsh}, Strides{dksb, dksn, dksh},
                 Strides{dvsb, dvsn, dvsh}};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_hd<float>(hd, a, st);
    if (dtype == 1) return dispatch_hd<bf16>(hd, a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
