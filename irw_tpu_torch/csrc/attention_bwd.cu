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
using bf16 = __nv_bfloat16;

// kernel 1: row statistics and dq for one 64-query tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_bf16_kernel(Args a) {
    constexpr int kLd = HD + kTilePad;
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

    load_tile_bf16<HD, kBK, kMmaThreads>(
        sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, q0, n);
    load_tile_bf16<HD, kBK, kMmaThreads>(
        sG, static_cast<const bf16*>(a.g) + b * a.sg.b + h * a.sg.h, a.sg.n, q0, n);
    const bf16* wQ = sQ + warp * 16 * kLd;
    const bf16* wG = sG + warp * 16 * kLd;
    const int ntiles = (n + kBK - 1) / kBK;

    // scores of one key tile, scaled, keys past n at -inf
    auto scores = [&](int k0, float (&s)[kBK / 8][4]) {
        warp_dot_bf16<HD, kBK>(wQ, sK, s);
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
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, a.sk.n, tile * kBK, n);
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
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, a.sk.n, tile * kBK, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sV, vb, a.sv.n, tile * kBK, n);
        __syncthreads();
        scores(tile * kBK, s);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
        warp_dot_bf16<HD, kBK>(wG, sV, dp);
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
        warp_accumulate_bf16<HD, kBK>(acc, dp, sK);
    }

    const int row0 = q0 + warp * 16;
    warp_store_bf16<HD>(
        static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, row0, n);
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
    constexpr int kLd = HD + kTilePad;
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

    load_tile_bf16<HD, kBK, kMmaThreads>(
        sK, static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n, k0, n);
    load_tile_bf16<HD, kBK, kMmaThreads>(
        sV, static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n, k0, n);
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
        load_tile_bf16<HD, kBK, kMmaThreads>(sQ, qb, a.sq.n, q0, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sG, gb, a.sg.n, q0, n);
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
        warp_dot_bf16<HD, kBK>(wK, sQ, p);
        warp_dot_bf16<HD, kBK>(wV, sG, ds);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = j * 8 + t * 2 + (e & 1);
                p[j][e] = expf(p[j][e] * a.scale - sM[col]) / sL[col];
                ds[j][e] = p[j][e] * (ds[j][e] - sT[col]) * a.scale;
            }
        warp_accumulate_bf16<HD, kBK>(dv, p, sG);
        warp_accumulate_bf16<HD, kBK>(dk, ds, sQ);
    }

    const int row0 = k0 + warp * 16;
    warp_store_bf16<HD>(static_cast<bf16*>(a.dk) + b * a.sdk.b + h * a.sdk.h, a.sdk.n, dk, row0, n);
    warp_store_bf16<HD>(static_cast<bf16*>(a.dv) + b * a.sdv.b + h * a.sdv.h, a.sdv.n, dv, row0, n);
}

// ------------------------------------------------------------------------
// f32: plain FMA path
// ------------------------------------------------------------------------

constexpr int kRows = kBQ / kFmaSide;  // tile rows per thread
constexpr int kCols = kBK / kFmaSide;  // tile columns per thread
constexpr int kLdP = kBK + 1;

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
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
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
    const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;

    load_tile_f32<HD, kBK>(
        sQ, static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, q0, n);
    load_tile_f32<HD, kBK>(
        sG, static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h, a.sg.n, q0, n);
    const int ntiles = (n + kBK - 1) / kBK;

    auto scores = [&](int k0, float (&s)[kRows][kCols]) {
        fma_dot_f32<HD, kBK, kBK>(sQ, sK, s);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            const bool valid = k0 + tx + kFmaSide * j < n;
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
        load_tile_f32<HD, kBK>(sK, kb, a.sk.n, tile * kBK, n);
        __syncthreads();
        float s[kRows][kCols];
        scores(tile * kBK, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            float tmax = s[i][0];
#pragma unroll
            for (int j = 1; j < kCols; ++j) tmax = fmaxf(tmax, s[i][j]);
            const float mnew = fmaxf(m[i], row16_max(tmax));
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) part += expf(s[i][j] - mnew);
            l[i] = l[i] * expf(m[i] - mnew) + row16_sum(part);
            m[i] = mnew;
        }
    }

    auto probs_and_dp = [&](int tile, float (&s)[kRows][kCols], float (&dp)[kRows][kCols]) {
        __syncthreads();
        load_tile_f32<HD, kBK>(sK, kb, a.sk.n, tile * kBK, n);
        load_tile_f32<HD, kBK>(sV, vb, a.sv.n, tile * kBK, n);
        __syncthreads();
        scores(tile * kBK, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = expf(s[i][j] - m[i]) / l[i];
        fma_dot_f32<HD, kBK, kBK>(sG, sV, dp);
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
            tr[i] += row16_sum(part);
        }
    }

    // pass 3: ds = p (dp - t) scale into shared memory; dq = ds k
    float acc[kRows][HD / kFmaSide];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < HD / kFmaSide; ++c) acc[i][c] = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
        float p[kRows][kCols], dp[kRows][kCols];
        probs_and_dp(tile, p, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                sP[(ty + kFmaSide * i) * kLdP + tx + kFmaSide * j] =
                    p[i][j] * (dp[i][j] - tr[i]) * a.scale;
        __syncthreads();
        fma_accumulate_f32<HD, kBK, kBQ>(acc, sP, kLdP, sK);
    }

    fma_store_f32<HD, kBK>(
        static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, q0, n);
    if (tx == 0) {
        const long long plane = static_cast<long long>(a.bh_total) * n;
        float* st = a.stats + static_cast<long long>(bh) * n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int row = q0 + ty + kFmaSide * i;
            if (row < n) {
                st[row] = m[i];
                st[plane + row] = l[i];
                st[2 * plane + row] = tr[i];
            }
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
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
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
    const float* gb = static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h;
    const long long plane = static_cast<long long>(a.bh_total) * n;
    const float* st = a.stats + static_cast<long long>(bh) * n;

    load_tile_f32<HD, kBK>(
        sK, static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n, k0, n);
    load_tile_f32<HD, kBK>(
        sV, static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n, k0, n);

    float dk[kRows][HD / kFmaSide], dv[kRows][HD / kFmaSide];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < HD / kFmaSide; ++c) dk[i][c] = dv[i][c] = 0.f;

    const int ntiles = (n + kBQ - 1) / kBQ;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kBQ;
        __syncthreads();
        load_tile_f32<HD, kBK>(sQ, qb, a.sq.n, q0, n);
        load_tile_f32<HD, kBK>(sG, gb, a.sg.n, q0, n);
        for (int i = threadIdx.x; i < kBQ; i += kFmaThreads) {
            const int row = q0 + i;
            const bool valid = row < n;
            sM[i] = valid ? st[row] : pos_inf();  // padded queries: p = 0
            sL[i] = valid ? st[plane + row] : 1.f;
            sT[i] = valid ? st[2 * plane + row] : 0.f;
        }
        __syncthreads();
        // s^T and dp^T: rows are keys ty + 16 i, columns queries tx + 16 j
        float s[kRows][kCols], dp[kRows][kCols];
        fma_dot_f32<HD, kBK, kBK>(sK, sQ, s);
        fma_dot_f32<HD, kBK, kBK>(sV, sG, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int col = tx + kFmaSide * j;
                const float p = expf(s[i][j] * a.scale - sM[col]) / sL[col];
                sP[(ty + kFmaSide * i) * kLdP + col] = p;
                sD[(ty + kFmaSide * i) * kLdP + col] = p * (dp[i][j] - sT[col]) * a.scale;
            }
        __syncthreads();
        fma_accumulate_f32<HD, kBK, kBQ>(dv, sP, kLdP, sG);
        fma_accumulate_f32<HD, kBK, kBQ>(dk, sD, kLdP, sQ);
    }

    fma_store_f32<HD, kBK>(
        static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h, a.sdk.n, dk, k0, n);
    fma_store_f32<HD, kBK>(
        static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h, a.sdv.n, dv, k0, n);
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
        const size_t tiles = sizeof(bf16) * 4 * kBK * (HD + kTilePad);
        err = launch_one(attention_bwd_dq_bf16_kernel<HD>, grid, kMmaThreads, tiles, a, stream);
        if (err != 0) return err;
        return launch_one(attention_bwd_dkdv_bf16_kernel<HD>, grid, kMmaThreads,
                          tiles + sizeof(float) * 3 * kBQ, a, stream);
    } else {
        const size_t tiles = sizeof(float) * 4 * kBK * (HD + 1);
        err = launch_one(attention_bwd_dq_f32_kernel<HD>, grid, kFmaThreads,
                         tiles + sizeof(float) * kBQ * kLdP, a, stream);
        if (err != 0) return err;
        return launch_one(attention_bwd_dkdv_f32_kernel<HD>, grid, kFmaThreads,
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
