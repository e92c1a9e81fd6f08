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
// The row statistics (max m, sum l of exp(s - m)) come from the forward
// (K2 writes them when autograd needs them) or, for a standalone call, are
// computed here by the same online update over the same 64-key chunks
// (attention_plane.cuh), so both give the same bits.
//
// Bound on the H100 at the flagship training shape (B = 4 bands * 96 = 384,
// N = 257, H = 6, hd = 64, bf16): memory.  q, k, v, g read and dq, dk, dv
// written are 7 * 75.8 MB = 530 MB, 0.158 ms at 3.35 TB/s; the five
// products, 10 B H N^2 hd = 97 GFLOP, take 0.098 ms at the 989 TFLOP/s
// bf16 tensor-core peak.
//
// bf16, plane path (the flagship; hd <= 64 and N <= 272): one block per
// (batch * head) plane, which owns the plane's dq, dk and dv, so nothing is
// reduced across blocks and no atomics are needed.  The block copies q, k,
// v, g of the plane into shared memory once with cp.async (k and q first,
// then v and g), 156 KB at the flagship, one block an SM, ceil16(N) / 16
// warps (17 at N = 257).  Then two passes, with one barrier between them
// and none inside either:
// - query-major, one 16-query tile per warp: m and l over the 64-key chunks
//   (q k^T) unless the forward saved them; t = sum_j dp * p (q k^T and
//   g v^T); then ds and dq = ds k (q k^T, g v^T, ds k), ds fed to the
//   product from registers, dq written;
// - key-major, one 16-key tile per warp over 16-query steps: s^T = k q^T
//   and dp^T = v g^T, p and ds in registers feed dv += bf16(p)^T g and
//   dk += ds^T q (A operands from registers, g and q through
//   ldmatrix.trans).
// Products per plane: 9 with saved statistics, 10 without, as many as the
// tiled path but with every operand read from device memory once (the
// bound's 530 MB plus m, l: 4.7 MB).  A first design ran 7 (dq from a
// shared slab of bf16 ds^T per 32-query step, written in the key-major
// pass); its two barriers a step, with only the warps holding a piece of
// dq busy between them, made it slower on the H100 than this one (1.84
// against 1.55 ms at the flagship shape, NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md).  What bounds it: latency, with 17 warps an SM at most 96
// registers each (p and ds are rounded to their bf16 A fragments before
// the dv and dk products, so the two f32 accumulators fit), every score
// through a dependent chain of products, exp and multiplies, each score's p
// formed three times.  As in K2, exp is the special-function unit's 2^x
// (ex2.approx), the division exp(s - m) / l a multiply by 1 / l rounded
// once per row, and fragments come through ldmatrix.  Measured at the
// flagship shape: 0.88 ms with the forward's statistics, 0.97 without,
// against SDPA's 0.79 ms backward (NVIDIA H100 80GB HBM3 at 700 W).
//
// bf16, tiled path (hd = 128, or N > 272): two kernels, each owning the
// rows it writes.  Kernel 1, one block per (batch * head, 64-query tile):
// the row statistics unless saved (pass 1, as K2), t (pass 2), then ds and
// dq = ds k (pass 3); it writes dq, m, l (when computed) and t to f32
// workspaces.  Kernel 2, one block per (batch * head, 64-key tile): one pass
// over the query tiles, recomputing s^T and dp^T, p and ds from the saved
// (m, l, t), accumulating dv and dk.  4 warps of 16 rows, tiles through
// shared memory with synchronous loads; padded keys are masked to -inf in
// kernel 1, padded queries get m = +inf (so p = 0) in kernel 2.
// f32: the tiled scheme with plain FMAs, 256 threads each owning a 4 x 4
// block of the 64 x 64 tile, as in K2's f32 path.
//
// Not yet: wgmma, 32-row warp tiles, a plane path for hd = 128 or longer N
// (two blocks a plane over a cluster's distributed shared memory), fewer
// products through a dq that needs no barrier.

#include "attention_plane.cuh"

namespace {

using namespace irw;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
static_assert(kBQ == kBK, "the tile loaders stage 64 rows of either");

struct Args {
    const void *q, *k, *v, *g;
    void *dq, *dk, *dv;
    float* ml;   // (2, batch * heads, n): row max, row sum; read when have_stats
    float* tw;   // (batch * heads, n): rowsum(dp * p), the tiled path's workspace
    int have_stats;
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

    // pass 1 (unless saved): max and sum of exp(s - max) for rows g (index
    // 0) and g + 8 (index 1)
    const long long plane = static_cast<long long>(a.bh_total) * n;
    float* ml = a.ml + static_cast<long long>(bh) * n;
    const int row0 = q0 + warp * 16;
    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
    if (a.have_stats) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // padded rows: any finite p, never stored
            const int row = row0 + g + 8 * r;
            m[r] = row < n ? ml[row] : 0.f;
            l[r] = row < n ? ml[plane + row] : 1.f;
        }
    } else {
        for (int tile = 0; tile < ntiles; ++tile) {
            __syncthreads();  // readers of the previous tile are done
            load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, a.sk.n, tile * kBK, n);
            __syncthreads();
            float s[kBK / 8][4];
            scores(tile * kBK, s);
            online_stats<kBK>(m, l, s);
        }
    }

    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    const float ml2[2] = {__fmul_rn(m[0], kLog2e), __fmul_rn(m[1], kLog2e)};

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
            for (int e = 0; e < 4; ++e) s[j][e] = prob_score(s[j][e], ml2[e >> 1], rl[e >> 1]);
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

    warp_store_bf16<HD>(
        static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, row0, n);
    if (t == 0) {
        float* tw = a.tw + static_cast<long long>(bh) * n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + g + 8 * r;
            if (row < n) {
                if (!a.have_stats) {
                    ml[row] = m[r];
                    ml[plane + row] = l[r];
                }
                tw[row] = tr[r];
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
    const float* ml = a.ml + static_cast<long long>(bh) * n;
    const float* tw = a.tw + static_cast<long long>(bh) * n;

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

    const float sl2 = __fmul_rn(a.scale, kLog2e);
    const int ntiles = (n + kBQ - 1) / kBQ;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kBQ;
        __syncthreads();  // readers of the previous tile are done
        load_tile_bf16<HD, kBK, kMmaThreads>(sQ, qb, a.sq.n, q0, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sG, gb, a.sg.n, q0, n);
        for (int i = threadIdx.x; i < kBQ; i += kMmaThreads) {
            const int row = q0 + i;
            const bool valid = row < n;
            sM[i] = valid ? __fmul_rn(ml[row], kLog2e) : pos_inf();  // m log2 e; padded: p = 0
            sL[i] = valid ? __frcp_rn(ml[plane + row]) : 1.f;  // 1 / l
            sT[i] = valid ? tw[row] : 0.f;
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
                p[j][e] = prob_dot(p[j][e], sl2, sM[col], sL[col]);
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
// bf16, plane path: one block per (batch * head) plane, q, k, v, g resident
// ------------------------------------------------------------------------

constexpr int kPlaneMaxKeys = 272;                 // 17 key tiles, one warp each
constexpr int kPlaneMaxWarps = kPlaneMaxKeys / 16;

size_t plane_smem(int n, int hd) {
    const int nk = round_up(n, 16);
    return sizeof(bf16) * 4 * nk * (hd + kTilePad) + sizeof(float) * 3 * nk;
}

// acc (16 x HD) += X . R for one k16 step: X's A fragments xa already
// rounded to bf16, R the 16 x HD rows of a padded tile at sR through
// ldmatrix.trans
template <int HD>
__device__ __forceinline__ void accumulate_a(float (&acc)[HD / 8][4], const uint32_t (&xa)[4],
                                             const bf16* sR) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, mat = lane >> 3;
    const bf16* rr = sR + ((lane & 7) + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
#pragma unroll
    for (int jn = 0; jn < HD / 8; jn += 2) {
        uint32_t rf[4];
        ldmatrix_x4_trans(rf, rr + jn * 8);
        mma_bf16(acc[jn], xa, rf[0], rf[1]);
        mma_bf16(acc[jn + 1], xa, rf[2], rf[3]);
    }
}

// 17 warps leave at most 96 registers a thread (5 warps on one of the SM's
// four register files)
template <int HD>
__global__ void __launch_bounds__(32 * kPlaneMaxWarps, 1)
attention_bwd_plane_bf16_kernel(Args a) {
    constexpr int kLd = HD + kTilePad, kNT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n = a.n, nk = round_up(n, 16);
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // nk x kLd
    bf16* sG = sQ + nk * kLd;                       // nk x kLd
    bf16* sK = sG + nk * kLd;                       // nk x kLd
    bf16* sV = sK + nk * kLd;                       // nk x kLd
    float* sM = reinterpret_cast<float*>(sV + nk * kLd);  // nk each: m log2 e, 1 / l, t
    float* sR = sM + nk;
    float* sT = sR + nk;

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const float scale = a.scale, sl2 = __fmul_rn(a.scale, kLog2e);
    // k and q first (the statistics and s), then v and g
    load_rows_async<HD>(sK, static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n, nk, n);
    load_rows_async<HD>(sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, nk, n);
    cp_async_commit();
    load_rows_async<HD>(sV, static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n, nk, n);
    load_rows_async<HD>(sG, static_cast<const bf16*>(a.g) + b * a.sg.b + h * a.sg.h, a.sg.n, nk, n);
    cp_async_commit();

    // query-major pass, this warp's 16 queries: m and l (unless saved), t =
    // rowsum(dp * p) with the f32 p, then ds and dq = ds k, written
    {
        const int q0 = warp * 16;
        const long long plane = static_cast<long long>(a.bh_total) * n;
        const float* ml = a.ml + static_cast<long long>(bh) * n;
        float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
        if (a.have_stats) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {  // padded rows: any finite p, never stored
                const int row = q0 + g + 8 * r;
                m[r] = row < n ? ml[row] : 0.f;
                l[r] = row < n ? ml[plane + row] : 1.f;
            }
        }
        cp_async_wait<1>();
        __syncthreads();  // k and q have landed
        uint32_t qa[HD / 16][4];
        load_a_smem<HD>(qa, sQ + q0 * kLd);
        if (!a.have_stats) {
            for_key_chunks<64>(n, [&](auto cols, int k0) {
                constexpr int C = decltype(cols)::value;
                float s[C / 8][4];
                dot_tile<HD, C>(qa, sK + k0 * kLd, s);
                scale_mask<C>(s, scale, k0, n);
                online_stats<C>(m, l, s);
            });
        }
        const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
        const float ml2[2] = {__fmul_rn(m[0], kLog2e), __fmul_rn(m[1], kLog2e)};
        cp_async_wait<0>();
        __syncthreads();  // v and g have landed
        const bf16* wG = sG + q0 * kLd;
        float tr[2] = {0.f, 0.f};
        for_key_chunks<32>(n, [&](auto cols, int k0) {
            constexpr int C = decltype(cols)::value;
            float d[C / 8][4], dp[C / 8][4];
            dot_tile<HD, C>(qa, sK + k0 * kLd, d);
            mask_dots<C>(d, k0, n);
            warp_dot_ldm<HD, C>(wG, sV + k0 * kLd, dp);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float part = 0.f;
#pragma unroll
                for (int j = 0; j < C / 8; ++j)
                    part += dp[j][2 * r] * prob_dot(d[j][2 * r], sl2, ml2[r], rl[r])
                            + dp[j][2 * r + 1] * prob_dot(d[j][2 * r + 1], sl2, ml2[r], rl[r]);
                tr[r] += quad_sum(part);
            }
        });
        float acc[kNT][4];
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
        for_key_chunks<16>(n, [&](auto cols, int k0) {
            float d[2][4], ds[2][4];
            dot_tile<HD, 16>(qa, sK + k0 * kLd, d);
            mask_dots<16>(d, k0, n);
            warp_dot_ldm<HD, 16>(wG, sV + k0 * kLd, ds);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    ds[j][e] = prob_dot(d[j][e], sl2, ml2[e >> 1], rl[e >> 1])
                               * (ds[j][e] - tr[e >> 1]) * scale;
            warp_accumulate_bf16<HD, 16>(acc, ds, sK + k0 * kLd);
        });
        warp_store_bf16<HD>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, q0,
                            n);
        if (t == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = q0 + g + 8 * r;
                sM[row] = row < n ? ml2[r] : pos_inf();  // m log2 e; padded: p = 0 below
                sR[row] = row < n ? rl[r] : 1.f;
                sT[row] = row < n ? tr[r] : 0.f;
            }
        }
    }
    __syncthreads();

    // key-major pass, this warp's 16 keys over 16-query steps: s^T = k q^T and
    // dp^T = v g^T once per step, p and ds rounded to bf16 A fragments, then
    // dv += bf16(p)^T g and dk += ds^T q (g and q through ldmatrix.trans); no
    // barrier.  Keys at or past n need no mask: their rows of dk and dv are
    // never stored, and a row of an mma product reads only its own A row
    const int key0 = warp * 16;
    float dk[kNT][4], dv[kNT][4];
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[jn][e] = dv[jn][e] = 0.f;
    for (int qs = 0; qs < nk; qs += 16) {
        uint32_t pa[4], da[4];
        {
            float p[2][4], ds[2][4];
            warp_dot_ldm<HD, 16>(sK + key0 * kLd, sQ + qs * kLd, p);
            warp_dot_ldm<HD, 16>(sV + key0 * kLd, sG + qs * kLd, ds);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = qs + j * 8 + t * 2 + (e & 1);
                    p[j][e] = prob_dot(p[j][e], sl2, sM[col], sR[col]);
                    ds[j][e] = p[j][e] * (ds[j][e] - sT[col]) * scale;
                }
            pack_a_bf16<16>(pa, p, 0);
            pack_a_bf16<16>(da, ds, 0);
        }
        accumulate_a<HD>(dv, pa, sG + qs * kLd);
        accumulate_a<HD>(dk, da, sQ + qs * kLd);
    }
    warp_store_bf16<HD>(static_cast<bf16*>(a.dk) + b * a.sdk.b + h * a.sdk.h, a.sdk.n, dk, key0, n);
    warp_store_bf16<HD>(static_cast<bf16*>(a.dv) + b * a.sdv.b + h * a.sdv.h, a.sdv.n, dv, key0, n);
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

    // pass 1 (unless saved): row max and sum of exp(s - max)
    const long long plane = static_cast<long long>(a.bh_total) * n;
    float* ml = a.ml + static_cast<long long>(bh) * n;
    float m[kRows], l[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = q0 + ty + kFmaSide * i;
        // saved: padded rows get any finite p, never stored
        m[i] = a.have_stats ? (row < n ? ml[row] : 0.f) : neg_inf();
        l[i] = a.have_stats ? (row < n ? ml[plane + row] : 1.f) : 0.f;
    }
    if (!a.have_stats) {
        for (int tile = 0; tile < ntiles; ++tile) {
            __syncthreads();
            load_tile_f32<HD, kBK>(sK, kb, a.sk.n, tile * kBK, n);
            __syncthreads();
            float s[kRows][kCols];
            scores(tile * kBK, s);
#pragma unroll
            for (int i = 0; i < kRows; ++i) online_stats_f32<kCols>(m[i], l[i], s[i]);
        }
    }

    float rl[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) rl[i] = __frcp_rn(l[i]);

    auto probs_and_dp = [&](int tile, float (&s)[kRows][kCols], float (&dp)[kRows][kCols]) {
        __syncthreads();
        load_tile_f32<HD, kBK>(sK, kb, a.sk.n, tile * kBK, n);
        load_tile_f32<HD, kBK>(sV, vb, a.sv.n, tile * kBK, n);
        __syncthreads();
        scores(tile * kBK, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = prob(s[i][j], m[i], rl[i]);
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
        float* tw = a.tw + static_cast<long long>(bh) * n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int row = q0 + ty + kFmaSide * i;
            if (row < n) {
                if (!a.have_stats) {
                    ml[row] = m[i];
                    ml[plane + row] = l[i];
                }
                tw[row] = tr[i];
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
    const float* ml = a.ml + static_cast<long long>(bh) * n;
    const float* tw = a.tw + static_cast<long long>(bh) * n;

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
            sM[i] = valid ? ml[row] : pos_inf();  // padded queries: p = 0
            sL[i] = valid ? __frcp_rn(ml[plane + row]) : 1.f;  // 1 / l
            sT[i] = valid ? tw[row] : 0.f;
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
                const float p = prob(s[i][j] * a.scale, sM[col], sL[col]);
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

// 1: the plane path, 0: the tiled path
int variant(int dtype, int n, int hd) { return dtype == 1 && hd <= 64 && n <= kPlaneMaxKeys; }

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
    const dim3 grid(a.bh_total, (a.n + kBQ - 1) / kBQ);
    int err;
    if constexpr (sizeof(T) == 2) {
        if constexpr (HD <= 64) {
            if (variant(1, a.n, HD))
                return launch_one(attention_bwd_plane_bf16_kernel<HD>, dim3(a.bh_total),
                                  32 * (round_up(a.n, 16) / 16), plane_smem(a.n, HD), a, stream);
        }
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
// contiguous, and for bf16 every row start 16-byte aligned.  ``ml`` is an
// f32 (2, batch * heads, n) tensor of row maxima and sums: read when
// ``have_stats`` (the forward's), else a workspace the tiled path fills;
// ``tw`` an f32 workspace of batch * heads * n floats (tiled path).  The
// plane path runs one kernel, the tiled path two, in order, on ``stream``.
extern "C" int irw_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                 void* dq, void* dk, void* dv, void* ml, int have_stats,
                                 void* tw, int dtype, int batch, int n, int heads, int hd,
                                 float scale,
                                 long long qsb, long long qsn, long long qsh,
                                 long long ksb, long long ksn, long long ksh,
                                 long long vsb, long long vsn, long long vsh,
                                 long long gsb, long long gsn, long long gsh,
                                 long long dqsb, long long dqsn, long long dqsh,
                                 long long dksb, long long dksn, long long dksh,
                                 long long dvsb, long long dvsn, long long dvsh,
                                 void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, g, dq, dk, dv, static_cast<float*>(ml), static_cast<float*>(tw),
                 have_stats, n, heads, batch * heads, scale,
                 Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
                 Strides{gsb, gsn, gsh}, Strides{dqsb, dqsn, dqsh}, Strides{dksb, dksn, dksh},
                 Strides{dvsb, dvsn, dvsh}};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_hd<float>(hd, a, st);
    if (dtype == 1) return dispatch_hd<bf16>(hd, a, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// which kernels irw_attention_bwd runs for (dtype, n, hd): 1 the plane
// path, 0 the tiled path
extern "C" int irw_attention_bwd_variant(int dtype, int n, int hd) { return variant(dtype, n, hd); }

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
