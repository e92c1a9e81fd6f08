// The attention segment in one kernel:
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv   (rounded to x's dtype)
//   o_h     = softmax(q_h k_h^T * scale) v_h     per head h, heads concatenated,
// x (B, N, D), Wq/Wk/Wv (D, H*hd) in Dense (in, out) layout, biases (H*hd,),
// o (B, N, H*hd), all contiguous, bf16 or f32.  No output projection, forward
// only.  Q, K and V never reach device memory.
//
// Replaces: benchmarks/vmem_qkv_micro.py, fused_qkv_attention (kernel body
// _qkv_attn_kernel).  Same rounding points: each projection accumulated in
// f32, the bias added in f32, then one rounding to x's dtype; scores are the
// f32 product times scale; the NORMALISED probabilities e / sum(e) are rounded
// to x's dtype; P.V accumulated in f32 and rounded once.
//
// Bound on the H100 at the micro-benchmark's shape (B = 192, N = 257, D = 384,
// 6 heads of 64, bf16): operations.  3 * 2 B N D^2 + 4 B H N^2 hd = 63 GFLOP
// take 64 us at the 989 TFLOP/s bf16 tensor-core peak; x read and o written
// once are 76 MB, 23 us at 3.35 TB/s.
//
// Design, shared by both paths:
// - one thread block per (sequence, head).  The TPU kernel held a block of
//   sequences with all heads' Q, K, V in VMEM; a Hopper block has 227 KB of
//   shared memory, so a block owns one head of one sequence: its K and V
//   (N x hd each) stay resident in shared memory for the whole block, and Q
//   is made one row tile at a time, just before it is used.  The price: x is
//   read once per head and pass (2 H times in all), from L2 after the first.
// - D is a run-time size: x and one head's slice of a weight are walked in
//   chunks of kDC columns / rows through shared memory (zero-filled past D).
// - phase 1: K and V for every row tile (both from one x chunk), bias added,
//   rounded, stored to shared memory.  Rows at or past N hold the bias only;
//   their scores are masked to -inf, so their probabilities are exactly 0.
// - phase 2, per row tile: Q = x Wq + bq, then the two-pass softmax of
//   attention_fwd.cu over the resident key tiles of 64 (pass 1: row max and
//   sum, online; pass 2: P = exp(s - max) / sum rounded, P.V accumulated),
//   rows at or past N never stored.
//
// bf16: tensor cores through mma.sync m16n8k16.  8 warps, 16 rows each, 128
// rows per tile.  The f32 accumulator fragments of x Wq are laid out as the A
// operand of q k^T wants them, so Q goes from the projection to the score
// product in registers (bias added, rounded to bf16) and needs no shared
// memory; W chunks feed the projection through ldmatrix.trans like V feeds
// P.V.  The attention passes read only the resident K and V: no barrier in
// them, and warps whose 16 rows lie past N skip them.
//
// f32: plain FMAs, 256 threads as 16 x 16, 64-row tiles; Q and P tiles go
// through shared memory.  K and V resident in f32 bound N (see
// irw_qkv_attention_smem_bytes; the wrapper raises past the limit).
//
// Not yet: wgmma, TMA, cp.async double buffering of the chunks, x shared
// between the heads of a sequence (a cluster), a single softmax pass.

#include "attention_common.cuh"

namespace {

using namespace irw;

constexpr int kBK = 64;                  // keys per score tile; K/V rows padded to it
constexpr size_t kMaxSmem = 232448;      // bytes a block may opt into on sm_90

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ------------------------------------------------------------------------

constexpr int kWarps = 8;                // 16 rows of x each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;         // rows of x per projection tile
constexpr int kDC = 32;                  // columns of x / rows of W per chunk
constexpr int kLdX = kDC + kTilePad;

// rows row0 .. row0 + kBM - 1, columns d0 .. d0 + kDC - 1 of x_b (n, d) into
// the padded tile sX; zero at or past row n or column d
__device__ __forceinline__ void load_x_chunk_bf16(__nv_bfloat16* sX, const __nv_bfloat16* xb,
                                                  int n, int d, int row0, int d0) {
    constexpr int kPerRow = kDC / 8;
    for (int idx = threadIdx.x; idx < kBM * kPerRow; idx += kMmaThreads) {
        const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
        const int row = row0 + r, col = d0 + c;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < n && col < d)
            val = *reinterpret_cast<const uint4*>(xb + static_cast<long long>(row) * d + col);
        *reinterpret_cast<uint4*>(sX + r * kLdX + c) = val;
    }
}

// rows d0 .. d0 + kDC - 1, columns col0 .. col0 + HD - 1 of w (d, ldw) into
// the padded tile sW; zero at or past row d
template <int HD>
__device__ __forceinline__ void load_w_chunk_bf16(__nv_bfloat16* sW, const __nv_bfloat16* w,
                                                  int ldw, int col0, int d, int d0) {
    constexpr int kPerRow = HD / 8, kLd = HD + kTilePad;
    for (int idx = threadIdx.x; idx < kDC * kPerRow; idx += kMmaThreads) {
        const int r = idx / kPerRow, c = (idx % kPerRow) * 8;
        const int krow = d0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (krow < d)
            val = *reinterpret_cast<const uint4*>(w + static_cast<long long>(krow) * ldw + col0 + c);
        *reinterpret_cast<uint4*>(sW + r * kLd + c) = val;
    }
}

// acc (16 x HD per warp) += X . W for this warp's 16 rows of the x chunk at
// sXw (16 x kDC) and the W chunk sW (kDC x HD)
template <int HD>
__device__ __forceinline__ void warp_project_bf16(float (&acc)[HD / 8][4],
                                                  const __nv_bfloat16* sXw,
                                                  const __nv_bfloat16* sW) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3, mat = lane >> 3;
    const __nv_bfloat16* ar = sXw + g * kLdX + t * 2;
#pragma unroll
    for (int kk = 0; kk < kDC / 16; ++kk) {
        const uint32_t a[4] = {ld32(ar + kk * 16), ld32(ar + 8 * kLdX + kk * 16),
                               ld32(ar + kk * 16 + 8), ld32(ar + 8 * kLdX + kk * 16 + 8)};
        // W rows kk*16 .. +15: lanes 0-7 / 8-15 address the two 8-row halves
        // of column tile jn, lanes 16-31 the same for tile jn + 1
        const __nv_bfloat16* rr = sW + (kk * 16 + (lane & 7) + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
#pragma unroll
        for (int jn = 0; jn < HD / 8; jn += 2) {
            uint32_t rf[4];
            ldmatrix_x4_trans(rf, rr + jn * 8);
            mma_bf16(acc[jn], a, rf[0], rf[1]);
            mma_bf16(acc[jn + 1], a, rf[2], rf[3]);
        }
    }
}

// acc += bias (this head's HD entries), in f32: columns 2 t, 2 t + 1 of each n-tile
template <int HD>
__device__ __forceinline__ void add_bias_bf16(float (&acc)[HD / 8][4], const __nv_bfloat16* bias) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
        const float b0 = __bfloat162float(bias[jn * 8 + t * 2]);
        const float b1 = __bfloat162float(bias[jn * 8 + t * 2 + 1]);
        acc[jn][0] += b0;
        acc[jn][1] += b1;
        acc[jn][2] += b0;
        acc[jn][3] += b1;
    }
}

// this warp's 16 x HD accumulator, rounded to bf16, into rows row0 + g and
// row0 + g + 8 of a padded smem tile
template <int HD>
__device__ __forceinline__ void warp_store_smem_bf16(__nv_bfloat16* dst, const float (&acc)[HD / 8][4],
                                                     int row0) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
        const int col = jn * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(dst + (row0 + g) * kLd + col) = pack_bf16(acc[jn][0], acc[jn][1]);
        *reinterpret_cast<uint32_t*>(dst + (row0 + g + 8) * kLd + col) = pack_bf16(acc[jn][2], acc[jn][3]);
    }
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[HD / 8][4]) {
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
}

constexpr size_t smem_bytes_bf16(int n, int hd) {
    return sizeof(__nv_bfloat16) * (2 * static_cast<size_t>(round_up(n, kBK)) * (hd + kTilePad)
                                    + kBM * kLdX + 2 * kDC * (hd + kTilePad));
}

// two blocks share an SM for hd <= 64 while K and V fit twice (N <= 320 at
// hd = 64): at most 128 registers a thread
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 64 ? 2 : 1)
qkv_attention_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wq,
                          const __nv_bfloat16* __restrict__ wk, const __nv_bfloat16* __restrict__ wv,
                          const __nv_bfloat16* __restrict__ bq, const __nv_bfloat16* __restrict__ bk,
                          const __nv_bfloat16* __restrict__ bv, __nv_bfloat16* __restrict__ o,
                          int n, int d, int heads, float scale) {
    constexpr int kLd = HD + kTilePad;
    constexpr int kNT = HD / 8;    // n-tiles over head_dim
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int npad = round_up(n, kBK);
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // npad x kLd
    __nv_bfloat16* sV = sK + npad * kLd;                                // npad x kLd
    __nv_bfloat16* sX = sV + npad * kLd;                                // kBM x kLdX
    __nv_bfloat16* sW0 = sX + kBM * kLdX;                               // kDC x kLd
    __nv_bfloat16* sW1 = sW0 + kDC * kLd;                               // kDC x kLd

    const int b = blockIdx.x / heads, h = blockIdx.x % heads;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int ldw = heads * HD, col0 = h * HD;
    const __nv_bfloat16* xb = x + static_cast<long long>(b) * n * d;
    const __nv_bfloat16* sXw = sX + warp * 16 * kLdX;

    // phase 1: K and V of every row, resident in shared memory
    for (int row0 = 0; row0 < npad; row0 += kBM) {
        const int wrow0 = row0 + warp * 16;
        float ak[kNT][4], av[kNT][4];
        zero_acc<HD>(ak);
        zero_acc<HD>(av);
        for (int d0 = 0; d0 < d; d0 += kDC) {
            __syncthreads();  // readers of the previous chunk are done
            load_x_chunk_bf16(sX, xb, n, d, row0, d0);
            load_w_chunk_bf16<HD>(sW0, wk, ldw, col0, d, d0);
            load_w_chunk_bf16<HD>(sW1, wv, ldw, col0, d, d0);
            __syncthreads();
            if (wrow0 < n) {
                warp_project_bf16<HD>(ak, sXw, sW0);
                warp_project_bf16<HD>(av, sXw, sW1);
            }
        }
        if (wrow0 < npad) {
            add_bias_bf16<HD>(ak, bk + col0);
            add_bias_bf16<HD>(av, bv + col0);
            warp_store_smem_bf16<HD>(sK, ak, wrow0);
            warp_store_smem_bf16<HD>(sV, av, wrow0);
        }
    }

    // phase 2: per row tile, Q in registers, then the two-pass softmax over
    // the resident keys (the chunk loop's first barrier also publishes sK, sV)
    const int ntiles = npad / kBK;
    for (int row0 = 0; row0 < n; row0 += kBM) {
        const int wrow0 = row0 + warp * 16;
        float aq[kNT][4];
        zero_acc<HD>(aq);
        for (int d0 = 0; d0 < d; d0 += kDC) {
            __syncthreads();
            load_x_chunk_bf16(sX, xb, n, d, row0, d0);
            load_w_chunk_bf16<HD>(sW0, wq, ldw, col0, d, d0);
            __syncthreads();
            if (wrow0 < n) warp_project_bf16<HD>(aq, sXw, sW0);
        }
        if (wrow0 >= n) continue;  // no barrier below: the warp only skips its own rows
        add_bias_bf16<HD>(aq, bq + col0);
        uint32_t qa[HD / 16][4];
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) pack_a_bf16<HD>(qa[ks], aq, ks);

        // pass 1: max and sum of exp(s - max) for rows g (index 0) and g + 8 (index 1)
        float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
        for (int tile = 0; tile < ntiles; ++tile) {
            const int k0 = tile * kBK;
            float s[kBK / 8][4];
            score_tile_bf16<HD, kBK>(qa, sK + k0 * kLd, scale, k0, n, s);
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

        // pass 2: P = exp(s - max) / sum rounded to bf16, P.V accumulated in f32
        float acc[kNT][4];
        zero_acc<HD>(acc);
        for (int tile = 0; tile < ntiles; ++tile) {
            const int k0 = tile * kBK;
            float s[kBK / 8][4];
            score_tile_bf16<HD, kBK>(qa, sK + k0 * kLd, scale, k0, n, s);
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
                uint32_t pa[4];
                pa[0] = pack_bf16(expf(s[2 * kk][0] - m[0]) / l[0], expf(s[2 * kk][1] - m[0]) / l[0]);
                pa[1] = pack_bf16(expf(s[2 * kk][2] - m[1]) / l[1], expf(s[2 * kk][3] - m[1]) / l[1]);
                pa[2] = pack_bf16(expf(s[2 * kk + 1][0] - m[0]) / l[0],
                                  expf(s[2 * kk + 1][1] - m[0]) / l[0]);
                pa[3] = pack_bf16(expf(s[2 * kk + 1][2] - m[1]) / l[1],
                                  expf(s[2 * kk + 1][3] - m[1]) / l[1]);
                const int mat = lane >> 3;
                const __nv_bfloat16* vr = sV + (k0 + kk * 16 + (lane & 7) + (mat & 1) * 8) * kLd
                                          + (mat >> 1) * 8;
#pragma unroll
                for (int jn = 0; jn < kNT; jn += 2) {
                    uint32_t vfrag[4];
                    ldmatrix_x4_trans(vfrag, vr + jn * 8);
                    mma_bf16(acc[jn], pa, vfrag[0], vfrag[1]);
                    mma_bf16(acc[jn + 1], pa, vfrag[2], vfrag[3]);
                }
            }
        }
        warp_store_bf16<HD>(o + static_cast<long long>(b) * n * ldw + col0, ldw, acc, wrow0, n);
    }
}

// ------------------------------------------------------------------------
// f32: plain FMA path
// ------------------------------------------------------------------------

constexpr int kBQ = 64;                  // rows of x per tile
constexpr int kRows = kBQ / kFmaSide;    // rows per thread
constexpr int kCols = kBK / kFmaSide;    // keys per thread
constexpr int kLdP = kBK + 1;
constexpr int kDCF = 32;                 // columns of x / rows of W per chunk
constexpr int kLdXF = kDCF + 1;

__device__ __forceinline__ void load_x_chunk_f32(float* sX, const float* xb, int n, int d,
                                                 int row0, int d0) {
    for (int idx = threadIdx.x; idx < kBQ * kDCF; idx += kFmaThreads) {
        const int r = idx / kDCF, c = idx % kDCF;
        const int row = row0 + r, col = d0 + c;
        sX[r * kLdXF + c] = (row < n && col < d) ? xb[static_cast<long long>(row) * d + col] : 0.f;
    }
}

template <int HD>
__device__ __forceinline__ void load_w_chunk_f32(float* sW, const float* w, int ldw, int col0,
                                                 int d, int d0) {
    constexpr int ld = HD + 1;
    for (int idx = threadIdx.x; idx < kDCF * HD; idx += kFmaThreads) {
        const int r = idx / HD, c = idx % HD;
        const int krow = d0 + r;
        sW[r * ld + c] = krow < d ? w[static_cast<long long>(krow) * ldw + col0 + c] : 0.f;
    }
}

// acc + bias into rows row0 + ty + 16 i, columns tx + 16 c of a padded smem tile
template <int HD>
__device__ __forceinline__ void fma_store_smem_f32(float* dst, const float (&acc)[kRows][HD / kFmaSide],
                                                   const float* bias, int row0) {
    constexpr int ld = HD + 1;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < HD / kFmaSide; ++c)
            dst[(row0 + ty + kFmaSide * i) * ld + tx + kFmaSide * c] = acc[i][c] + bias[tx + kFmaSide * c];
}

template <int HD>
__device__ __forceinline__ void zero_acc_f32(float (&acc)[kRows][HD / kFmaSide]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < HD / kFmaSide; ++c) acc[i][c] = 0.f;
}

constexpr size_t smem_bytes_f32(int n, int hd) {
    return sizeof(float) * (2 * static_cast<size_t>(round_up(n, kBK)) * (hd + 1) + kBQ * (hd + 1)
                            + kBQ * kLdP + kBQ * kLdXF + 2 * kDCF * (hd + 1));
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
qkv_attention_f32_kernel(const float* __restrict__ x, const float* __restrict__ wq,
                         const float* __restrict__ wk, const float* __restrict__ wv,
                         const float* __restrict__ bq, const float* __restrict__ bk,
                         const float* __restrict__ bv, float* __restrict__ o, int n, int d,
                         int heads, float scale) {
    constexpr int ld = HD + 1;
    constexpr int kOut = HD / kFmaSide;  // output columns per thread
    extern __shared__ float smem[];
    const int npad = round_up(n, kBK);
    float* sK = smem;                    // npad x ld
    float* sV = sK + npad * ld;          // npad x ld
    float* sQ = sV + npad * ld;          // kBQ x ld
    float* sP = sQ + kBQ * ld;           // kBQ x kLdP
    float* sX = sP + kBQ * kLdP;         // kBQ x kLdXF
    float* sW0 = sX + kBQ * kLdXF;       // kDCF x ld
    float* sW1 = sW0 + kDCF * ld;        // kDCF x ld

    const int b = blockIdx.x / heads, h = blockIdx.x % heads;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const int ldw = heads * HD, col0 = h * HD;
    const float* xb = x + static_cast<long long>(b) * n * d;

    // phase 1: K and V of every row, resident in shared memory
    for (int row0 = 0; row0 < npad; row0 += kBQ) {
        float ak[kRows][kOut], av[kRows][kOut];
        zero_acc_f32<HD>(ak);
        zero_acc_f32<HD>(av);
        for (int d0 = 0; d0 < d; d0 += kDCF) {
            __syncthreads();  // readers of the previous chunk are done
            load_x_chunk_f32(sX, xb, n, d, row0, d0);
            load_w_chunk_f32<HD>(sW0, wk, ldw, col0, d, d0);
            load_w_chunk_f32<HD>(sW1, wv, ldw, col0, d, d0);
            __syncthreads();
            fma_accumulate_f32<HD, kDCF, kBQ>(ak, sX, kLdXF, sW0);
            fma_accumulate_f32<HD, kDCF, kBQ>(av, sX, kLdXF, sW1);
        }
        fma_store_smem_f32<HD>(sK, ak, bk + col0, row0);
        fma_store_smem_f32<HD>(sV, av, bv + col0, row0);
    }

    // phase 2: per row tile, Q through shared memory, then the two-pass softmax
    const int ntiles = npad / kBK;
    for (int row0 = 0; row0 < n; row0 += kBQ) {
        float aq[kRows][kOut];
        zero_acc_f32<HD>(aq);
        for (int d0 = 0; d0 < d; d0 += kDCF) {
            __syncthreads();  // also: readers of the previous tile's sQ, sP are done
            load_x_chunk_f32(sX, xb, n, d, row0, d0);
            load_w_chunk_f32<HD>(sW0, wq, ldw, col0, d, d0);
            __syncthreads();
            fma_accumulate_f32<HD, kDCF, kBQ>(aq, sX, kLdXF, sW0);
        }
        fma_store_smem_f32<HD>(sQ, aq, bq + col0, 0);
        __syncthreads();  // sQ, and after phase 1 sK and sV, are complete

        // pass 1: row max and sum of exp(s - max)
        float m[kRows], l[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) { m[i] = neg_inf(); l[i] = 0.f; }
        for (int t = 0; t < ntiles; ++t) {
            const int k0 = t * kBK;
            float s[kRows][kCols];
            fma_dot_f32<HD, kBQ, kBK>(sQ, sK + k0 * ld, s);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                float tmax = neg_inf();
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    s[i][j] = k0 + tx + kFmaSide * j < n ? s[i][j] * scale : neg_inf();
                    tmax = fmaxf(tmax, s[i][j]);
                }
                const float mnew = fmaxf(m[i], row16_max(tmax));
                float part = 0.f;
#pragma unroll
                for (int j = 0; j < kCols; ++j) part += expf(s[i][j] - mnew);
                l[i] = l[i] * expf(m[i] - mnew) + row16_sum(part);
                m[i] = mnew;
            }
        }

        // pass 2: normalised P (f32 needs no rounding), P.V accumulated
        float acc[kRows][kOut];
        zero_acc_f32<HD>(acc);
        for (int t = 0; t < ntiles; ++t) {
            const int k0 = t * kBK;
            float s[kRows][kCols];
            fma_dot_f32<HD, kBQ, kBK>(sQ, sK + k0 * ld, s);
            __syncthreads();  // readers of the previous tile's sP are done
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    const float sc = k0 + tx + kFmaSide * j < n ? s[i][j] * scale : neg_inf();
                    sP[(ty + kFmaSide * i) * kLdP + tx + kFmaSide * j] = expf(sc - m[i]) / l[i];
                }
            __syncthreads();
            fma_accumulate_f32<HD, kBK, kBQ>(acc, sP, kLdP, sV + k0 * ld);
        }
        fma_store_f32<HD, kBQ>(o + static_cast<long long>(b) * n * ldw + col0, ldw, acc, row0, n);
    }
}

// ------------------------------------------------------------------------
// launch
// ------------------------------------------------------------------------

template <typename T, int HD>
int launch(const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
           const void* bk, const void* bv, void* o, int batch, int n, int d, int heads,
           float scale, cudaStream_t stream) {
    const dim3 grid(batch * heads);
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
        const size_t smem = smem_bytes_bf16(n, HD);
        if (smem > kMaxSmem || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
        auto kernel = qkv_attention_bf16_kernel<HD>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        using B = __nv_bfloat16;
        kernel<<<grid, kMmaThreads, smem, stream>>>(
            static_cast<const B*>(x), static_cast<const B*>(wq), static_cast<const B*>(wk),
            static_cast<const B*>(wv), static_cast<const B*>(bq), static_cast<const B*>(bk),
            static_cast<const B*>(bv), static_cast<B*>(o), n, d, heads, scale);
    } else {
        const size_t smem = smem_bytes_f32(n, HD);
        if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
        auto kernel = qkv_attention_f32_kernel<HD>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid, kFmaThreads, smem, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(wq),
            static_cast<const float*>(wk), static_cast<const float*>(wv),
            static_cast<const float*>(bq), static_cast<const float*>(bk),
            static_cast<const float*>(bv), static_cast<float*>(o), n, d, heads, scale);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* x, const void* wq, const void* wk, const void* wv,
                const void* bq, const void* bk, const void* bv, void* o, int batch, int n,
                int d, int heads, float scale, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(x, wq, wk, wv, bq, bk, bv, o, batch, n, d, heads, scale, stream);
        case 64: return launch<T, 64>(x, wq, wk, wv, bq, bk, bv, o, batch, n, d, heads, scale, stream);
        case 128: return launch<T, 128>(x, wq, wk, wv, bq, bk, bv, o, batch, n, d, heads, scale, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every tensor contiguous: x (batch, n, d),
// wq/wk/wv (d, heads * hd), bq/bk/bv (heads * hd), o (batch, n, heads * hd).
// For bf16, d must be a multiple of 8 (16-byte loads).
extern "C" int irw_qkv_attention(const void* x, const void* wq, const void* wk, const void* wv,
                                 const void* bq, const void* bk, const void* bv, void* o,
                                 int dtype, int batch, int n, int d, int heads, int hd,
                                 float scale, void* stream) {
    if (batch <= 0 || n <= 0 || d <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch_hd<float>(hd, x, wq, wk, wv, bq, bk, bv, o, batch, n, d, heads, scale, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, x, wq, wk, wv, bq, bk, bv, o, batch, n, d, heads,
                                          scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// the dynamic shared memory one block needs (K and V of all n rows resident);
// the launch is refused above irw_qkv_attention_max_smem()
extern "C" long long irw_qkv_attention_smem_bytes(int dtype, int n, int hd) {
    return static_cast<long long>(dtype == 1 ? smem_bytes_bf16(n, hd) : smem_bytes_f32(n, hd));
}

extern "C" long long irw_qkv_attention_max_smem() { return static_cast<long long>(kMaxSmem); }

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
