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
// Every path runs one thread block per (sequence, head).  The TPU kernel held
// a block of sequences with all heads' Q, K, V in VMEM; a Hopper block has
// 227 KB of shared memory, so a block owns one head of one sequence and keeps
// its K and V (N x hd each) resident in shared memory.  Each head streams
// its sequence's x once per pass of its path, from L2 after the first head.
//
// bf16, plane path (hd 32 or 64, N <= 288; qkv_kernel_variants): one warp
// per 16-row tile of the sequence (17 warps at N = 257, so the ragged 257th
// row costs one tile, not a 128-row tile), one block an SM.  The
// projection walks x in 64-column chunks: each chunk of x (all rows, two
// boxes, 128-byte swizzle) and the matching 64 rows of this head's
// [Wk | Wv | Wq] slice (boxes of 32 columns, 64-byte swizzle) arrive by TMA
// in a ring of three stages, issued by one thread and counted on one
// mbarrier a stage; rows past N, columns past D and W rows past D arrive as
// zeros.  One barrier per chunk frees the stage the next copy overwrites.
// Fragments come through ldmatrix (.trans for W); the swizzles are those of
// attention_plane.cuh's swz.  A warp's accumulator holds 96 columns (48
// registers: at 17-18 warps a thread gets 96), so the 3 hd columns take
// 3 hd / 96 passes over x: one at hd 32, two at hd 64.  Each pass ends with
// the bias added in f32 and one rounding to bf16: K and V into unpadded,
// XOR-swizzled planes, Q, whose columns come last, straight into the warp's
// A fragments for q k^T.  Then, with no barrier, K2's plane body over the
// resident planes: pass 1 the online row max and sum over 64-key chunks
// (online_stats), pass 2 recomputes the dot products over 32-key chunks and
// forms p = 2^(d scale log2 e - m log2 e) * (1 / l) (ex2.approx, one FMA,
// a per-row reciprocal), rounds it to bf16 and accumulates P.V.  The last
// key chunk is cut to the 16-key multiple that holds N (for_key_chunks).
// Measured on the H100 (PERF.md, tools/k5_variants.py): at (192, 257, 384)
// the projection takes about 0.14 of 0.31 ms.  With every thread issuing
// cp.async copies (16 bytes each, about 3000 a chunk) copies and products
// did not overlap (0.22 ms); the TMA ring removed that.  Shared-memory
// bandwidth is not the bound (two tiles a warp, sharing each W fragment,
// did not pay); one pass at hd 64 (96 accumulator registers) spills; two
// blocks an SM (9 warps, row rounds) lost more in the projection than the
// overlap with another block's attention won.
//
// bf16, tiled path (hd 128, N > 288): tensor cores through mma.sync
// m16n8k16.  8 warps, 16 rows each, 128 rows per tile.  Phase 1: K and V for
// every row tile (both from one x chunk of 32 columns), bias added, rounded,
// stored to padded shared memory, K and V padded to 64 keys; rows at or past
// N hold the bias only and their scores are masked to -inf.  Phase 2, per
// row tile: Q = x Wq + bq from a second pass over x, the f32 accumulator
// fragments packed as the A operand of q k^T, then the two-pass softmax over
// the resident key tiles of 64 (P = exp(s - max) / sum rounded, P.V
// accumulated).  The attention passes have no barrier; warps whose 16 rows
// lie past N skip them.
//
// f32: plain FMAs, 256 threads as 16 x 16, 64-row tiles; Q and P tiles go
// through shared memory.  K and V resident in f32 bound N (see
// irw_qkv_attention_smem_bytes; the wrapper raises past the limit).
//
// Not yet: wgmma, TMA, x shared between the heads of a sequence (a cluster:
// the L2 traffic of the projection is mostly x), hd 128 on the plane path.

#include <cuda.h>

#include <utility>

#include "attention_plane.cuh"

namespace {

using namespace irw;

constexpr int kBK = 64;                  // keys per score tile; K/V rows padded to it
constexpr size_t kMaxSmem = 232448;      // bytes a block may opt into on sm_90

// ------------------------------------------------------------------------
// bf16, tiled path: mma.sync, 128-row tiles, x read twice
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
// bf16, plane path: one warp per 16-row tile; x read once per column part;
// K and V resident and swizzled; K2's plane body
// ------------------------------------------------------------------------

constexpr int kPartCols = 96;            // columns of [Wk | Wv | Wq] one pass over x accumulates
constexpr int kPlaneMaxWarps = 18;       // one per 16-row tile: N <= 288
constexpr int kXC = 64;                  // columns of x / rows of W per chunk (128 bytes of x)
constexpr int kWC = 32;                  // columns of a W box (64 bytes)
constexpr int kStages = 3;               // chunks in the TMA ring

// the head's 3 hd projected columns in the order [K | V | Q] (Q last: its
// A fragments are built at the end of the last pass), kParts passes of
// kPartCols, each part kPartCols / kWC boxes of W
template <int HD>
struct Part {
    static_assert(3 * HD % kPartCols == 0 && kPartCols % kWC == 0 && HD % kWC == 0,
                  "whole parts of whole boxes");
    static constexpr int kParts = 3 * HD / kPartCols;
    static constexpr int kNT = kPartCols / 8;   // n-tiles of a warp's accumulator
    static constexpr int kBoxes = kPartCols / kWC;
};

// the rows a plane block projects (whole 16-row tiles) and its warps
__host__ __device__ constexpr int plane_rows(int n) { return round_up(n, 16); }
__host__ __device__ constexpr int plane_warps(int n) { return plane_rows(n) / 16; }

// bytes of one stage: the x chunk (rows x kXC, 128-byte swizzle), then the
// W chunk (kPartCols / kWC boxes of kXC rows x kWC, 64-byte swizzle); a
// multiple of 1024, so every stage keeps the swizzles' alignment
__host__ __device__ constexpr size_t plane_stage_bytes(int n) {
    return sizeof(__nv_bfloat16) * (static_cast<size_t>(plane_rows(n)) * kXC + kXC * kPartCols);
}

// the stages (first: 1024-byte aligned), the K and V planes, one mbarrier a
// stage, and the slack that aligns the base
__host__ __device__ constexpr size_t plane_smem_bytes(int n, int hd) {
    return 1024 + kStages * plane_stage_bytes(n)
           + sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(plane_rows(n)) * hd + 8 * kStages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// until the mbarrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// one TMA box into shared memory, completion counted on the mbarrier bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                            int c2, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
        : "memory");
}

// acc (16 x kPartCols) += X . W for this warp's 16 rows at row0 of a staged
// x chunk and the staged W boxes: A fragments through ldmatrix, B through
// ldmatrix.trans
template <int HD>
__device__ __forceinline__ void plane_project(float (&acc)[Part<HD>::kNT][4],
                                              const __nv_bfloat16* sX, const __nv_bfloat16* sW,
                                              int row0) {
    using P = Part<HD>;
    const int lane = threadIdx.x % 32, mat = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < kXC / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, sX + swz<kXC>(row0 + ldm_a_row(), ks * 16 + ldm_a_col()));
        // W rows ks*16 .. +15: lanes 0-7 / 8-15 address the two 8-row halves
        // of column tile jn, lanes 16-31 the same for tile jn + 1
        const int row = ks * 16 + (lane & 7) + (mat & 1) * 8;
#pragma unroll
        for (int jn = 0; jn < P::kNT; jn += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, sW + (jn * 8 / kWC) * (kXC * kWC)
                                      + swz<kWC>(row, (jn * 8) % kWC + (mat >> 1) * 8));
            mma_bf16(acc[jn], a, bf[0], bf[1]);
            mma_bf16(acc[jn + 1], a, bf[2], bf[3]);
        }
    }
}

// a part's accumulator plus bias (f32), rounded once to bf16: K's and V's
// columns into rows row0 + g, row0 + g + 8 of the swizzled planes, Q's into
// the tile's A fragments qa (pack_a_bf16's layout)
template <int HD, int PART>
__device__ __forceinline__ void plane_epilogue(const float (&acc)[Part<HD>::kNT][4],
                                               uint32_t (&qa)[HD / 16][4], __nv_bfloat16* sK,
                                               __nv_bfloat16* sV, const __nv_bfloat16* bq,
                                               const __nv_bfloat16* bk, const __nv_bfloat16* bv,
                                               int row0) {
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < Part<HD>::kNT; ++j) {
        const int fc = PART * kPartCols + j * 8, which = fc / HD, c = fc % HD + 2 * t;
        const __nv_bfloat16* bias = which == 0 ? bk : which == 1 ? bv : bq;
        const float b0 = __bfloat162float(bias[c]), b1 = __bfloat162float(bias[c + 1]);
        const uint32_t lo = pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
        const uint32_t hi = pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
        if (which == 2) {
            const int ks = (fc % HD) / 16, odd = ((fc % HD) / 8) & 1;
            qa[ks][2 * odd] = lo;
            qa[ks][2 * odd + 1] = hi;
        } else {
            __nv_bfloat16* dst = which == 0 ? sK : sV;
            *reinterpret_cast<uint32_t*>(dst + swz<HD>(row0 + g, c)) = lo;
            *reinterpret_cast<uint32_t*>(dst + swz<HD>(row0 + g + 8, c)) = hi;
        }
    }
}

// f(Cols<0>{}), ..., f(Cols<N - 1>{}): a loop whose index is a constant
template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, I...>) {
    (f(Cols<I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// the tensor maps of one launch: x as (D, N, B), each weight as (H hd, D)
struct PlaneMaps {
    CUtensorMap x, wk, wv, wq;
};

// one block an SM (its shared memory); at 17-18 warps ptxas gives a thread
// 96 registers (a sub-partition holds 5 warps)
template <int HD>
__global__ void __launch_bounds__(32 * kPlaneMaxWarps, 1)
qkv_attention_plane_bf16_kernel(const __grid_constant__ PlaneMaps maps,
                                const __nv_bfloat16* __restrict__ bq,
                                const __nv_bfloat16* __restrict__ bk,
                                const __nv_bfloat16* __restrict__ bv,
                                __nv_bfloat16* __restrict__ o, int n, int d, int heads,
                                float scale) {
    using P = Part<HD>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int rows = plane_rows(n);
    const size_t stage = plane_stage_bytes(n);
    unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(base + kStages * stage);   // rows x HD
    __nv_bfloat16* sV = sK + rows * HD;                                              // rows x HD
    const uint32_t bars = smem_u32(sV + rows * HD);   // kStages mbarriers, 8 bytes each

    const int b = blockIdx.x / heads, h = blockIdx.x % heads;
    const int row0 = (threadIdx.x / 32) * 16;   // this warp's tile
    const int ldw = heads * HD, col0 = h * HD;
    const int nc = (d + kXC - 1) / kXC, steps = P::kParts * nc;   // (part, chunk) steps

    auto stage_x = [&](int s) {
        return reinterpret_cast<const __nv_bfloat16*>(base + (s % kStages) * stage);
    };
    // step s into its stage, issued by one thread: x's rows in two boxes
    // (rows past N and columns past D arrive as zeros), then the part's W
    // boxes (rows past D zeros)
    auto load = [&](int s) {
        const uint32_t dst = smem_u32(stage_x(s)), bar = bars + 8 * (s % kStages);
        const int d0 = (s % nc) * kXC, part = s / nc;
        mbar_expect_tx(bar, static_cast<uint32_t>(stage));
        tma_load_3d(dst, maps.x, d0, 0, b, bar);
        tma_load_3d(dst + rows / 2 * kXC * 2, maps.x, d0, rows / 2, b, bar);
#pragma unroll
        for (int i = 0; i < P::kBoxes; ++i) {
            const int fc = part * kPartCols + i * kWC, which = fc / HD;
            const CUtensorMap& map = which == 0 ? maps.wk : which == 1 ? maps.wv : maps.wq;
            tma_load_2d(dst + (rows * kXC + i * kXC * kWC) * 2, map, col0 + fc % HD, d0, bar);
        }
    };
    if (threadIdx.x == 0) {
        for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < kStages - 1 && s < steps; ++s) load(s);
    }

    uint32_t qa[HD / 16][4];
    static_for<P::kParts>([&](auto part) {
        constexpr int PART = decltype(part)::value;
        float acc[P::kNT][4];
#pragma unroll
        for (int j = 0; j < P::kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        for (int c = 0; c < nc; ++c) {
            const int s = PART * nc + c;
            __syncthreads();   // every warp is done with step s - 1's stage (and the barriers are set up)
            if (threadIdx.x == 0 && s + kStages - 1 < steps) load(s + kStages - 1);
            mbar_wait(bars + 8 * (s % kStages), (s / kStages) & 1);   // step s has landed
            const __nv_bfloat16* sX = stage_x(s);
            plane_project<HD>(acc, sX, sX + rows * kXC, row0);
        }
        plane_epilogue<HD, PART>(acc, qa, sK, sV, bq + col0, bk + col0, bv + col0, row0);
    });
    __syncthreads();   // K and V of every row are resident

    // pass 1: the row statistics over the resident K in 64-key chunks
    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
    for_key_chunks<64>(n, [&](auto cols, int k0) {
        constexpr int C = decltype(cols)::value;
        float sc[C / 8][4];
        dot_tile_swz<HD, C>(qa, sK + k0 * HD, sc);
        scale_mask<C>(sc, scale, k0, n);
        online_stats<C>(m, l, sc);
    });
    // pass 2: P rounded to bf16, P.V accumulated in f32, o written; 32-key
    // chunks keep the live dot products to 16 registers
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    const float ml2[2] = {__fmul_rn(m[0], kLog2e), __fmul_rn(m[1], kLog2e)};
    const float sl2 = __fmul_rn(scale, kLog2e);
    float acc[HD / 8][4];
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
    for_key_chunks<32>(n, [&](auto cols, int k0) {
        constexpr int C = decltype(cols)::value;
        float dd[C / 8][4];
        dot_tile_swz<HD, C>(qa, sK + k0 * HD, dd);
        mask_dots<C>(dd, k0, n);
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
            pv_step_swz<HD, C>(acc, dd, sl2, ml2, rl, sV + k0 * HD, kk);
    });
    warp_store_bf16<HD>(o + static_cast<long long>(b) * n * ldw + col0, ldw, acc, row0, n);
}

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime
// (the library is not linked against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// a bf16 tensor map of `rank` dims (innermost first; strides in bytes of the
// outer dims), boxes of `box`, out-of-bounds elements read as zeros
bool encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encode_tiled();
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                    strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
                     == CUDA_SUCCESS;
}

template <int HD>
int launch_plane(const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
                 const void* bk, const void* bv, void* o, int batch, int n, int d, int heads,
                 float scale, cudaStream_t stream) {
    using B = __nv_bfloat16;
    const int rows = plane_rows(n);
    PlaneMaps maps;
    const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                                 static_cast<cuuint64_t>(batch)};
    const cuuint64_t xstrides[2] = {sizeof(B) * static_cast<cuuint64_t>(d),
                                    sizeof(B) * static_cast<cuuint64_t>(d) * n};
    const cuuint32_t xbox[3] = {kXC, static_cast<cuuint32_t>(rows / 2), 1};
    const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(heads) * HD, static_cast<cuuint64_t>(d)};
    const cuuint64_t wstrides[1] = {sizeof(B) * static_cast<cuuint64_t>(heads) * HD};
    const cuuint32_t wbox[2] = {kWC, kXC};
    if (!encode_bf16(&maps.x, x, 3, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B)
        || !encode_bf16(&maps.wk, wk, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B)
        || !encode_bf16(&maps.wv, wv, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B)
        || !encode_bf16(&maps.wq, wq, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = plane_smem_bytes(n, HD);
    auto kernel = qkv_attention_plane_bf16_kernel<HD>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch * heads, 32 * plane_warps(n), smem, stream>>>(
        maps, static_cast<const B*>(bq), static_cast<const B*>(bk), static_cast<const B*>(bv),
        static_cast<B*>(o), n, d, heads, scale);
    return static_cast<int>(cudaGetLastError());
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

// 1: the plane path, 0: the tiled path (bf16, and the f32 kernel)
int variant(int dtype, int n, int hd) {
    return dtype == 1 && (hd == 32 || hd == 64) && n <= 16 * kPlaneMaxWarps
           && plane_smem_bytes(n, hd) <= kMaxSmem;
}

size_t smem_bytes(int dtype, int n, int hd) {
    if (dtype != 1) return smem_bytes_f32(n, hd);
    return variant(dtype, n, hd) ? plane_smem_bytes(n, hd) : smem_bytes_bf16(n, hd);
}

template <typename T, int HD>
int launch(const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
           const void* bk, const void* bv, void* o, int batch, int n, int d, int heads,
           float scale, cudaStream_t stream) {
    const dim3 grid(batch * heads);
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
        const size_t smem = smem_bytes(1, n, HD);
        if (smem > kMaxSmem || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
        if constexpr (HD <= 64) {
            if (variant(1, n, HD))
                return launch_plane<HD>(x, wq, wk, wv, bq, bk, bv, o, batch, n, d, heads, scale,
                                        stream);
        }
        using B = __nv_bfloat16;
        auto kernel = qkv_attention_bf16_kernel<HD>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
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
    return static_cast<long long>(smem_bytes(dtype, n, hd));
}

// which kernel irw_qkv_attention runs for (dtype, n, hd): 1 the plane path,
// 0 the tiled path (bf16) or the f32 kernel
extern "C" int irw_qkv_attention_variant(int dtype, int n, int hd) { return variant(dtype, n, hd); }

extern "C" long long irw_qkv_attention_max_smem() { return static_cast<long long>(kMaxSmem); }

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
