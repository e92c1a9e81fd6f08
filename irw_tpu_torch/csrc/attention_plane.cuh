// Device helpers of the plane-resident attention kernels (attention_fwd.cu,
// K2, and attention_bwd.cu, K3): whole (batch, head) planes copied into
// shared memory with cp.async, the key axis walked in the same 64-key
// chunks by every kernel that forms row statistics, and the online row
// max / sum update with its roundings spelled out, so that the forward's
// saved statistics and the backward's recomputed ones are the same bits.
// The tile helpers of attention_common.cuh (K5, K6 use them) stay as they
// are.
#pragma once

#include "attention_common.cuh"

namespace irw {

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src is
// then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// rows 0 .. rows - 1 of an (n, HD) bf16 matrix (row stride in elements) into
// a padded smem tile (row stride HD + kTilePad), issued by the whole block;
// rows at or past n are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int rows, int n) {
    constexpr int kVec = 8, kPerRow = HD / kVec, kLd = HD + kTilePad;
    for (int idx = threadIdx.x; idx < rows * kPerRow; idx += blockDim.x) {
        const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
        const bool valid = r < n;
        cp_async16(dst + r * kLd + c, src + (valid ? r * row_stride + c : 0), valid);
    }
}

// the A fragments (m16 x k16 steps) of 16 rows of a bf16 matrix in global
// memory, rows at or past n zero: row0 + g and row0 + g + 8 of this lane
template <int HD>
__device__ __forceinline__ void load_a_global(uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* src,
                                              long long row_stride, int row0, int n) {
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int r0 = row0 + g, r1 = r0 + 8;
    const __nv_bfloat16* p0 = src + r0 * row_stride + t * 2;
    const __nv_bfloat16* p1 = src + r1 * row_stride + t * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        qa[ks][0] = r0 < n ? ld32(p0 + ks * 16) : 0u;
        qa[ks][1] = r1 < n ? ld32(p1 + ks * 16) : 0u;
        qa[ks][2] = r0 < n ? ld32(p0 + ks * 16 + 8) : 0u;
        qa[ks][3] = r1 < n ? ld32(p1 + ks * 16 + 8) : 0u;
    }
}

// the same from a padded smem tile (16 rows at sA)
template <int HD>
__device__ __forceinline__ void load_a_smem(uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* sA) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* r = sA + g * kLd + t * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        qa[ks][0] = ld32(r + ks * 16);
        qa[ks][1] = ld32(r + 8 * kLd + ks * 16);
        qa[ks][2] = ld32(r + ks * 16 + 8);
        qa[ks][3] = ld32(r + 8 * kLd + ks * 16 + 8);
    }
}

// a chunk width as a type, for the chunk loop's generic lambdas
template <int V>
struct Cols {
    static constexpr int value = V;
};

// f(Cols<w>{}, k0) for the key chunks k0 = 0, W, 2 W, ... of n keys: full
// chunks are W wide (64, 32 or 16) and the last one is cut to the 16-key
// multiple that holds its keys.  The keys a cut chunk leaves out are masked
// keys, whose -inf scores add exact zeros to the row sums, so with W = 64 a
// kernel that walks full 64-key tiles (the tiled kernels) gets the same
// statistics bit for bit
template <int W, typename F>
__device__ __forceinline__ void for_key_chunks(int n, F&& f) {
    static_assert(W == 64 || W == 32 || W == 16, "chunks of 64, 32 or 16 keys");
    for (int k0 = 0; k0 < n; k0 += W) {
        const int rem = n - k0;
        if constexpr (W == 64) {
            if (rem > 48) f(Cols<64>{}, k0);
            else if (rem > 32) f(Cols<48>{}, k0);
            else if (rem > 16) f(Cols<32>{}, k0);
            else f(Cols<16>{}, k0);
        } else if constexpr (W == 32) {
            if (rem > 16) f(Cols<32>{}, k0);
            else f(Cols<16>{}, k0);
        } else {
            f(Cols<16>{}, k0);
        }
    }
}

// exp(x) on the bf16 paths: 2^(x log2 e) on the special-function unit
// (ex2.approx.ftz: about two f32 ulps, results below 2^-126 flushed to 0),
// the argument formed by one FMA.  P is rounded to bf16 (8 bits) after
// it, so the f32 exp's last bits move a bf16 P no more than another
// summation order does; libm's expf is a chain of about eight dependent
// instructions per score, which bounded these kernels
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// one chunk's update of the online row max m and sum l of exp(s - m), rows
// g (index 0) and g + 8 (index 1) of an m16 score fragment; every rounding
// is explicit, so all kernels that run it over the same chunks agree
template <int COLS>
__device__ __forceinline__ void online_stats(float (&m)[2], float (&l)[2],
                                             const float (&s)[COLS / 8][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float tmax = neg_inf();
#pragma unroll
        for (int j = 0; j < COLS / 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float mnew = fmaxf(m[r], quad_max(tmax));
        const float ml2 = __fmul_rn(mnew, kLog2e);
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < COLS / 8; ++j)
            part = __fadd_rn(part, __fadd_rn(ex2(__fmaf_rn(s[j][2 * r], kLog2e, -ml2)),
                                             ex2(__fmaf_rn(s[j][2 * r + 1], kLog2e, -ml2))));
        l[r] = __fmaf_rn(l[r], ex2(__fmaf_rn(m[r], kLog2e, -ml2)), quad_sum(part));
        m[r] = mnew;
    }
}

// the normalised probability exp(s - m) / l of the f32 paths as
// exp(s - m) * (1 / l), with rl = 1 / l rounded once per row (__frcp_rn):
// within one f32 ulp of the true quotient, one multiply per score instead
// of a division
__device__ __forceinline__ float prob(float s, float m, float rl) {
    return __fmul_rn(expf(__fsub_rn(s, m)), rl);
}

// the bf16 paths' probability from an unscaled dot product d, with the
// scale and the max carried in base 2 (sl2 = scale log2 e, ml2 = m log2 e):
// 2^(d sl2 - ml2) / l, the argument in one FMA
__device__ __forceinline__ float prob_dot(float d, float sl2, float ml2, float rl) {
    return __fmul_rn(ex2(__fmaf_rn(d, sl2, -ml2)), rl);
}

// the same from a scaled score s (the tiled bf16 kernels)
__device__ __forceinline__ float prob_score(float s, float ml2, float rl) {
    return __fmul_rn(ex2(__fmaf_rn(s, kLog2e, -ml2)), rl);
}

// scores of a COLS-key chunk from its dot products: d * scale, keys at or
// past n at -inf; only a chunk that reaches n pays for the mask (the same
// bits as score_tile_bf16)
template <int COLS>
__device__ __forceinline__ void scale_mask(float (&s)[COLS / 8][4], float scale, int k0, int n) {
    const int t = threadIdx.x & 3;
    if (k0 + COLS <= n) {
#pragma unroll
        for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] *= scale;
        return;
    }
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
        const int key = k0 + j * 8 + t * 2;
        const bool v0 = key < n, v1 = key + 1 < n;
        s[j][0] = v0 ? s[j][0] * scale : neg_inf();
        s[j][1] = v1 ? s[j][1] * scale : neg_inf();
        s[j][2] = v0 ? s[j][2] * scale : neg_inf();
        s[j][3] = v1 ? s[j][3] * scale : neg_inf();
    }
}

// dot products of a COLS-key chunk for prob_dot: keys at or past n at -inf
// (so p = 0), the rest untouched
template <int COLS>
__device__ __forceinline__ void mask_dots(float (&d)[COLS / 8][4], int k0, int n) {
    if (k0 + COLS <= n) return;
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
        const int key = k0 + j * 8 + t * 2;
        if (key >= n) d[j][0] = d[j][2] = neg_inf();
        if (key + 1 >= n) d[j][1] = d[j][3] = neg_inf();
    }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// Fragment loads of the plane paths: one ldmatrix.x4 brings a k-step's A
// fragment of 16 rows, or the B fragments of two n8 tiles, where 32-bit
// loads took four (the same values, so the same products).  The lane's row
// and column of the 8 x 8 matrix it addresses:
//   A (16 rows x k16): row lane % 8 + 8 (mat % 2), column 8 (mat / 2);
//   B (rows of n-tiles j, j + 1 x k16): row lane % 8 + 8 (mat / 2), column
//   8 (mat % 2);  mat = lane / 8.
__device__ __forceinline__ int ldm_a_row() { return (threadIdx.x & 7) + ((threadIdx.x >> 3) & 1) * 8; }
__device__ __forceinline__ int ldm_a_col() { return ((threadIdx.x >> 4) & 1) * 8; }
__device__ __forceinline__ int ldm_b_row() { return (threadIdx.x & 7) + ((threadIdx.x >> 4) & 1) * 8; }
__device__ __forceinline__ int ldm_b_col() { return ((threadIdx.x >> 3) & 1) * 8; }

// this warp's 16 x COLS dot products q k^T from Q's A fragments qa and the
// COLS key rows of a padded tile at sK: the products of score_tile_bf16, in
// the same order
template <int HD, int COLS>
__device__ __forceinline__ void dot_tile(const uint32_t (&qa)[HD / 16][4], const __nv_bfloat16* sK,
                                         float (&d)[COLS / 8][4]) {
    constexpr int kLd = HD + kTilePad;
    const __nv_bfloat16* br = sK + ldm_b_row() * kLd + ldm_b_col();
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int j = 0; j < COLS / 8; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, br + j * 8 * kLd + ks * 16);
            mma_bf16(d[j], qa[ks], bf[0], bf[1]);
            mma_bf16(d[j + 1], qa[ks], bf[2], bf[3]);
        }
    }
}

// d[j] = A . B^T for this warp, A the 16 rows of a padded tile at sA, B the
// COLS rows at sB: warp_dot_bf16's products, in the same order
template <int HD, int COLS>
__device__ __forceinline__ void warp_dot_ldm(const __nv_bfloat16* sA, const __nv_bfloat16* sB,
                                             float (&d)[COLS / 8][4]) {
    constexpr int kLd = HD + kTilePad;
    const __nv_bfloat16* ar = sA + ldm_a_row() * kLd + ldm_a_col();
    const __nv_bfloat16* br = sB + ldm_b_row() * kLd + ldm_b_col();
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, ar + ks * 16);
#pragma unroll
        for (int j = 0; j < COLS / 8; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, br + j * 8 * kLd + ks * 16);
            mma_bf16(d[j], a, bf[0], bf[1]);
            mma_bf16(d[j + 1], a, bf[2], bf[3]);
        }
    }
}

// ------------------------------------------------------------------------
// Unpadded bf16 tiles whose 16-byte chunks are XOR-swizzled by row: the
// fragment loads of a warp (8 rows, one chunk each) hit distinct banks, as
// with the padded tiles, at 128 bytes a row instead of 144 (hd = 64).  The
// swizzle of a row depends on its index modulo 8, so a chunk that starts at
// a multiple of 16 rows may be addressed from its own base.
// ------------------------------------------------------------------------

// element offset of (row, col) in a swizzled HD-wide tile
template <int HD>
__device__ __forceinline__ int swz(int row, int col) {
    constexpr int kChunks = HD / 8;
    const int key = kChunks >= 8 ? (row & 7) : ((row >> 1) & (kChunks - 1));
    return row * HD + ((((col >> 3) ^ key)) << 3) + (col & 7);
}

// rows 0 .. rows - 1 of an (n, HD) bf16 matrix into a swizzled tile with
// cp.async, issued by the whole block; rows at or past n are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows_async_swz(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                    long long row_stride, int rows, int n) {
    constexpr int kVec = 8, kPerRow = HD / kVec;
    for (int idx = threadIdx.x; idx < rows * kPerRow; idx += blockDim.x) {
        const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
        const bool valid = r < n;
        cp_async16(dst + swz<HD>(r, c), src + (valid ? r * row_stride + c : 0), valid);
    }
}

// dot_tile over COLS key rows of a swizzled tile at sK (chunk base): the
// same products in the same order, so the same bits
template <int HD, int COLS>
__device__ __forceinline__ void dot_tile_swz(const uint32_t (&qa)[HD / 16][4],
                                             const __nv_bfloat16* sK, float (&d)[COLS / 8][4]) {
    const int row = ldm_b_row(), col = ldm_b_col();
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int j = 0; j < COLS / 8; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, sK + swz<HD>(j * 8 + row, ks * 16 + col));
            mma_bf16(d[j], qa[ks], bf[0], bf[1]);
            mma_bf16(d[j + 1], qa[ks], bf[2], bf[3]);
        }
    }
}

// acc (16 x HD) += bf16(P) . V for keys kk * 16 .. + 15 of a chunk of dot
// products d (mask_dots applied): P = prob_dot(d), rounded to bf16 and fed
// from registers, V from a swizzled tile at sV (chunk base) through
// ldmatrix.trans
template <int HD, int COLS>
__device__ __forceinline__ void pv_step_swz(float (&acc)[HD / 8][4], const float (&d)[COLS / 8][4],
                                            float sl2, const float (&ml2)[2],
                                            const float (&rl)[2], const __nv_bfloat16* sV,
                                            int kk) {
    const int lane = threadIdx.x % 32, mat = lane >> 3;
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float(&x)[4] = d[2 * kk + h];
        pa[2 * h] = pack_bf16(prob_dot(x[0], sl2, ml2[0], rl[0]), prob_dot(x[1], sl2, ml2[0], rl[0]));
        pa[2 * h + 1] =
            pack_bf16(prob_dot(x[2], sl2, ml2[1], rl[1]), prob_dot(x[3], sl2, ml2[1], rl[1]));
    }
    // V rows kk*16 .. +15: lanes 0-7 / 8-15 address the two 8-key halves of
    // head-dim tile jn, lanes 16-31 the same for tile jn + 1
    const int row = kk * 16 + (lane & 7) + (mat & 1) * 8;
#pragma unroll
    for (int jn = 0; jn < HD / 8; jn += 2) {
        uint32_t vfrag[4];
        ldmatrix_x4_trans(vfrag, sV + swz<HD>(row, (jn + (mat >> 1)) * 8));
        mma_bf16(acc[jn], pa, vfrag[0], vfrag[1]);
        mma_bf16(acc[jn + 1], pa, vfrag[2], vfrag[3]);
    }
}

// f32 paths: one row's online update over a thread's kCols scores, reduced
// over the 16 lanes of a half warp (the FMA tiles of attention_common.cuh)
template <int kCols>
__device__ __forceinline__ void online_stats_f32(float& m, float& l, const float (&s)[kCols]) {
    float tmax = s[0];
#pragma unroll
    for (int j = 1; j < kCols; ++j) tmax = fmaxf(tmax, s[j]);
    const float mnew = fmaxf(m, row16_max(tmax));
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) part = __fadd_rn(part, expf(__fsub_rn(s[j], mnew)));
    l = __fmaf_rn(l, expf(__fsub_rn(m, mnew)), row16_sum(part));
    m = mnew;
}

}  // namespace irw
