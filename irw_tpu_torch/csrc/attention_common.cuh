// Device primitives shared by the attention kernels (attention_fwd.cu, K2,
// attention_bwd.cu, K3, and flash_attention_{fwd,bwd}.cu, K6): the bf16
// tensor-core product mma.sync m16n8k16 with its fragment loads, the quad
// reductions over the four lanes that hold one row of an m16n8 accumulator
// fragment, and K6's tile helpers for both paths.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace irw {

// element strides of a (batch, token, head, head_dim) tensor; head_dim contiguous
struct Strides {
    long long b, n, h;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// c += a . b for one m16n8k16 tile: bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------------
// Tile helpers of the flash-attention kernels (K6).  bf16 tiles sit in
// shared memory with rows padded by 16 bytes (fragment loads without bank
// conflicts); a warp owns 16 rows of the left operand.
// ------------------------------------------------------------------------

constexpr int kTilePad = 8;  // bf16 elements per padded smem row

// rows row0 .. row0 + ROWS - 1 of an (n, HD) bf16 matrix (row stride in
// elements) into a padded smem tile, 16-byte loads; rows at or past n are zero
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int row0, int n) {
    constexpr int kVec = 8, kPerRow = HD / kVec, kLd = HD + kTilePad;
    for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += THREADS) {
        const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
        const int row = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < n) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
    }
}

// d[j] = A . B^T for this warp: A the warp's 16 rows at sA, B the COLS rows
// of sB; d[j] is the m16n8 fragment of B rows 8 j .. 8 j + 7 (rows g and
// g + 8 of the warp's slice, columns 2 t and 2 t + 1 of the n-tile)
template <int HD, int COLS>
__device__ __forceinline__ void warp_dot_bf16(const __nv_bfloat16* sA, const __nv_bfloat16* sB,
                                              float (&d)[COLS / 8][4]) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
    const __nv_bfloat16* ar = sA + g * kLd + t * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t a[4] = {ld32(ar + ks * 16), ld32(ar + 8 * kLd + ks * 16),
                               ld32(ar + ks * 16 + 8), ld32(ar + 8 * kLd + ks * 16 + 8)};
#pragma unroll
        for (int j = 0; j < COLS / 8; ++j) {
            const __nv_bfloat16* br = sB + (j * 8 + g) * kLd + ks * 16 + t * 2;
            mma_bf16(d[j], a, ld32(br), ld32(br + 8));
        }
    }
}

// the A fragments of x's 16-column step kk (f32 m16n8 fragments x[2 kk],
// x[2 kk + 1]), rounded to bf16
template <int COLS>
__device__ __forceinline__ void pack_a_bf16(uint32_t (&xa)[4], const float (&x)[COLS / 8][4], int kk) {
    xa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// acc (16 x HD per warp) += X . R where X (16 x KROWS) is given as m16n8
// fragments (rounded to bf16 here) and R is the KROWS x HD smem tile sR
template <int HD, int KROWS>
__device__ __forceinline__ void warp_accumulate_bf16(float (&acc)[HD / 8][4],
                                                     const float (&x)[KROWS / 8][4],
                                                     const __nv_bfloat16* sR) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < KROWS / 16; ++kk) {
        uint32_t xa[4];
        pack_a_bf16<KROWS>(xa, x, kk);
        // R rows kk*16 .. +15: lanes 0-7 / 8-15 address the two 8-row halves
        // of column tile jn, lanes 16-31 the same for tile jn + 1
        const __nv_bfloat16* rr = sR + (kk * 16 + (lane & 7) + (mat & 1) * 8) * kLd + (mat >> 1) * 8;
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
__device__ __forceinline__ void warp_store_bf16(__nv_bfloat16* dst, long long row_stride,
                                                const float (&acc)[HD / 8][4], int row0, int n) {
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int row = row0 + g;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
        const int col = jn * 8 + t * 2;
        if (row < n)
            *reinterpret_cast<uint32_t*>(dst + row * row_stride + col) = pack_bf16(acc[jn][0], acc[jn][1]);
        if (row + 8 < n)
            *reinterpret_cast<uint32_t*>(dst + (row + 8) * row_stride + col) =
                pack_bf16(acc[jn][2], acc[jn][3]);
    }
}

// f32 path: plain FMAs, 16 x 16 threads; a thread owns rows ty + 16 i of the
// left operand and rows tx + 16 j of the right one; smem rows padded by one float
constexpr int kFmaSide = 16;
constexpr int kFmaThreads = kFmaSide * kFmaSide;

// reductions over the 16 lanes that share a ty (a half warp)
__device__ __forceinline__ float row16_max(float v) {
    for (int off = kFmaSide / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}
__device__ __forceinline__ float row16_sum(float v) {
    for (int off = kFmaSide / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long row_stride,
                                              int row0, int n) {
    constexpr int ld = HD + 1;
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += kFmaThreads) {
        const int r = idx / HD, d = idx % HD;
        const int row = row0 + r;
        dst[r * ld + d] = row < n ? src[row * row_stride + d] : 0.f;
    }
}

// d[i][j] = <A row ty + 16 i, B row tx + 16 j>
template <int HD, int ROWS_A, int ROWS_B>
__device__ __forceinline__ void fma_dot_f32(const float* sA, const float* sB,
                                            float (&d)[ROWS_A / kFmaSide][ROWS_B / kFmaSide]) {
    constexpr int ld = HD + 1, kR = ROWS_A / kFmaSide, kC = ROWS_B / kFmaSide;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) d[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
        float av[kR], bv[kC];
#pragma unroll
        for (int i = 0; i < kR; ++i) av[i] = sA[(ty + kFmaSide * i) * ld + c];
#pragma unroll
        for (int j = 0; j < kC; ++j) bv[j] = sB[(tx + kFmaSide * j) * ld + c];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
            for (int j = 0; j < kC; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
    }
}

// acc[i][c] += sum_kk sX[(ty + 16 i) * ldx + kk] * sR[kk][tx + 16 c]
template <int HD, int KROWS, int ROWS>
__device__ __forceinline__ void fma_accumulate_f32(float (&acc)[ROWS / kFmaSide][HD / kFmaSide],
                                                   const float* sX, int ldx, const float* sR) {
    constexpr int ld = HD + 1;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
#pragma unroll 4
    for (int kk = 0; kk < KROWS; ++kk) {
        float rv[HD / kFmaSide];
#pragma unroll
        for (int c = 0; c < HD / kFmaSide; ++c) rv[c] = sR[kk * ld + tx + kFmaSide * c];
#pragma unroll
        for (int i = 0; i < ROWS / kFmaSide; ++i) {
            const float x = sX[(ty + kFmaSide * i) * ldx + kk];
#pragma unroll
            for (int c = 0; c < HD / kFmaSide; ++c) acc[i][c] = fmaf(x, rv[c], acc[i][c]);
        }
    }
}

template <int HD, int ROWS>
__device__ __forceinline__ void fma_store_f32(float* dst, long long row_stride,
                                              const float (&acc)[ROWS / kFmaSide][HD / kFmaSide],
                                              int row0, int n) {
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
#pragma unroll
    for (int i = 0; i < ROWS / kFmaSide; ++i) {
        const int row = row0 + ty + kFmaSide * i;
        if (row < n) {
#pragma unroll
            for (int c = 0; c < HD / kFmaSide; ++c) dst[row * row_stride + tx + kFmaSide * c] = acc[i][c];
        }
    }
}

}  // namespace irw
