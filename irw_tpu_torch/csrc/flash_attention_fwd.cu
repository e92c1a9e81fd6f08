// Flash attention forward over 128-key blocks:
//   o = softmax(q k^T * scale + key mask) v   per (batch, head), scale = 1/sqrt(hd),
// q, k, v, o in the public layout (B, N, H, hd), read and written through
// element strides (the last axis contiguous), bf16 or f32; optionally the
// f32 row statistics l (sum) and m (max), (B, H, N), for the backward.
//
// Replaces: JAX's library flash attention, reached from
// irw_tpu/models/vit.py:_flash_mha (:268-296) through flash_attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, pallas_call in
// _flash_attention_impl, :758).  Same math and rounding points as the
// library's kernels at its default 128 x 128 blocks:
//   per 128-key block, in order:
//     s      = f32(q k^T) * scale, then + MASK_VALUE at keys >= n
//     m_next = max(m_prev, rowmax(s));  p = exp(s - m_next)
//     l_corr = exp(m_prev - m_next) * l_prev;  l_next = rowsum(p) + l_corr
//     inv    = l_next == 0 ? 1 : 1 / l_next
//     acc    = acc * (l_corr * inv) + f32(dtype(p) v) * inv
//   o = dtype(acc) once.  A single block (N <= 128) is the library's
//   one-step kernel: p = exp(s - m) / l (a division), o = dtype(p) v.
// A key mask replaces _flash_mha's padding and segment ids: keys past n (up
// to the next multiple of 128) are zero-filled in shared memory like the
// padding, their scores get MASK_VALUE = -0.7 * FLT_MAX added (not -inf, so
// exp(s - m) is exactly 0 and a fully masked block stays finite), and rows
// past n are never stored.
//
// Bound on the H100 at the flagship's served attention (B = 4 bands * 64 =
// 256, N = 257, H = 6, hd = 64, bf16): memory.  q, k, v read and o written
// are 4 * 50.5 MB = 202 MB, 60 us at 3.35 TB/s; the two products, 4 B H N^2
// hd = 26 GFLOP, take 26 us at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design.  On the TPU the grid walked the key blocks in order, carrying m,
// l and acc in VMEM scratch from one grid step to the next.  Hopper blocks
// run in no order, so one thread block owns a (batch * head, 64-query tile)
// and loops over the key blocks itself, holding m, l and acc in registers.
// A block of 128 keys and values is 2 * 128 * (hd + 8) bf16 in shared
// memory (34 KB at hd = 64), small enough for three blocks per SM.
// bf16: tensor cores through mma.sync m16n8k16, 4 warps of 16 query rows;
// the f32 score fragments of q k^T are laid out as the A operand of P.V, so
// p is rounded to bf16 in registers; V's fragments come through
// ldmatrix.trans.  f32: plain FMAs, 256 threads, each owning 4 rows x 8 keys
// of the 64 x 128 score tile, p staged in shared memory for P.V.
//
// Not yet: wgmma, TMA, cp.async double buffering of the key blocks.

#include <cmath>

#include "attention_common.cuh"

namespace {

using namespace irw;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;   // query rows per thread block
constexpr int kBK = 128;  // keys per step: the library's block_k
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
// the library's DEFAULT_MASK_VALUE, -0.7 * float32 max, rounded once from double
constexpr float kMask = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Args {
    const void *q, *k, *v;
    void* o;
    float *l, *m;  // (batch * heads, n) each, or both null
    int n, heads;
    float scale;
    Strides sq, sk, sv, so;
};

// ------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 64 ? 3 : 2)
flash_fwd_bf16_kernel(const Args a) {
    constexpr int kLd = HD + kTilePad;
    constexpr int kNT = HD / 8;  // n-tiles over head_dim
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBQ x kLd
    bf16* sK = sQ + kBQ * kLd;                      // kBK x kLd
    bf16* sV = sK + kBK * kLd;                      // kBK x kLd

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
    const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
    load_tile_bf16<HD, kBQ, kMmaThreads>(
        sQ, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h, a.sq.n, q0, n);
    const bf16* wQ = sQ + warp * 16 * kLd;
    // this thread's rows: row0 (index 0) and row0 + 8 (index 1)
    const int row0 = q0 + warp * 16 + g;
    // V fragments of P.V: lanes 0-7 / 8-15 address the two 8-key halves of a
    // 16-key step for head-dim tile jn, lanes 16-31 the same for tile jn + 1
    const int mat = lane >> 3;
    const bf16* vr = sV + ((lane & 7) + (mat & 1) * 8) * kLd + (mat >> 1) * 8;

    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
    float acc[kNT][4];
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
    const int nblocks = (n + kBK - 1) / kBK;
    const bool one_step = nblocks == 1;
    for (int blk = 0; blk < nblocks; ++blk) {
        const int k0 = blk * kBK;
        __syncthreads();  // readers of the previous block are done
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, a.sk.n, k0, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sV, vb, a.sv.n, k0, n);
        __syncthreads();
        float s[kBK / 8][4];
        warp_dot_bf16<HD, kBK>(wQ, sK, s);
        float keep[2], inv[2];  // acc = acc * keep + o_curr * inv
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float mc = neg_inf();
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int key = k0 + j * 8 + t * 2 + c;
                    float x = s[j][2 * r + c] * a.scale;
                    if (key >= n) x += kMask;
                    s[j][2 * r + c] = x;
                    mc = fmaxf(mc, x);
                }
            const float m_next = fmaxf(m[r], quad_max(mc));
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float p = expf(s[j][2 * r + c] - m_next);
                    s[j][2 * r + c] = p;
                    part += p;
                }
            const float rowsum = quad_sum(part);
            if (one_step) {  // the library's single-step kernel: p / l, no rescaling
#pragma unroll
                for (int j = 0; j < kBK / 8; ++j) {
                    s[j][2 * r] = s[j][2 * r] / rowsum;
                    s[j][2 * r + 1] = s[j][2 * r + 1] / rowsum;
                }
                keep[r] = 0.f;
                inv[r] = 1.f;
                l[r] = rowsum;
            } else {
                const float l_corr = expf(m[r] - m_next) * l[r];
                const float l_next = rowsum + l_corr;
                inv[r] = l_next == 0.f ? 1.f : 1.f / l_next;
                keep[r] = l_corr * inv[r];
                l[r] = l_next;
            }
            m[r] = m_next;
        }
        // o_curr = bf16(p) . V accumulated in f32, two head-dim tiles at a time
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) pack_a_bf16<kBK>(pa[kk], s, kk);
#pragma unroll
        for (int jn = 0; jn < kNT; jn += 2) {
            float oc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, vr + kk * 16 * kLd + jn * 8);
                mma_bf16(oc[0], pa[kk], vf[0], vf[1]);
                mma_bf16(oc[1], pa[kk], vf[2], vf[3]);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc[jn + u][e] = acc[jn + u][e] * keep[e >> 1] + oc[u][e] * inv[e >> 1];
        }
    }

    warp_store_bf16<HD>(static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h, a.so.n, acc,
                        q0 + warp * 16, n);
    if (a.l != nullptr && t == 0) {
        const long long base = static_cast<long long>(bh) * n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row < n) {
                a.l[base + row] = l[r];
                a.m[base + row] = m[r];
            }
        }
    }
}

// ------------------------------------------------------------------------
// f32: plain FMA path
// ------------------------------------------------------------------------

constexpr int kRows = kBQ / kFmaSide;  // query rows per thread
constexpr int kCols = kBK / kFmaSide;  // keys per thread
constexpr int kLdP = kBK + 1;

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32_kernel(const Args a) {
    constexpr int ld = HD + 1;
    constexpr int kOut = HD / kFmaSide;  // output columns per thread
    extern __shared__ float smem[];
    float* sQ = smem;             // kBQ x ld
    float* sK = sQ + kBQ * ld;    // kBK x ld
    float* sV = sK + kBK * ld;    // kBK x ld
    float* sP = sV + kBK * ld;    // kBQ x kLdP

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
    const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
    load_tile_f32<HD, kBQ>(sQ, static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h,
                           a.sq.n, q0, n);

    float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        m[i] = neg_inf();
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
    }
    const int nblocks = (n + kBK - 1) / kBK;
    const bool one_step = nblocks == 1;
    for (int blk = 0; blk < nblocks; ++blk) {
        const int k0 = blk * kBK;
        __syncthreads();
        load_tile_f32<HD, kBK>(sK, kb, a.sk.n, k0, n);
        load_tile_f32<HD, kBK>(sV, vb, a.sv.n, k0, n);
        __syncthreads();
        float s[kRows][kCols];
        fma_dot_f32<HD, kBQ, kBK>(sQ, sK, s);
        float keep[kRows], inv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            float mc = neg_inf();
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                float x = s[i][j] * a.scale;
                if (k0 + tx + kFmaSide * j >= n) x += kMask;
                s[i][j] = x;
                mc = fmaxf(mc, x);
            }
            const float m_next = fmaxf(m[i], row16_max(mc));
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                s[i][j] = expf(s[i][j] - m_next);
                part += s[i][j];
            }
            const float rowsum = row16_sum(part);
            if (one_step) {
#pragma unroll
                for (int j = 0; j < kCols; ++j) s[i][j] = s[i][j] / rowsum;
                keep[i] = 0.f;
                inv[i] = 1.f;
                l[i] = rowsum;
            } else {
                const float l_corr = expf(m[i] - m_next) * l[i];
                const float l_next = rowsum + l_corr;
                inv[i] = l_next == 0.f ? 1.f : 1.f / l_next;
                keep[i] = l_corr * inv[i];
                l[i] = l_next;
            }
            m[i] = m_next;
#pragma unroll
            for (int j = 0; j < kCols; ++j) sP[(ty + kFmaSide * i) * kLdP + tx + kFmaSide * j] = s[i][j];
        }
        __syncthreads();
        float oc[kRows][kOut];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int c = 0; c < kOut; ++c) oc[i][c] = 0.f;
        fma_accumulate_f32<HD, kBK, kBQ>(oc, sP, kLdP, sV);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int c = 0; c < kOut; ++c) acc[i][c] = acc[i][c] * keep[i] + oc[i][c] * inv[i];
    }

    fma_store_f32<HD, kBQ>(static_cast<float*>(a.o) + b * a.so.b + h * a.so.h, a.so.n, acc, q0, n);
    if (a.l != nullptr && tx == 0) {
        const long long base = static_cast<long long>(bh) * n;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int row = q0 + ty + kFmaSide * i;
            if (row < n) {
                a.l[base + row] = l[i];
                a.m[base + row] = m[i];
            }
        }
    }
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
int launch(const Args& a, int batch, cudaStream_t stream) {
    const dim3 grid(batch * a.heads, (a.n + kBQ - 1) / kBQ);
    if constexpr (sizeof(T) == 2) {
        const size_t smem = sizeof(bf16) * (kBQ + 2 * kBK) * (HD + kTilePad);
        return launch_one(flash_fwd_bf16_kernel<HD>, grid, kMmaThreads, smem, a, stream);
    } else {
        const size_t smem = sizeof(float) * ((kBQ + 2 * kBK) * (HD + 1) + kBQ * kLdP);
        return launch_one(flash_fwd_f32_kernel<HD>, grid, kFmaThreads, smem, a, stream);
    }
}

template <typename T>
int dispatch_hd(int hd, const Args& a, int batch, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(a, batch, stream);
        case 64: return launch<T, 64>(a, batch, stream);
        case 128: return launch<T, 128>(a, batch, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, token,
// head) for each of q, k, v, o; the head_dim axis must be contiguous, and
// for bf16 every row start 16-byte aligned.  l and m are f32 (batch * heads,
// n) outputs, written only when both are non-null.  The scale is 1/sqrt(hd).
extern "C" int irw_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       float* l, float* m, int dtype, int batch, int n,
                                       int heads, int hd,
                                       long long qsb, long long qsn, long long qsh,
                                       long long ksb, long long ksn, long long ksh,
                                       long long vsb, long long vsn, long long vsh,
                                       long long osb, long long osn, long long osh,
                                       void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0 || hd <= 0 || (l == nullptr) != (m == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    // as the wrapper's plain version: 1 / sqrt in double, rounded once to float
    const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
    const Args a{q, k, v, o, l, m, n, heads, scale,
                 Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
                 Strides{osb, osn, osh}};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_hd<float>(hd, a, batch, st);
    if (dtype == 1) return dispatch_hd<bf16>(hd, a, batch, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
