// Fused multi-head attention forward for short sequences:
//   o = softmax(q k^T * scale) v   per (batch, head),
// q, k, v, o in the public layout (B, N, H, hd), read and written through
// element strides (the last axis contiguous), bf16 or f32.
//
// Replaces: irw_tpu/ops/vmem_attention.py, fused_attention -> _fwd_call
// (kernel body _fwd_kernel).  Same rounding as the TPU kernel: scores and
// softmax in f32, the NORMALISED probabilities rounded to the input dtype,
// then P.V accumulated in f32 and cast to the output dtype.
//
// Bound on the H100 at the flagship (B = 4 bands * 64 = 256, N = 257, H = 6,
// hd = 64, bf16): memory.  q, k, v read and o written are 4 * 50.5 MB =
// 202 MB, about 60 us at 3.35 TB/s; the 4 B H N^2 hd = 26 GFLOP of the two
// products take about 26 us at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design, shared by both paths:
// - one thread block per (batch * head, 64-row query tile): at N = 257 that
//   is 5 tiles, the last holding one row.  The (N, N) scores never reach
//   device memory, as on the TPU, where one grid step held the whole key axis
//   in VMEM.  A Hopper block has 227 KB of shared memory, not VMEM's
//   megabytes, so the key axis is walked in tiles of 64 keys, the ragged tail
//   masked to -inf.
// - TWO passes over the key tiles.  Pass 1 computes each row's max and sum
//   in f32 (online, rescaling the sum when the max grows).  Pass 2 recomputes
//   the scores, forms the normalised P = exp(s - max) / sum, rounds it to the
//   input dtype and accumulates P.V in f32.  A one-pass online softmax would
//   round the unnormalised exponentials instead, which the TPU kernel never
//   does; at N = 257 the extra q k^T costs little.
//
// bf16 (the flagship): tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate).  4 warps, each owning 16 query rows.  Q, K and V tiles sit in
// shared memory as bf16 with rows padded by 16 bytes so the fragment loads
// do not conflict on banks; Q's fragments stay in registers for the whole
// block.  The f32 score fragments of q k^T are laid out exactly as the A
// operand of the P.V product wants them, so the normalised P is rounded to
// bf16 and fed from registers (V's fragments come through ldmatrix.trans).
//
// f32: plain FMAs, 256 threads, each owning a 4 x 4 block of the 64 x 64
// score tile (rows ty + 16 i, keys tx + 16 j) and 4 x hd/16 outputs; rows of
// the f32 tiles padded by one float.
//
// Not yet: wgmma, TMA, cp.async double buffering, a single pass.

#include "attention_common.cuh"

namespace {

using namespace irw;

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile

// ------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ------------------------------------------------------------------------

constexpr int kWarps = 4;                       // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;

// this warp's 16 x 64 score tile: s[j] is the m16n8 fragment of keys
// k0 + 8 j .. 8 j + 7; rows g and g + 8 of the warp's slice, columns 2 t, 2 t + 1
template <int HD>
__device__ __forceinline__ void score_tile_mma(const uint32_t (&qa)[HD / 16][4],
                                               const __nv_bfloat16* sK, float scale,
                                               int k0, int n, float (&s)[kBK / 8][4]) {
    constexpr int kLd = HD + kTilePad;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
            const __nv_bfloat16* kr = sK + (j * 8 + g) * kLd + ks * 16 + t * 2;
            mma_bf16(s[j], qa[ks], ld32(kr), ld32(kr + 8));
        }
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
        const int key = k0 + j * 8 + t * 2;
        const bool v0 = key < n, v1 = key + 1 < n;
        s[j][0] = v0 ? s[j][0] * scale : neg_inf();
        s[j][1] = v1 ? s[j][1] * scale : neg_inf();
        s[j][2] = v0 ? s[j][2] * scale : neg_inf();
        s[j][3] = v1 ? s[j][3] * scale : neg_inf();
    }
}

// at most 128 registers a thread for hd <= 64, so four blocks share an SM
// (133 uncapped left room for three; measured faster on the H100, PERF.md)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 64 ? 4 : 2)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int n, int heads, float scale, Strides sq, Strides sk, Strides sv,
                          Strides so) {
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
        score_tile_mma<HD>(qa, sK, scale, k0, n, s);
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
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int k0 = tile * kBK;
        __syncthreads();
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, sk.n, k0, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sV, vb, sv.n, k0, n);
        __syncthreads();
        float s[kBK / 8][4];
        score_tile_mma<HD>(qa, sK, scale, k0, n, s);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(expf(s[2 * kk][0] - m[0]) / l[0], expf(s[2 * kk][1] - m[0]) / l[0]);
            pa[1] = pack_bf16(expf(s[2 * kk][2] - m[1]) / l[1], expf(s[2 * kk][3] - m[1]) / l[1]);
            pa[2] = pack_bf16(expf(s[2 * kk + 1][0] - m[0]) / l[0],
                              expf(s[2 * kk + 1][1] - m[0]) / l[0]);
            pa[3] = pack_bf16(expf(s[2 * kk + 1][2] - m[1]) / l[1],
                              expf(s[2 * kk + 1][3] - m[1]) / l[1]);
            // V rows kk*16 .. +15: lanes 0-7 / 8-15 address the two 8-key halves
            // of head-dim tile jn, lanes 16-31 the same for tile jn + 1
            const int mat = lane >> 3;
            const __nv_bfloat16* vr = sV + (kk * 16 + (lane & 7) + (mat & 1) * 8) * kLd
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

    warp_store_bf16<HD>(o + b * so.b + h * so.h, so.n, acc, q0 + warp * 16, n);
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
                         const float* __restrict__ v, float* __restrict__ o, int n, int heads,
                         float scale, Strides sq, Strides sk, Strides sv, Strides so) {
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
                sP[(ty + kFmaSide * i) * kLdP + tx + kFmaSide * j] = expf(s[i][j] - m[i]) / l[i];
        __syncthreads();
        fma_accumulate_f32<HD, kBK, kBQ>(acc, sP, kLdP, sV);
    }
    fma_store_f32<HD, kBQ>(ob, so.n, acc, q0, n);
}

// ------------------------------------------------------------------------
// launch
// ------------------------------------------------------------------------

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
           float scale, Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t stream) {
    const dim3 grid(batch * heads, (n + kBQ - 1) / kBQ);
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
        const size_t smem = sizeof(__nv_bfloat16) * 3 * kBK * (HD + kTilePad);
        auto kernel = attention_fwd_bf16_kernel<HD>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid, kMmaThreads, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, heads,
            scale, sq, sk, sv, so);
    } else {
        constexpr int ld = HD + 1;
        const size_t smem = sizeof(float) * (kBQ * ld + 2 * kBK * ld + kBQ * kLdP);
        auto kernel = attention_fwd_f32_kernel<HD>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid, kFmaThreads, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o), n, heads, scale,
            sq, sk, sv, so);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int batch,
                int n, int heads, float scale, Strides sq, Strides sk, Strides sv,
                Strides so, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(q, k, v, o, batch, n, heads, scale, sq, sk, sv, so, stream);
        case 64: return launch<T, 64>(q, k, v, o, batch, n, heads, scale, sq, sk, sv, so, stream);
        case 128: return launch<T, 128>(q, k, v, o, batch, n, heads, scale, sq, sk, sv, so, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, token,
// head) for each of q, k, v, o; the head_dim axis must be contiguous.  For
// bf16 every row start must be 16-byte aligned (strides multiples of 8).
extern "C" int irw_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 int dtype, int batch, int n, int heads, int hd,
                                 float scale,
                                 long long qsb, long long qsn, long long qsh,
                                 long long ksb, long long ksn, long long ksh,
                                 long long vsb, long long vsn, long long vsh,
                                 long long osb, long long osn, long long osh,
                                 void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh}, so{osb, osn, osh};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch_hd<float>(hd, q, k, v, o, batch, n, heads, scale, sq, sk, sv, so, st);
    if (dtype == 1)
        return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, batch, n, heads, scale, sq, sk, sv, so, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
