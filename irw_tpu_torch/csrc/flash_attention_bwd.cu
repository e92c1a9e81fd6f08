// Flash attention backward: given q, k, v, the output gradient do, the
// forward's f32 row statistics l (sum) and m (max) and di = rowsum(o * do),
// compute dq, dk, dv per (batch, head).  q, k, v, do, dq, dk, dv are in the
// public layout (B, N, H, hd), read and written through element strides
// (the last axis contiguous), bf16 or f32; l, m, di are f32 (B, H, N).
//
// Replaces: the backward of JAX's library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), reached from
// irw_tpu/models/vit.py:_flash_mha: _flash_attention_bwd_dkv (pallas_call
// :1121, kernel body :796-938) and _flash_attention_bwd_dq (pallas_call
// :1456, kernel body :1146-1284); di is computed outside both, as in JAX
// (:273-275).  Same math and rounding points:
//   s  = f32(q k^T) * scale (1/sqrt(hd)), then + MASK_VALUE at keys >= n
//   p  = exp(s - m) * (1 / l)          (a reciprocal, then a product)
//   dv = sum dtype(p)^T do             f32 accumulate over query tiles
//   ds = (do v^T - di) * p * scale
//   dk = sum dtype(ds)^T q,  dq = sum dtype(ds) k, each cast once.
// The key mask as in the forward (flash_attention_fwd.cu).
//
// Bound on the H100 at the flagship training shape (B = 4 bands * 96 = 384,
// N = 257, H = 6, hd = 64, bf16): memory.  q, k, v, do read and dq, dk, dv
// written are 7 * 75.8 MB = 530 MB (plus 3 * 2.4 MB of l, m, di), 0.160 ms
// at 3.35 TB/s; the four products of the library's backward (q k^T, do v^T,
// p^T do, ds^T q) and dq = ds k, 10 B H N^2 hd = 97 GFLOP, take 0.098 ms at
// the 989 TFLOP/s bf16 tensor-core peak.
//
// Design.  The TPU ran two grids, each walking its reduction axis in order
// with an f32 accumulator in VMEM scratch.  Here each becomes a kernel whose
// thread block owns the rows it writes, so no atomics are needed:
// - dK/dV: one block per (batch * head, 64-key tile), looping over the
//   64-query tiles: s^T = k q^T and dp^T = v do^T, then p and ds from the
//   saved (m, 1/l, di) of those queries, dv += p^T do and dk += ds^T q in
//   registers.
// - dQ: one block per (batch * head, 64-query tile), looping over the
//   64-key tiles: s, p, dp and ds as above, dq += ds k in registers.
// Rows past n are zero in shared memory and get m = +inf (p = 0), so they
// add nothing; keys past n have zero k and v, so they add nothing to dq.
// bf16: mma.sync m16n8k16, 4 warps of 16 rows, as K3 (attention_bwd.cu);
// f32: plain FMAs, 256 threads of 4 x 4 outputs of a 64 x 64 tile.
//
// Not yet: wgmma, TMA, pipelined tile loads, one kernel instead of two.

#include <cmath>

#include "attention_common.cuh"

namespace {

using namespace irw;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
// the library's DEFAULT_MASK_VALUE, -0.7 * float32 max, rounded once from double
constexpr float kMask = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Args {
    const void *q, *k, *v, *dout;
    void *dq, *dk, *dv;
    const float *l, *m, *di;  // (batch * heads, n) each
    int n, heads;
    float scale;
    Strides sq, sk, sv, sdo, sdq, sdk, sdv;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s, int b, int h) {
    return static_cast<const T*>(base) + b * s.b + h * s.h;
}
template <typename T>
__device__ __forceinline__ T* at(void* base, const Strides& s, int b, int h) {
    return static_cast<T*>(base) + b * s.b + h * s.h;
}

// the statistics of query rows q0 .. q0 + kBQ - 1 into shared memory: m,
// 1 / l (the library's reciprocal) and di; rows past n get p = 0
template <int THREADS>
__device__ __forceinline__ void load_row_stats(float* sM, float* sLi, float* sDi, const Args& a,
                                               long long base, int q0) {
    for (int i = threadIdx.x; i < kBQ; i += THREADS) {
        const int row = q0 + i;
        const bool ok = row < a.n;
        sM[i] = ok ? a.m[base + row] : pos_inf();
        sLi[i] = ok ? 1.f / a.l[base + row] : 1.f;
        sDi[i] = ok ? a.di[base + row] : 0.f;
    }
}

// ------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ------------------------------------------------------------------------

// dk and dv of one 64-key tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_bf16_kernel(const Args a) {
    constexpr int kLd = HD + kTilePad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // kBK x kLd
    bf16* sV = sK + kBK * kLd;                      // kBK x kLd
    bf16* sQ = sV + kBK * kLd;                      // kBQ x kLd
    bf16* sO = sQ + kBQ * kLd;                      // kBQ x kLd: do
    float* sM = reinterpret_cast<float*>(sO + kBQ * kLd);  // kBQ each: m, 1 / l, di
    float* sLi = sM + kBQ;
    float* sDi = sLi + kBQ;

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int k0 = blockIdx.y * kBK, n = a.n;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const long long base = static_cast<long long>(bh) * n;
    const bf16* qb = at<bf16>(a.q, a.sq, b, h);
    const bf16* ob = at<bf16>(a.dout, a.sdo, b, h);

    load_tile_bf16<HD, kBK, kMmaThreads>(sK, at<bf16>(a.k, a.sk, b, h), a.sk.n, k0, n);
    load_tile_bf16<HD, kBK, kMmaThreads>(sV, at<bf16>(a.v, a.sv, b, h), a.sv.n, k0, n);
    const bf16* wK = sK + warp * 16 * kLd;
    const bf16* wV = sV + warp * 16 * kLd;
    const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
    const bool masked[2] = {key0 >= n, key0 + 8 >= n};

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[jn][e] = dv[jn][e] = 0.f;

    const int ntiles = (n + kBQ - 1) / kBQ;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kBQ;
        __syncthreads();  // readers of the previous tile are done
        load_tile_bf16<HD, kBQ, kMmaThreads>(sQ, qb, a.sq.n, q0, n);
        load_tile_bf16<HD, kBQ, kMmaThreads>(sO, ob, a.sdo.n, q0, n);
        load_row_stats<kMmaThreads>(sM, sLi, sDi, a, base, q0);
        __syncthreads();
        // s^T (this warp's 16 keys x 64 queries) and dp^T = v do^T
        float p[kBQ / 8][4], ds[kBQ / 8][4];
        warp_dot_bf16<HD, kBQ>(wK, sQ, p);
        warp_dot_bf16<HD, kBQ>(wV, sO, ds);
#pragma unroll
        for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = j * 8 + t * 2 + (e & 1);
                float x = p[j][e] * a.scale;
                if (masked[e >> 1]) x += kMask;
                p[j][e] = expf(x - sM[col]) * sLi[col];
                ds[j][e] = (ds[j][e] - sDi[col]) * p[j][e] * a.scale;
            }
        warp_accumulate_bf16<HD, kBQ>(dv, p, sO);
        warp_accumulate_bf16<HD, kBQ>(dk, ds, sQ);
    }

    const int row0 = k0 + warp * 16;
    warp_store_bf16<HD>(at<bf16>(a.dk, a.sdk, b, h), a.sdk.n, dk, row0, n);
    warp_store_bf16<HD>(at<bf16>(a.dv, a.sdv, b, h), a.sdv.n, dv, row0, n);
}

// dq of one 64-query tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const Args a) {
    constexpr int kLd = HD + kTilePad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBQ x kLd
    bf16* sO = sQ + kBQ * kLd;                      // kBQ x kLd: do
    bf16* sK = sO + kBQ * kLd;                      // kBK x kLd
    bf16* sV = sK + kBK * kLd;                      // kBK x kLd

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const long long base = static_cast<long long>(bh) * n;
    const bf16* kb = at<bf16>(a.k, a.sk, b, h);
    const bf16* vb = at<bf16>(a.v, a.sv, b, h);

    load_tile_bf16<HD, kBQ, kMmaThreads>(sQ, at<bf16>(a.q, a.sq, b, h), a.sq.n, q0, n);
    load_tile_bf16<HD, kBQ, kMmaThreads>(sO, at<bf16>(a.dout, a.sdo, b, h), a.sdo.n, q0, n);
    const bf16* wQ = sQ + warp * 16 * kLd;
    const bf16* wO = sO + warp * 16 * kLd;
    // this thread's rows row0 (index 0) and row0 + 8 (index 1)
    const int row0 = q0 + warp * 16 + g;
    float m[2], li[2], di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool ok = row < n;
        m[r] = ok ? a.m[base + row] : pos_inf();
        li[r] = ok ? 1.f / a.l[base + row] : 1.f;
        di[r] = ok ? a.di[base + row] : 0.f;
    }

    float dq[HD / 8][4];
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) dq[jn][0] = dq[jn][1] = dq[jn][2] = dq[jn][3] = 0.f;
    const int ntiles = (n + kBK - 1) / kBK;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int k0 = tile * kBK;
        __syncthreads();  // readers of the previous tile are done
        load_tile_bf16<HD, kBK, kMmaThreads>(sK, kb, a.sk.n, k0, n);
        load_tile_bf16<HD, kBK, kMmaThreads>(sV, vb, a.sv.n, k0, n);
        __syncthreads();
        float s[kBK / 8][4], ds[kBK / 8][4];
        warp_dot_bf16<HD, kBK>(wQ, sK, s);
        warp_dot_bf16<HD, kBK>(wO, sV, ds);  // dp = do v^T
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int key = k0 + j * 8 + t * 2 + (e & 1);
                float x = s[j][e] * a.scale;
                if (key >= n) x += kMask;
                const float p = expf(x - m[r]) * li[r];
                ds[j][e] = (ds[j][e] - di[r]) * p * a.scale;
            }
        warp_accumulate_bf16<HD, kBK>(dq, ds, sK);
    }
    warp_store_bf16<HD>(at<bf16>(a.dq, a.sdq, b, h), a.sdq.n, dq, q0 + warp * 16, n);
}

// ------------------------------------------------------------------------
// f32: plain FMA path
// ------------------------------------------------------------------------

constexpr int kRows = kBQ / kFmaSide;  // tile rows per thread
constexpr int kCols = kBK / kFmaSide;  // tile columns per thread
constexpr int kLdP = kBK + 1;
static_assert(kBQ == kBK, "the f32 tiles of p and ds are square");

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dkv_f32_kernel(const Args a) {
    constexpr int ld = HD + 1, kOut = HD / kFmaSide;
    extern __shared__ float smem[];
    float* sK = smem;               // kBK x ld
    float* sV = sK + kBK * ld;      // kBK x ld
    float* sQ = sV + kBK * ld;      // kBQ x ld
    float* sO = sQ + kBQ * ld;      // kBQ x ld: do
    float* sP = sO + kBQ * ld;      // kBK x kLdP: p^T
    float* sD = sP + kBK * kLdP;    // kBK x kLdP: ds^T
    float* sM = sD + kBK * kLdP;    // kBQ each: m, 1 / l, di
    float* sLi = sM + kBQ;
    float* sDi = sLi + kBQ;

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int k0 = blockIdx.y * kBK, n = a.n;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const long long base = static_cast<long long>(bh) * n;
    const float* qb = at<float>(a.q, a.sq, b, h);
    const float* ob = at<float>(a.dout, a.sdo, b, h);

    load_tile_f32<HD, kBK>(sK, at<float>(a.k, a.sk, b, h), a.sk.n, k0, n);
    load_tile_f32<HD, kBK>(sV, at<float>(a.v, a.sv, b, h), a.sv.n, k0, n);

    float dk[kRows][kOut], dv[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) dk[i][c] = dv[i][c] = 0.f;

    const int ntiles = (n + kBQ - 1) / kBQ;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int q0 = tile * kBQ;
        __syncthreads();
        load_tile_f32<HD, kBQ>(sQ, qb, a.sq.n, q0, n);
        load_tile_f32<HD, kBQ>(sO, ob, a.sdo.n, q0, n);
        load_row_stats<kFmaThreads>(sM, sLi, sDi, a, base, q0);
        __syncthreads();
        // s^T and dp^T: rows are keys ty + 16 i, columns queries tx + 16 j
        float s[kRows][kCols], dp[kRows][kCols];
        fma_dot_f32<HD, kBK, kBQ>(sK, sQ, s);
        fma_dot_f32<HD, kBK, kBQ>(sV, sO, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const bool masked = k0 + ty + kFmaSide * i >= n;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int col = tx + kFmaSide * j;
                float x = s[i][j] * a.scale;
                if (masked) x += kMask;
                const float p = expf(x - sM[col]) * sLi[col];
                sP[(ty + kFmaSide * i) * kLdP + col] = p;
                sD[(ty + kFmaSide * i) * kLdP + col] = (dp[i][j] - sDi[col]) * p * a.scale;
            }
        }
        __syncthreads();
        fma_accumulate_f32<HD, kBQ, kBK>(dv, sP, kLdP, sO);
        fma_accumulate_f32<HD, kBQ, kBK>(dk, sD, kLdP, sQ);
    }

    fma_store_f32<HD, kBK>(at<float>(a.dk, a.sdk, b, h), a.sdk.n, dk, k0, n);
    fma_store_f32<HD, kBK>(at<float>(a.dv, a.sdv, b, h), a.sdv.n, dv, k0, n);
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dq_f32_kernel(const Args a) {
    constexpr int ld = HD + 1, kOut = HD / kFmaSide;
    extern __shared__ float smem[];
    float* sQ = smem;             // kBQ x ld
    float* sO = sQ + kBQ * ld;    // kBQ x ld: do
    float* sK = sO + kBQ * ld;    // kBK x ld
    float* sV = sK + kBK * ld;    // kBK x ld
    float* sP = sV + kBK * ld;    // kBQ x kLdP: ds

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const long long base = static_cast<long long>(bh) * n;
    const float* kb = at<float>(a.k, a.sk, b, h);
    const float* vb = at<float>(a.v, a.sv, b, h);

    load_tile_f32<HD, kBQ>(sQ, at<float>(a.q, a.sq, b, h), a.sq.n, q0, n);
    load_tile_f32<HD, kBQ>(sO, at<float>(a.dout, a.sdo, b, h), a.sdo.n, q0, n);
    float m[kRows], li[kRows], di[kRows], dq[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = q0 + ty + kFmaSide * i;
        const bool ok = row < n;
        m[i] = ok ? a.m[base + row] : pos_inf();
        li[i] = ok ? 1.f / a.l[base + row] : 1.f;
        di[i] = ok ? a.di[base + row] : 0.f;
#pragma unroll
        for (int c = 0; c < kOut; ++c) dq[i][c] = 0.f;
    }

    const int ntiles = (n + kBK - 1) / kBK;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int k0 = tile * kBK;
        __syncthreads();
        load_tile_f32<HD, kBK>(sK, kb, a.sk.n, k0, n);
        load_tile_f32<HD, kBK>(sV, vb, a.sv.n, k0, n);
        __syncthreads();
        float s[kRows][kCols], dp[kRows][kCols];
        fma_dot_f32<HD, kBQ, kBK>(sQ, sK, s);
        fma_dot_f32<HD, kBQ, kBK>(sO, sV, dp);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                float x = s[i][j] * a.scale;
                if (k0 + tx + kFmaSide * j >= n) x += kMask;
                const float p = expf(x - m[i]) * li[i];
                sP[(ty + kFmaSide * i) * kLdP + tx + kFmaSide * j] = (dp[i][j] - di[i]) * p * a.scale;
            }
        __syncthreads();
        fma_accumulate_f32<HD, kBK, kBQ>(dq, sP, kLdP, sK);
    }
    fma_store_f32<HD, kBQ>(at<float>(a.dq, a.sdq, b, h), a.sdq.n, dq, q0, n);
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
    const int bh = batch * a.heads;
    const dim3 grid_kv(bh, (a.n + kBK - 1) / kBK), grid_q(bh, (a.n + kBQ - 1) / kBQ);
    int err;
    if constexpr (sizeof(T) == 2) {
        const size_t tiles = sizeof(bf16) * 2 * (kBQ + kBK) * (HD + kTilePad);
        err = launch_one(flash_bwd_dkv_bf16_kernel<HD>, grid_kv, kMmaThreads,
                         tiles + sizeof(float) * 3 * kBQ, a, stream);
        if (err != 0) return err;
        return launch_one(flash_bwd_dq_bf16_kernel<HD>, grid_q, kMmaThreads, tiles, a, stream);
    } else {
        const size_t tiles = sizeof(float) * 2 * (kBQ + kBK) * (HD + 1);
        err = launch_one(flash_bwd_dkv_f32_kernel<HD>, grid_kv, kFmaThreads,
                         tiles + sizeof(float) * (2 * kBK * kLdP + 3 * kBQ), a, stream);
        if (err != 0) return err;
        return launch_one(flash_bwd_dq_f32_kernel<HD>, grid_q, kFmaThreads,
                          tiles + sizeof(float) * kBQ * kLdP, a, stream);
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
// head) for each of q, k, v, do, dq, dk, dv; the head_dim axis must be
// contiguous, and for bf16 every row start 16-byte aligned.  l, m and di are
// f32 (batch * heads, n), contiguous.  The scale is 1/sqrt(hd).  Two kernels
// run, in order, on ``stream``.
extern "C" int irw_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       const float* l, const float* m, const float* di,
                                       int dtype, int batch, int n, int heads, int hd,
                                       long long qsb, long long qsn, long long qsh,
                                       long long ksb, long long ksn, long long ksh,
                                       long long vsb, long long vsn, long long vsh,
                                       long long dosb, long long dosn, long long dosh,
                                       long long dqsb, long long dqsn, long long dqsh,
                                       long long dksb, long long dksn, long long dksh,
                                       long long dvsb, long long dvsn, long long dvsh,
                                       void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0 || hd <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    // as the wrapper's plain version: 1 / sqrt in double, rounded once to float
    const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
    const Args a{q, k, v, dout, dq, dk, dv, l, m, di, n, heads, scale,
                 Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
                 Strides{dosb, dosn, dosh}, Strides{dqsb, dqsn, dqsh},
                 Strides{dksb, dksn, dksh}, Strides{dvsb, dvsn, dvsh}};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_hd<float>(hd, a, batch, st);
    if (dtype == 1) return dispatch_hd<bf16>(hd, a, batch, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
