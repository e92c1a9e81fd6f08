// Flash attention backward: given q, k, v, the forward's output o, the
// output gradient do and the forward's f32 row statistics l (sum) and m
// (max), compute dq, dk, dv per (batch, head).  q, k, v, o, do, dq, dk, dv
// are in the public layout (B, N, H, hd), read and written through element
// strides (the last axis contiguous), bf16 or f32; l, m are f32 (B, H, N).
//
// Replaces: the backward of JAX's library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), reached from
// irw_tpu/models/vit.py:_flash_mha: di = rowsum(o * do) (:273-275),
// _flash_attention_bwd_dkv (pallas_call :1121, kernel body :796-938) and
// _flash_attention_bwd_dq (pallas_call :1456, kernel body :1146-1284).
// Same math and rounding points:
//   di = sum_d f32(o) f32(do)          per query row
//   s  = f32(q k^T) * scale (1/sqrt(hd)), keys >= n masked (p = 0)
//   p  = exp(s - m) * (1 / l)          (a reciprocal, then a product)
//   dv = sum dtype(p)^T do             f32 accumulate
//   ds = (do v^T - di) * p * scale
//   dk = sum dtype(ds)^T q,  dq = sum dtype(ds) k, each cast once.
// The library adds MASK_VALUE (-0.7 FLT_MAX) to the scores of masked keys,
// so their p is exactly 0; here their p is 0 by a -inf argument or a zero
// key row, the same bits.
//
// Bound on the H100 at the flagship training shape (B = 4 bands * 96 = 384,
// N = 257, H = 6, hd = 64, bf16): memory.  q, k, v, o, do read and dq, dk,
// dv written are 8 * 75.8 MB = 606 MB (plus 2 * 2.4 MB of l and m), 0.181
// ms at 3.35 TB/s; the five products (q k^T, do v^T, p^T do, ds^T q, ds k),
// 10 B H N^2 hd = 97 GFLOP, take 0.098 ms at the 989 TFLOP/s bf16 peak.
//
// bf16, plane path (the flagship; hd <= 64 and N <= 272): one thread block
// per (batch * head) plane, which owns the plane's dq, dk and dv: one
// launch, no atomics.  The block copies do, then k, q, v of the plane into
// shared memory once with cp.async (156 KB at the flagship, one block an
// SM: ceil16(N) / 16 warps, 17 at N = 257, fill the register file at 96
// registers a thread, so a swizzled unpadded layout would buy no second
// block).  Each warp owns 16 query rows and 16 key rows.  First, while q,
// k, v are in flight, each warp forms di for its rows from o, read from
// device memory once, and the resident do, and puts m log2 e, 1 / l and di
// of its rows into shared memory; one barrier.  Then two passes with no
// barrier, as K3's plane path (attention_bwd.cu), seven products where K3
// needs nine (di needs no pass over the keys):
// - query-major, the warp's 16 queries over 16-key steps: s and dp (q k^T,
//   do v^T), ds in registers, dq += bf16(ds) k; dq written;
// - key-major, the warp's 16 keys over 16-query steps: s^T and dp^T
//   (k q^T, v do^T), p and ds rounded to bf16 A fragments, dv += p^T do,
//   dk += ds^T q (do and q through ldmatrix.trans).
// exp is the special-function unit's 2^x (ex2.approx) with the scale and m
// carried in base 2, the argument in one FMA (attention_plane.cuh's
// prob_dot), and fragments come through ldmatrix: f32-level reorderings of
// the same arithmetic before each bf16 rounding.
//
// Tiled path (bf16 with hd = 128 or N > 272, and f32): two kernels, each
// owning the rows it writes.  dQ first: one block per (batch * head,
// 64-query tile) forms di of its rows (one thread a row, into a workspace),
// then loops over the 64-key tiles: s, p, dp and ds, dq += ds k.  Then
// dK/dV: one block per (batch * head, 64-key tile) loops over the 64-query
// tiles: s^T = k q^T and dp^T = v do^T, p and ds from the saved (m, 1/l)
// and the workspace's di, dv += p^T do and dk += ds^T q.  Rows past n are
// zero in shared memory and get m = +inf (p = 0); keys past n have zero k
// and v, so they add nothing to dq.  bf16: mma.sync m16n8k16, 4 warps of
// 16 rows, libm expf; f32: plain FMAs, 256 threads of 4 x 4 outputs of a
// 64 x 64 tile, expf.
//
// Not yet: wgmma, TMA, a plane path for hd = 128 or longer N.

#include <cmath>

#include "attention_plane.cuh"

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
    const void *q, *k, *v, *o, *dout;
    void *dq, *dk, *dv;
    const float *l, *m;  // (batch * heads, n) each
    float* di;           // (batch * heads, n): the tiled path's workspace
    int n, heads;
    float scale;
    Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s, int b, int h) {
    return static_cast<const T*>(base) + b * s.b + h * s.h;
}
template <typename T>
__device__ __forceinline__ T* at(void* base, const Strides& s, int b, int h) {
    return static_cast<T*>(base) + b * s.b + h * s.h;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// the tiled dQ kernels' di: rows row0 .. row0 + ROWS - 1, one thread a row,
// o from device memory and do from the smem tile sDo (ld elements a row);
// into sDi and the workspace (rows past n: 0, not stored)
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void tile_di(float* sDi, const Args& a, const T* ob, const T* sDo,
                                        int ld, int row0) {
    for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
        const int row = row0 + i;
        float s = 0.f;
        if (row < a.n) {
            const T* orow = ob + row * a.so.n;
#pragma unroll 8
            for (int c = 0; c < HD; ++c) s = fmaf(to_f32(orow[c]), to_f32(sDo[i * ld + c]), s);
            a.di[static_cast<long long>(blockIdx.x) * a.n + row] = s;
        }
        sDi[i] = s;
    }
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
// bf16, plane path: one block per (batch * head) plane, q, k, v, do resident
// ------------------------------------------------------------------------

constexpr int kPlaneMaxKeys = 272;                 // 17 tiles of 16 rows, one warp each
constexpr int kPlaneMaxWarps = kPlaneMaxKeys / 16;

size_t plane_smem(int n, int hd) {
    const int nk = round_up(n, 16);
    return sizeof(bf16) * 4 * nk * (hd + kTilePad) + sizeof(float) * 3 * nk;
}

// acc (16 x HD) += X . R for one k16 step: X's A fragments xa already
// rounded to bf16, R the 16 x HD rows of a padded tile at sR through
// ldmatrix.trans (K3's accumulate_a, attention_bwd.cu)
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

// sum += f32(x) f32(y) over 8 bf16 of x (device memory) and y (shared memory)
__device__ __forceinline__ float dot8(const bf16* x, const bf16* y, float sum) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x);
    const uint4 yv = *reinterpret_cast<const uint4*>(y);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(x2[j]), yf = __bfloat1622float2(y2[j]);
        sum = fmaf(xf.x, yf.x, sum);
        sum = fmaf(xf.y, yf.y, sum);
    }
    return sum;
}

// 17 warps leave at most 96 registers a thread (5 warps on one of the SM's
// four register files)
template <int HD>
__global__ void __launch_bounds__(32 * kPlaneMaxWarps, 1)
flash_bwd_plane_bf16_kernel(const Args a) {
    constexpr int kLd = HD + kTilePad, kNT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n = a.n, nk = round_up(n, 16);
    bf16* sO = reinterpret_cast<bf16*>(smem_raw);  // nk x kLd: do
    bf16* sQ = sO + nk * kLd;                       // nk x kLd
    bf16* sK = sQ + nk * kLd;                       // nk x kLd
    bf16* sV = sK + nk * kLd;                       // nk x kLd
    float* sM = reinterpret_cast<float*>(sV + nk * kLd);  // nk each: m log2 e, 1 / l, di
    float* sR = sM + nk;
    float* sDi = sR + nk;

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const float scale = a.scale, sl2 = __fmul_rn(a.scale, kLog2e);
    // do first (di), then k, q, v
    load_rows_async<HD>(sO, at<bf16>(a.dout, a.sdo, b, h), a.sdo.n, nk, n);
    cp_async_commit();
    load_rows_async<HD>(sK, at<bf16>(a.k, a.sk, b, h), a.sk.n, nk, n);
    load_rows_async<HD>(sQ, at<bf16>(a.q, a.sq, b, h), a.sq.n, nk, n);
    load_rows_async<HD>(sV, at<bf16>(a.v, a.sv, b, h), a.sv.n, nk, n);
    cp_async_commit();

    // this warp's 16 rows: di = sum f32(o) f32(do), two lanes a row, each
    // over half of head_dim; m log2 e and 1 / l from the forward's (rows
    // past n: m = +inf, so p = 0 in both passes)
    const int q0 = warp * 16;
    cp_async_wait<1>();
    __syncthreads();  // do has landed
    {
        const int row = q0 + (lane >> 1), c0 = (lane & 1) * (HD / 2);
        float di = 0.f;
        if (row < n) {
            const bf16* orow = at<bf16>(a.o, a.so, b, h) + row * a.so.n + c0;
            const bf16* drow = sO + row * kLd + c0;
#pragma unroll
            for (int c = 0; c < HD / 2; c += 8) di = dot8(orow + c, drow + c, di);
        }
        di += __shfl_xor_sync(0xffffffffu, di, 1);
        if ((lane & 1) == 0) {
            const long long st = static_cast<long long>(bh) * n + row;
            sDi[row] = di;
            sM[row] = row < n ? __fmul_rn(a.m[st], kLog2e) : pos_inf();
            sR[row] = row < n ? __frcp_rn(a.l[st]) : 1.f;
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // q, k, v and every row's statistics are in place

    // query-major pass, this warp's 16 queries over 16-key steps: ds in
    // registers, dq = ds k, written
    {
        const int r0 = q0 + g, r1 = r0 + 8;
        const float ml2[2] = {sM[r0], sM[r1]}, rl[2] = {sR[r0], sR[r1]};
        const float di[2] = {sDi[r0], sDi[r1]};
        uint32_t qa[HD / 16][4];
        load_a_smem<HD>(qa, sQ + q0 * kLd);
        const bf16* wO = sO + q0 * kLd;
        float acc[kNT][4];
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
        for_key_chunks<16>(n, [&](auto, int k0) {
            float d[2][4], ds[2][4];
            dot_tile<HD, 16>(qa, sK + k0 * kLd, d);
            mask_dots<16>(d, k0, n);
            warp_dot_ldm<HD, 16>(wO, sV + k0 * kLd, ds);  // dp = do v^T
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    ds[j][e] = (ds[j][e] - di[e >> 1])
                               * prob_dot(d[j][e], sl2, ml2[e >> 1], rl[e >> 1]) * scale;
            warp_accumulate_bf16<HD, 16>(acc, ds, sK + k0 * kLd);
        });
        warp_store_bf16<HD>(at<bf16>(a.dq, a.sdq, b, h), a.sdq.n, acc, q0, n);
    }

    // key-major pass, this warp's 16 keys over 16-query steps: s^T = k q^T and
    // dp^T = v do^T once per step, p and ds rounded to bf16 A fragments, then
    // dv += bf16(p)^T do and dk += ds^T q; no barrier.  Keys at or past n
    // need no mask: their rows of dk and dv are never stored, and a row of an
    // mma product reads only its own A row
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
            warp_dot_ldm<HD, 16>(sV + key0 * kLd, sO + qs * kLd, ds);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = qs + j * 8 + t * 2 + (e & 1);
                    p[j][e] = prob_dot(p[j][e], sl2, sM[col], sR[col]);
                    ds[j][e] = (ds[j][e] - sDi[col]) * p[j][e] * scale;
                }
            pack_a_bf16<16>(pa, p, 0);
            pack_a_bf16<16>(da, ds, 0);
        }
        accumulate_a<HD>(dv, pa, sO + qs * kLd);
        accumulate_a<HD>(dk, da, sQ + qs * kLd);
    }
    warp_store_bf16<HD>(at<bf16>(a.dk, a.sdk, b, h), a.sdk.n, dk, key0, n);
    warp_store_bf16<HD>(at<bf16>(a.dv, a.sdv, b, h), a.sdv.n, dv, key0, n);
}

// ------------------------------------------------------------------------
// bf16, tiled path: mma.sync, one block per (plane, 64-row tile)
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

// di and dq of one 64-query tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_bf16_kernel(const Args a) {
    constexpr int kLd = HD + kTilePad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // kBQ x kLd
    bf16* sO = sQ + kBQ * kLd;                      // kBQ x kLd: do
    bf16* sK = sO + kBQ * kLd;                      // kBK x kLd
    bf16* sV = sK + kBK * kLd;                      // kBK x kLd
    float* sDi = reinterpret_cast<float*>(sV + kBK * kLd);  // kBQ

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const long long base = static_cast<long long>(bh) * n;
    const bf16* kb = at<bf16>(a.k, a.sk, b, h);
    const bf16* vb = at<bf16>(a.v, a.sv, b, h);

    load_tile_bf16<HD, kBQ, kMmaThreads>(sQ, at<bf16>(a.q, a.sq, b, h), a.sq.n, q0, n);
    load_tile_bf16<HD, kBQ, kMmaThreads>(sO, at<bf16>(a.dout, a.sdo, b, h), a.sdo.n, q0, n);
    __syncthreads();
    tile_di<bf16, HD, kBQ>(sDi, a, at<bf16>(a.o, a.so, b, h), sO, kLd, q0);
    __syncthreads();
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
        di[r] = sDi[row - q0];
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
    float* sDi = sP + kBQ * kLdP;  // kBQ

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int q0 = blockIdx.y * kBQ, n = a.n;
    const int tx = threadIdx.x % kFmaSide, ty = threadIdx.x / kFmaSide;
    const long long base = static_cast<long long>(bh) * n;
    const float* kb = at<float>(a.k, a.sk, b, h);
    const float* vb = at<float>(a.v, a.sv, b, h);

    load_tile_f32<HD, kBQ>(sQ, at<float>(a.q, a.sq, b, h), a.sq.n, q0, n);
    load_tile_f32<HD, kBQ>(sO, at<float>(a.dout, a.sdo, b, h), a.sdo.n, q0, n);
    __syncthreads();
    tile_di<float, HD, kBQ>(sDi, a, at<float>(a.o, a.so, b, h), sO, ld, q0);
    __syncthreads();
    float m[kRows], li[kRows], di[kRows], dq[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int row = q0 + ty + kFmaSide * i;
        const bool ok = row < n;
        m[i] = ok ? a.m[base + row] : pos_inf();
        li[i] = ok ? 1.f / a.l[base + row] : 1.f;
        di[i] = sDi[ty + kFmaSide * i];
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

// 1: the plane path, 0: the tiled path
int variant(int dtype, int n, int hd) { return dtype == 1 && hd <= 64 && n <= kPlaneMaxKeys; }

template <typename T, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
    const int bh = batch * a.heads;
    const dim3 grid_kv(bh, (a.n + kBK - 1) / kBK), grid_q(bh, (a.n + kBQ - 1) / kBQ);
    int err;
    if constexpr (sizeof(T) == 2) {
        if constexpr (HD <= 64) {
            if (variant(1, a.n, HD))
                return launch_one(flash_bwd_plane_bf16_kernel<HD>, dim3(bh),
                                  32 * (round_up(a.n, 16) / 16), plane_smem(a.n, HD), a, stream);
        }
        const size_t tiles = sizeof(bf16) * 2 * (kBQ + kBK) * (HD + kTilePad);
        err = launch_one(flash_bwd_dq_bf16_kernel<HD>, grid_q, kMmaThreads,
                         tiles + sizeof(float) * kBQ, a, stream);
        if (err != 0) return err;
        return launch_one(flash_bwd_dkv_bf16_kernel<HD>, grid_kv, kMmaThreads,
                          tiles + sizeof(float) * 3 * kBQ, a, stream);
    } else {
        const size_t tiles = sizeof(float) * 2 * (kBQ + kBK) * (HD + 1);
        err = launch_one(flash_bwd_dq_f32_kernel<HD>, grid_q, kFmaThreads,
                         tiles + sizeof(float) * (kBQ * kLdP + kBQ), a, stream);
        if (err != 0) return err;
        return launch_one(flash_bwd_dkv_f32_kernel<HD>, grid_kv, kFmaThreads,
                          tiles + sizeof(float) * (2 * kBK * kLdP + 3 * kBQ), a, stream);
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
// head) for each of q, k, v, o, do, dq, dk, dv; the head_dim axis must be
// contiguous, and for bf16 every row start 16-byte aligned.  l and m are f32
// (batch * heads, n), contiguous; ``di`` an f32 workspace of batch * heads * n
// floats (the tiled path's).  The scale is 1/sqrt(hd).  The plane path runs
// one kernel, the tiled path two, in order, on ``stream``.
extern "C" int irw_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, void* dq, void* dk,
                                       void* dv, const float* l, const float* m, float* di,
                                       int dtype, int batch, int n, int heads, int hd,
                                       long long qsb, long long qsn, long long qsh,
                                       long long ksb, long long ksn, long long ksh,
                                       long long vsb, long long vsn, long long vsh,
                                       long long osb, long long osn, long long osh,
                                       long long dosb, long long dosn, long long dosh,
                                       long long dqsb, long long dqsn, long long dqsh,
                                       long long dksb, long long dksn, long long dksh,
                                       long long dvsb, long long dvsn, long long dvsh,
                                       void* stream) {
    if (batch <= 0 || n <= 0 || heads <= 0 || hd <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    // as the wrapper's plain version: 1 / sqrt in double, rounded once to float
    const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
    const Args a{q, k, v, o, dout, dq, dk, dv, l, m, di, n, heads, scale,
                 Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh}, Strides{vsb, vsn, vsh},
                 Strides{osb, osn, osh}, Strides{dosb, dosn, dosh}, Strides{dqsb, dqsn, dqsh},
                 Strides{dksb, dksn, dksh}, Strides{dvsb, dvsn, dvsh}};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_hd<float>(hd, a, batch, st);
    if (dtype == 1) return dispatch_hd<bf16>(hd, a, batch, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// which kernels irw_flash_attention_bwd runs for (dtype, n, hd): 1 the plane
// path, 0 the tiled path
extern "C" int irw_flash_attention_bwd_variant(int dtype, int n, int hd) {
    return variant(dtype, n, hd);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
