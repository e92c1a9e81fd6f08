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
//   one-step kernel: p = exp(s - m) / l, o = dtype(p) v.
// A key mask replaces _flash_mha's padding and segment ids: keys past n get
// MASK_VALUE = -0.7 * FLT_MAX added (not -inf, so exp(s - m) is exactly 0
// and a fully masked block stays finite), and rows past n are never stored.
//
// Bound on the H100 at the flagship's served attention (B = 4 bands * 64 =
// 256, N = 257, H = 6, hd = 64, bf16): memory.  q, k, v read and o written
// are 4 * 50.5 MB = 202 MB, 60 us at 3.35 TB/s; the two products, 4 B H N^2
// hd = 26 GFLOP, take 26 us at the 989 TFLOP/s bf16 tensor-core peak.
//
// bf16, plane path (the flagship; whenever K and V of one (batch, head)
// plane and a 16-row Q tile per warp fit in shared memory: (2 ceil16(N) +
// 96) * hd * 2 bytes <= 227 KB, i.e. N <= 860 at hd 64, N <= 400 at hd
// 128): one thread block per plane.  On the TPU the grid walked the key
// blocks in order, carrying m, l and acc in VMEM scratch; here the block
// copies the plane's K and V into shared memory once with cp.async,
// unpadded with 16-byte chunks XOR-swizzled by row (attention_plane.cuh),
// and its warps walk the plane's 16-row query tiles (17 at N = 257, 6 warps
// in 3 rounds), each tile's Q rows copied into the warp's own swizzled
// tile and its A fragments loaded by ldmatrix one k-step at a time (held
// in registers for the whole tile, they made the hd = 64 kernel spill at
// its 168-register cap).  Each tile makes ONE pass over the 128-key
// blocks, the last cut to the 16-key multiple that holds its keys (the keys
// it leaves out are masked keys, whose p is an exact 0): a block's scores
// stay in registers while its row max is taken, then p = exp(s - m_next) is
// rounded to bf16 and fed to P.V from registers, V's fragments through
// ldmatrix.trans.  Two products, where K2 (attention_fwd.cu), which must
// round the normalised P, needs three.  The normalisation by 1 / l is
// deferred to the end (acc = acc * exp(m_prev - m_next) + dtype(p) v, then
// acc * (1 / l)), as FlashAttention-2 does: the same bf16 p, f32-level
// reorderings after it.  exp is the special-function unit's 2^x
// (ex2.approx) with the scale and m carried in base 2, the argument in one
// FMA, and the one-step kernel's p / l is p * (1 / l) with the reciprocal
// rounded once per row, as in K2.  What bounds it: latency, a 128-key
// block of scores (64 registers a thread) beside the accumulator, so two
// blocks of 6 warps share an SM at hd <= 64.
//
// bf16, tiled path (planes that do not fit): one block per (batch * head,
// 64-query tile) loops over the key blocks itself, holding m, l and acc in
// registers; a block of 128 keys and values is 2 * 128 * (hd + 8) bf16 in
// shared memory, loaded synchronously; mma.sync m16n8k16, 4 warps of 16
// query rows, libm expf.  f32: plain FMAs, 256 threads, each owning 4 rows
// x 8 keys of the 64 x 128 score tile, p staged in shared memory for P.V,
// expf.
//
// Not yet: wgmma, TMA, 32-row warp tiles.

#include <cmath>

#include "attention_plane.cuh"

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
// bf16, plane path: one block per (batch * head) plane, K and V resident
// ------------------------------------------------------------------------

constexpr int kPlaneMaxWarps = 6;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

// warps of a plane block: the fewest rounds of at most kPlaneMaxWarps warps
// over the plane's 16-row query tiles, then as few warps as those rounds need
__host__ __device__ constexpr int plane_warps(int tiles) {
    return (tiles + (tiles + kPlaneMaxWarps - 1) / kPlaneMaxWarps - 1)
           / ((tiles + kPlaneMaxWarps - 1) / kPlaneMaxWarps);
}

// K and V of the plane, then each warp's 16-row Q tile
size_t plane_smem(int n, int hd) {
    return sizeof(bf16) * (2 * round_up(n, 16) + 16 * kPlaneMaxWarps) * hd;
}

// f(Cols<w>{}, k0) for the library's 128-key blocks k0 = 0, 128, ... of n
// keys, the last cut to the 16-key multiple that holds its keys
template <typename F>
__device__ __forceinline__ void for_key_blocks(int n, F&& f) {
    for (int k0 = 0; k0 < n; k0 += kBK) {
        switch ((min(n - k0, kBK) + 15) / 16) {
            case 1: f(Cols<16>{}, k0); break;
            case 2: f(Cols<32>{}, k0); break;
            case 3: f(Cols<48>{}, k0); break;
            case 4: f(Cols<64>{}, k0); break;
            case 5: f(Cols<80>{}, k0); break;
            case 6: f(Cols<96>{}, k0); break;
            case 7: f(Cols<112>{}, k0); break;
            default: f(Cols<128>{}, k0); break;
        }
    }
}

// acc (16 x HD) += P . V for keys kk * 16 .. + 15 of a chunk: P's A
// fragments pa (bf16), V from a swizzled tile at sV (chunk base) through
// ldmatrix.trans
template <int HD>
__device__ __forceinline__ void pv_swz(float (&acc)[HD / 8][4], const uint32_t (&pa)[4],
                                       const bf16* sV, int kk) {
    const int lane = threadIdx.x % 32, mat = lane >> 3;
    const int row = kk * 16 + (lane & 7) + (mat & 1) * 8;
#pragma unroll
    for (int jn = 0; jn < HD / 8; jn += 2) {
        uint32_t vfrag[4];
        ldmatrix_x4_trans(vfrag, sV + swz<HD>(row, (jn + (mat >> 1)) * 8));
        mma_bf16(acc[jn], pa, vfrag[0], vfrag[1]);
        mma_bf16(acc[jn + 1], pa, vfrag[2], vfrag[3]);
    }
}

// d = q k^T for this warp's 16 query rows, a swizzled 16 x HD tile at sQ,
// and the C key rows of a swizzled tile at sK (chunk base): Q's A fragments
// come through ldmatrix one k-step at a time, so they hold 4 registers, not
// HD / 4, beside a 128-key block's scores; dot_tile_swz's products, in its
// order.  A row's swizzle depends only on its index modulo 8, so key rows
// 8 j further on sit 8 j HD elements further: one address per k-step
template <int HD, int C>
__device__ __forceinline__ void dot_block(const bf16* sQ, const bf16* sK, float (&d)[C / 8][4]) {
#pragma unroll
    for (int j = 0; j < C / 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t qa[4];
        ldmatrix_x4(qa, sQ + swz<HD>(ldm_a_row(), ks * 16 + ldm_a_col()));
        const bf16* base = sK + swz<HD>(ldm_b_row(), ks * 16 + ldm_b_col());
#pragma unroll
        for (int j = 0; j < C / 8; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, base + j * 8 * HD);
            mma_bf16(d[j], qa, bf[0], bf[1]);
            mma_bf16(d[j + 1], qa, bf[2], bf[3]);
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(32 * kPlaneMaxWarps, HD <= 64 ? 2 : 1)
flash_fwd_plane_bf16_kernel(const Args a) {
    constexpr int kNT = HD / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n = a.n, nk = round_up(n, 16);
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // nk x HD, swizzled
    bf16* sV = sK + nk * HD;                        // nk x HD, swizzled
    bf16* sQw = sV + nk * HD + (threadIdx.x / 32) * 16 * HD;  // this warp's Q tile, swizzled

    const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
    const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
    load_rows_async_swz<HD>(sK, static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h, a.sk.n,
                            nk, n);
    load_rows_async_swz<HD>(sV, static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h, a.sv.n,
                            nk, n);
    cp_async_commit();
    const float scale = a.scale, sl2 = __fmul_rn(scale, kLog2e);
    const bool one_step = n <= kBK;
    cp_async_wait<0>();
    __syncthreads();

    for (int tile = warp; tile < nk / 16; tile += nwarps) {
        // the tile's Q rows (zero past n) into the warp's swizzled tile
        __syncwarp();  // the previous tile's readers are done
        for (int idx = lane; idx < 16 * HD / 8; idx += 32) {
            const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, row = tile * 16 + r;
            cp_async16(sQw + swz<HD>(r, c), qb + (row < n ? row * a.sq.n + c : 0), row < n);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
        float acc[kNT][4];
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.f;
        for_key_blocks(n, [&](auto cols, int k0) {
            constexpr int C = decltype(cols)::value;
            float d[C / 8][4];  // q k^T, unscaled; keys at or past n at -inf
            dot_block<HD, C>(sQw, sK + k0 * HD, d);
            mask_dots<C>(d, k0, n);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float dmax = neg_inf();
#pragma unroll
                for (int j = 0; j < C / 8; ++j) dmax = fmaxf(dmax, fmaxf(d[j][2 * r], d[j][2 * r + 1]));
                // max(s) = max(d) * scale exactly: rounding is monotone
                const float m_next = fmaxf(m[r], __fmul_rn(quad_max(dmax), scale));
                const float ml2 = __fmul_rn(m_next, kLog2e);
                float part = 0.f;
#pragma unroll
                for (int j = 0; j < C / 8; ++j)
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const float p = ex2(__fmaf_rn(d[j][2 * r + c], sl2, -ml2));
                        d[j][2 * r + c] = p;
                        part = __fadd_rn(part, p);
                    }
                const float rowsum = quad_sum(part);
                if (one_step) {  // the library's single-step kernel: p / l before rounding
                    const float rl = __frcp_rn(rowsum);
#pragma unroll
                    for (int j = 0; j < C / 8; ++j) {
                        d[j][2 * r] = __fmul_rn(d[j][2 * r], rl);
                        d[j][2 * r + 1] = __fmul_rn(d[j][2 * r + 1], rl);
                    }
                    l[r] = rowsum;
                } else {  // acc and l rescaled to the new max; 1 / l deferred
                    const float alpha = ex2(__fmaf_rn(m[r], kLog2e, -ml2));
                    l[r] = __fmaf_rn(l[r], alpha, rowsum);
#pragma unroll
                    for (int jn = 0; jn < kNT; ++jn) {
                        acc[jn][2 * r] *= alpha;
                        acc[jn][2 * r + 1] *= alpha;
                    }
                }
                m[r] = m_next;
            }
#pragma unroll
            for (int kk = 0; kk < C / 16; ++kk) {
                uint32_t pa[4];
                pack_a_bf16<C>(pa, d, kk);
                pv_swz<HD>(acc, pa, sV + k0 * HD, kk);
            }
        });
        if (!one_step) {
            const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
            for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[jn][e] *= rl[e >> 1];
        }
        warp_store_bf16<HD>(static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h, a.so.n, acc,
                            tile * 16, n);
        if (a.l != nullptr && t == 0) {
            const long long base = static_cast<long long>(bh) * n;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = tile * 16 + g + 8 * r;
                if (row < n) {
                    a.l[base + row] = l[r];
                    a.m[base + row] = m[r];
                }
            }
        }
    }
}

// ------------------------------------------------------------------------
// bf16, tiled path: mma.sync tensor cores
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

// 1: the plane path, 0: the tiled path
int variant(int dtype, int n, int hd) { return dtype == 1 && plane_smem(n, hd) <= kMaxSmem; }

template <typename T, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
    const dim3 grid(batch * a.heads, (a.n + kBQ - 1) / kBQ);
    if constexpr (sizeof(T) == 2) {
        if (variant(1, a.n, HD))
            return launch_one(flash_fwd_plane_bf16_kernel<HD>, dim3(batch * a.heads),
                              32 * plane_warps(round_up(a.n, 16) / 16), plane_smem(a.n, HD), a,
                              stream);
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

// which kernel irw_flash_attention_fwd runs for (dtype, n, hd): 1 the plane
// path, 0 the tiled path
extern "C" int irw_flash_attention_fwd_variant(int dtype, int n, int hd) {
    return variant(dtype, n, hd);
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
