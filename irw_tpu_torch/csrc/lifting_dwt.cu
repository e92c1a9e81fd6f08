// Fused multi-level 2-D lifting DWT, coarsest level only:
// x (N, H, W) f32 -> out (N, 4, H/2^l, W/2^l) f32, bands [LL, LH, HL, HH].
//
// Replaces: irw_tpu/ops/wavelets/pallas_dwt.py, lifting_multi_level_pallas
// (kernel body _dwt_kernel, lifts _pair_lift_sublane,
// _cdf97_pair_lift_sublane, _make_family_pair_lift).  Per level: lift along
// H, then along W on both halves, then the "v6" scales (0.5, 1, 1, sqrt 2);
// the next level lifts the scaled LL.  Every basis is a table of lifting
// steps (Family below), built by irw_tpu_torch/ops/wavelets/lifting_dwt.py:
//   taps step:  target[i] += sum_t c_t * src[i + n_t]   (in tap order)
//   pair step:  target[i] += c * (src[i + a] + src[i + b])   (cdf97)
// with src read as 0 outside [0, m) of the half-length sequence (no
// wrap-around), then s = even * k and d = odd / k (a division, as on the
// TPU).  Every product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn: nvcc contracts nothing into an FMA),
// in the order the plain PyTorch version computes them, so the two agree
// bit for bit.
//
// Bound on the H100: memory.  A level does a few flops per element; the
// input is read once and the output written once: at the served shape
// (N = 3 * 64 = 192 planes of 224 x 224, haar, one level) 38.5 MB + 38.5 MB,
// about 23 us at 3.35 TB/s.
//
// Design (simple first): two kernels per level.  The H pass gives a block
// one plane's strip of 32 columns, the whole height in shared memory
// (H x 32 x 4 bytes: 28 KiB at 224, 56 KiB at 448), loaded coalesced and
// split into even and odd rows as it lands; the lifting steps run in place
// with a barrier between steps, and the scaled s and d halves go to a
// workspace.  The W pass gives a block 8 rows of that workspace, split into
// even and odd columns in shared memory, lifts them, scales, and writes the
// four subbands (the last level) or LL alone into a second workspace (an
// earlier level, which also lifts only the rows LL needs).  The TPU kernel
// held whole planes in VMEM and transposed them; here the workspace between
// the passes costs one extra write and read of the plane, mostly in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSteps = 8;
constexpr int kMaxTaps = 9;
constexpr int kStrip = 32;      // columns per block of the H pass = threads in x
constexpr int kRowsY = 8;       // threads in y of the H pass
constexpr int kRowsW = 8;       // rows per block of the W pass
constexpr int kThreadsW = 256;
constexpr int kMaxShared = 232448;
constexpr int kDefaultShared = 48 * 1024;

struct Step {
    int target;                 // 0: even, 1: odd
    int pair;                   // 1: c * (src[i + a] + src[i + b])
    int ntaps;
    int shift[kMaxTaps];
    float coeff[kMaxTaps];
};

struct Family {
    int nsteps;
    float k;
    Step step[kMaxSteps];
};

// The new value of target element i of a half-length sequence of m elements
// whose other parity is src (element j at src[j * stride]).
__device__ __forceinline__ float lifted(const Step& s, const float* src, int i, int m,
                                        int stride, float target) {
    if (s.pair) {
        const int a = i + s.shift[0], b = i + s.shift[1];
        const float va = (a >= 0 && a < m) ? src[a * stride] : 0.f;
        const float vb = (b >= 0 && b < m) ? src[b * stride] : 0.f;
        return __fadd_rn(target, __fmul_rn(s.coeff[0], __fadd_rn(va, vb)));
    }
    float acc = 0.f;
    for (int t = 0; t < s.ntaps; ++t) {
        const int j = i + s.shift[t];
        const float term = __fmul_rn(s.coeff[t], (j >= 0 && j < m) ? src[j * stride] : 0.f);
        acc = t == 0 ? term : __fadd_rn(acc, term);
    }
    return __fadd_rn(target, acc);
}

// H pass: src (n, h, w) -> dst (n, h, w) with rows [0, h/2) = s * k and,
// when write_high, rows [h/2, h) = d / k.  Block (kStrip, kRowsY), one
// column strip of one plane; dynamic shared memory h * kStrip floats.
__global__ void __launch_bounds__(kStrip * kRowsY)
lift_h_kernel(const float* __restrict__ src, float* __restrict__ dst, int n, int h, int w,
              const __grid_constant__ Family fam, int write_high) {
    extern __shared__ float sm[];           // [h][kStrip]: even rows, then odd rows
    const int m = h / 2;
    const int c = threadIdx.x;
    const int col = blockIdx.x * kStrip + c;
    float* even = sm;
    float* odd = sm + m * kStrip;
    const size_t hw = static_cast<size_t>(h) * w;
    for (int p = blockIdx.y; p < n; p += gridDim.y) {
        const float* plane = src + p * hw;
        for (int i = threadIdx.y; i < h; i += kRowsY)
            sm[((i & 1) * m + (i >> 1)) * kStrip + c] =
                col < w ? plane[static_cast<size_t>(i) * w + col] : 0.f;
        __syncthreads();
        for (int s = 0; s < fam.nsteps; ++s) {
            const Step& st = fam.step[s];
            float* tgt = st.target ? odd : even;
            const float* other = (st.target ? even : odd) + c;
            for (int i = threadIdx.y; i < m; i += kRowsY)
                tgt[i * kStrip + c] = lifted(st, other, i, m, kStrip, tgt[i * kStrip + c]);
            __syncthreads();
        }
        if (col < w) {
            float* out = dst + p * hw;
            for (int i = threadIdx.y; i < m; i += kRowsY) {
                out[static_cast<size_t>(i) * w + col] = __fmul_rn(even[i * kStrip + c], fam.k);
                if (write_high)
                    out[static_cast<size_t>(m + i) * w + col] =
                        __fdiv_rn(odd[i * kStrip + c], fam.k);
            }
        }
        __syncthreads();                    // the next plane overwrites the strip
    }
}

// W pass over the first `rows` rows of the H pass output src (n, h, w).
// all_bands: dst is (n, 4, h/2, w/2); else dst is LL alone, (n, h/2, w/2).
// Block kThreadsW threads, kRowsW rows of one plane; dynamic shared memory
// kRowsW * w floats.
__global__ void __launch_bounds__(kThreadsW)
lift_w_kernel(const float* __restrict__ src, float* __restrict__ dst, int n, int h, int w,
              int rows, const __grid_constant__ Family fam, int all_bands) {
    extern __shared__ float sm[];           // [kRowsW][w]: per row even cols, then odd
    const float v6[4] = {0.5f, 1.0f, 1.0f, 1.41421356237309504880f};
    const int mw = w / 2, mh = h / 2;
    const int r0 = blockIdx.x * kRowsW;
    const int nr = min(kRowsW, rows - r0);
    for (int p = blockIdx.y; p < n; p += gridDim.y) {
        const float* plane = src + (static_cast<size_t>(p) * h + r0) * w;
        for (int e = threadIdx.x; e < nr * w; e += kThreadsW) {
            const int r = e / w, j = e - r * w;
            sm[r * w + (j & 1) * mw + (j >> 1)] = plane[e];
        }
        __syncthreads();
        for (int s = 0; s < fam.nsteps; ++s) {
            const Step& st = fam.step[s];
            const int toff = st.target ? mw : 0;
            const int ooff = st.target ? 0 : mw;
            for (int e = threadIdx.x; e < nr * mw; e += kThreadsW) {
                const int r = e / mw, i = e - r * mw;
                float* row = sm + r * w;
                row[toff + i] = lifted(st, row + ooff, i, mw, 1, row[toff + i]);
            }
            __syncthreads();
        }
        for (int e = threadIdx.x; e < nr * w; e += kThreadsW) {
            const int r = e / w, j = e - r * w;
            const int gr = r0 + r;
            const bool high_w = j >= mw, high_h = gr >= mh;
            const int band = (high_h ? 1 : 0) + (high_w ? 2 : 0);
            if (!all_bands && band != 0) continue;
            const float v = high_w ? __fdiv_rn(sm[r * w + j], fam.k)
                                   : __fmul_rn(sm[r * w + j], fam.k);
            const size_t o = (static_cast<size_t>(all_bands ? p * 4 + band : p) * mh +
                              (high_h ? gr - mh : gr)) * mw + (high_w ? j - mw : j);
            dst[o] = __fmul_rn(v, v6[band]);
        }
        __syncthreads();
    }
}

template <typename Kernel>
int set_shared(Kernel kernel, int bytes) {
    if (bytes <= kDefaultShared) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// x (n, h, w), out (n, 4, h >> levels, w >> levels); lift_ws (n, h, w);
// ll_ws (n, h / 2, w / 2), unused (may be null) when levels == 1.
// meta: nsteps rows of (target, pair, ntaps, shift[kMaxTaps]); coeffs:
// nsteps rows of kMaxTaps.  One call = every kernel of every level, on
// `stream`; returns the first CUDA error (0 if none).
extern "C" int irw_lifting_dwt_f32(const void* x, void* out, void* lift_ws, void* ll_ws,
                                   int n, int h, int w, int levels, int nsteps,
                                   const int* meta, const float* coeffs, float k,
                                   void* stream) {
    if (n <= 0 || levels < 1 || levels > 30 || h % (1 << levels) || w % (1 << levels) ||
        nsteps < 1 || nsteps > kMaxSteps || (levels > 1 && ll_ws == nullptr) ||
        static_cast<long long>(h) * kStrip * 4 > kMaxShared ||
        static_cast<long long>(w) * kRowsW * 4 > kMaxShared)
        return static_cast<int>(cudaErrorInvalidValue);
    Family fam{};
    fam.nsteps = nsteps;
    fam.k = k;
    for (int s = 0; s < nsteps; ++s) {
        const int* row = meta + s * (3 + kMaxTaps);
        Step& st = fam.step[s];
        st.target = row[0];
        st.pair = row[1];
        st.ntaps = row[2];
        if (st.ntaps < 1 || st.ntaps > kMaxTaps || (st.pair && st.ntaps != 2))
            return static_cast<int>(cudaErrorInvalidValue);
        for (int t = 0; t < kMaxTaps; ++t) {
            st.shift[t] = row[3 + t];
            st.coeff[t] = coeffs[s * kMaxTaps + t];
        }
    }
    auto strm = static_cast<cudaStream_t>(stream);
    const int grid_n = n < 65535 ? n : 65535;
    for (int lvl = 0; lvl < levels; ++lvl) {
        const int hl = h >> lvl, wl = w >> lvl;
        const bool last = lvl == levels - 1;
        const float* src = lvl == 0 ? static_cast<const float*>(x)
                                    : static_cast<const float*>(ll_ws);
        const int h_bytes = hl * kStrip * 4;
        int status = set_shared(lift_h_kernel, h_bytes);
        if (status) return status;
        lift_h_kernel<<<dim3((wl + kStrip - 1) / kStrip, grid_n), dim3(kStrip, kRowsY),
                        h_bytes, strm>>>(src, static_cast<float*>(lift_ws), n, hl, wl, fam,
                                         last ? 1 : 0);
        status = static_cast<int>(cudaGetLastError());
        if (status) return status;
        const int rows = last ? hl : hl / 2;   // an earlier level needs LL only
        const int w_bytes = kRowsW * wl * 4;
        status = set_shared(lift_w_kernel, w_bytes);
        if (status) return status;
        lift_w_kernel<<<dim3((rows + kRowsW - 1) / kRowsW, grid_n), kThreadsW, w_bytes,
                        strm>>>(static_cast<const float*>(lift_ws),
                                last ? static_cast<float*>(out) : static_cast<float*>(ll_ws),
                                n, hl, wl, rows, fam, last ? 1 : 0);
        status = static_cast<int>(cudaGetLastError());
        if (status) return status;
    }
    return 0;
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
