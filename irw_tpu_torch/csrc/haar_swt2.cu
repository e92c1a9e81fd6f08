// Level-1 stationary (undecimated) Haar transform, periodic extension,
// size-preserving: x (N, H, W) f32 -> out (N, 4, H, W) f32, bands ordered
// [cA, cH, cV, cD].
//
// Replaces: irw_tpu/ops/wavelets/pallas_dwt.py, haar_swt2_pallas (kernel
// body _swt_kernel).  Same arithmetic in the same order, in f32:
//   lo_h = s (x[i,j] + x[i+1,j]),  hi_h = s (x[i,j] - x[i+1,j])
//   cA = s (lo_h + lo_h[j+1]), cH = s (hi_h + hi_h[j+1]),
//   cV = s (lo_h - lo_h[j+1]), cD = s (hi_h - hi_h[j+1]),
// with s = 1/sqrt(2) and indices taken mod H and mod W.
//
// Bound on the H100: memory.  Each output element costs ~4 flops against
// 4 bytes written, and each input element is read once and written as four:
// at the flagship (N = 3 * 64 = 192 planes of 224 x 224) that is 38.5 MB read
// + 154.1 MB written = 192.7 MB, about 57.5 us at 3.35 TB/s.
//
// Design: one thread block per 32-column x 32-row tile of one plane.  The
// block stages the tile plus one halo row and one halo column (wrapped) in
// shared memory with loads coalesced along W, so every input element leaves
// device memory about once; each thread then writes its position in all four
// bands, again coalesced along W.  The TPU kernel rolled whole planes in
// VMEM; here blocks are independent and the wrap-around is an index mod H/W.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;             // columns per tile = threads in x
constexpr int kThreadsY = 8;           // threads in y
constexpr int kTileH = 32;             // rows per tile (4 per thread)

__global__ void __launch_bounds__(kTileW * kThreadsY)
haar_swt2_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int n, int h, int w) {
    __shared__ float tile[kTileH + 1][kTileW + 1];
    const float s = 0.70710678118654752440f;
    const int j0 = blockIdx.x * kTileW;
    const int i0 = blockIdx.y * kTileH;
    const size_t hw = static_cast<size_t>(h) * w;
    for (int p = blockIdx.z; p < n; p += gridDim.z) {
        const float* plane = x + static_cast<size_t>(p) * hw;
        for (int r = threadIdx.y; r <= kTileH; r += kThreadsY) {
            const int i = (i0 + r) % h;
            for (int c = threadIdx.x; c <= kTileW; c += kTileW) {
                const int j = (j0 + c) % w;
                tile[r][c] = plane[static_cast<size_t>(i) * w + j];
            }
        }
        __syncthreads();
        float* o = out + static_cast<size_t>(p) * 4 * hw;
        const int c = threadIdx.x;
        const int j = j0 + c;
        for (int r = threadIdx.y; r < kTileH; r += kThreadsY) {
            const int i = i0 + r;
            if (i < h && j < w) {
                const float a = tile[r][c], b = tile[r + 1][c];
                const float an = tile[r][c + 1], bn = tile[r + 1][c + 1];
                const float lo = s * (a + b), hi = s * (a - b);
                const float lon = s * (an + bn), hin = s * (an - bn);
                const size_t idx = static_cast<size_t>(i) * w + j;
                o[idx] = s * (lo + lon);
                o[hw + idx] = s * (hi + hin);
                o[2 * hw + idx] = s * (lo - lon);
                o[3 * hw + idx] = s * (hi - hin);
            }
        }
        __syncthreads();  // the next plane overwrites the tile
    }
}

}  // namespace

extern "C" int irw_haar_swt2_f32(const void* x, void* out, int n, int h, int w,
                                 void* stream) {
    if (n <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kTileW, kThreadsY);
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    n < 65535 ? n : 65535);
    haar_swt2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, h, w);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* irw_cuda_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
