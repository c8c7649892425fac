// Same-size 1-D correlation along rows or along columns, reflect-101
// borders, batched over planes.
//
// Replaces vo_tpu/ops/pallas_conv.py:_row_conv_kernel (TPU Pallas), which
// accumulated the taps over overlapped 512-wide column tiles copied out in
// XLA beforehand, and did the column pass as transpose, row pass,
// transpose. Plain version: vo_tpu_torch/ops/rowconv_cuda.py:
// conv_reference. On SIFT's path it computes the gradient maps of the
// layer-flattened Gaussian canvas (vo_tpu/frontend/sift.py:_grad_maps): a
// (7056, 2560) f32 plane at KITTI shape, taps (-0.5, 0, 0.5).
//
// Bound on the H100: bytes. A 3-tap pass costs 2 multiplies and an add per
// pixel against 8 bytes of device traffic (one f32 read, one f32 write).
// Design: one block per 32x128 output tile; the tile and its halo along the
// pass's axis are read ONCE into shared memory (coalesced rows), with the
// periodic reflect-101 indices computed in the kernel, so nothing is padded
// or transposed in device memory. The column pass reads its halo rows from
// the plane's neighbouring rows: on the layer-flattened canvas a layer's
// edge row sees the next layer's rows, as vo_tpu's does; reflection happens
// only at the ends of the plane. Each output is the plain version's sum in
// its order (zero taps skipped, products and sums rounded separately, no
// FMA), so the kernel agrees with it bit for bit. Taps travel by value in
// the kernel's parameters.

#include <cuda_runtime.h>

#include <cstring>

#include "reflect101.cuh"

namespace {

constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 129;  // radius <= 64

struct Taps {  // 516 bytes of kernel parameters (the limit is 4 KB)
  float t[kMaxTaps];
};

__global__ void row_conv_kernel(const float* __restrict__ x,
                                float* __restrict__ y, int H, int W,
                                const Taps taps, int r, int along_cols) {
  extern __shared__ float tile[];
  const int hy = along_cols ? r : 0;  // halo rows
  const int hx = along_cols ? 0 : r;  // halo columns
  const int in_w = kTileW + 2 * hx;
  const int in_h = kTileH + 2 * hy;
  const int step = along_cols ? in_w : 1;  // tile stride between taps

  const size_t plane = (size_t)H * W;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;

  for (int i = tid; i < in_h * in_w; i += kThreads) {
    const int rr = i / in_w;
    const int c = i - rr * in_w;
    const int gy = reflect101(y0 - hy + rr, H);
    const int gx = reflect101(x0 - hx + c, W);
    tile[i] = xb[(size_t)gy * W + gx];
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int rr = i / kTileW;
    const int c = i - rr * kTileW;
    const int gy = y0 + rr;
    const int gx = x0 + c;
    if (gy < H && gx < W) {
      const float* src = tile + rr * in_w + c;  // the footprint's first tap
      float acc = 0.f;
      bool first = true;
      for (int k = 0; k <= 2 * r; ++k) {
        const float t = taps.t[k];
        if (t == 0.f) continue;
        const float term = __fmul_rn(t, src[k * step]);
        acc = first ? term : __fadd_rn(acc, term);
        first = false;
      }
      yb[(size_t)gy * W + gx] = acc;
    }
  }
}

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, H, W) f32 contiguous on the device; taps: 2*r+1 f32 values in
// host memory (copied into the launch's parameters); along_cols: 0 for a
// pass along each row (the last axis), 1 along each column. The caller
// guarantees r <= 64 and B <= 65535.
extern "C" int row_conv_f32(const float* x, float* y, int B, int H, int W,
                            const float* taps, int r, int along_cols,
                            void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  Taps t = {};
  std::memcpy(t.t, taps, sizeof(float) * (2 * r + 1));
  const int hy = along_cols ? r : 0;
  const int hx = along_cols ? 0 : r;
  const size_t smem =
      sizeof(float) * (size_t)(kTileH + 2 * hy) * (kTileW + 2 * hx);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  row_conv_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(x, y, H, W, t, r,
                                                         along_cols);
  return (int)cudaGetLastError();
}
