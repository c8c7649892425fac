// Same-size separable correlation with reflect-101 borders, batched.
//
// Replaces vo_tpu/ops/pallas_blur.py:_blur_kernel (TPU Pallas), which ran
// both passes as banded matmuls over row bands DMA'd with their halo.
// Plain version: vo_tpu_torch/ops/blur_cuda.py:separable_blur_reference.
//
// Bound on the H100: bytes. Each output pixel costs 2*(2r+1) multiply-adds
// (7 taps: 28 flops) against 8 bytes of device traffic (one f32 read, one
// f32 write), far below the ~20 flops/byte where f32 arithmetic would bind.
// Design: one block per 32x64 output tile. The tile and its halo are read
// ONCE into shared memory, with reflect-101 indices computed in the kernel
// (no padded copy in device memory); the row pass writes (32+2ry) x 64
// partial rows to shared memory and the column pass reads them from there,
// so each input pixel leaves device memory about (1 + 2r/32)(1 + 2r/64)
// times. The taps travel by value in the kernel's parameters (constant
// bank, broadcast reads). Leading dims ride on blockIdx.z (the three
// Harris maps in one launch).

#include <cuda_runtime.h>

#include <cstring>

#include "reflect101.cuh"

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 129;  // radius <= 64 on each axis

struct Taps {  // 1,032 bytes of kernel parameters (the limit is 4 KB)
  float y[kMaxTaps];
  float x[kMaxTaps];
};

__global__ void separable_blur_kernel(const float* __restrict__ x,
                                      float* __restrict__ y, int H, int W,
                                      const Taps taps, int ry, int rx) {
  extern __shared__ float smem[];
  const int in_w = kTileW + 2 * rx;
  const int in_h = kTileH + 2 * ry;
  float* tile = smem;                // in_h x in_w input with halo
  float* rows = tile + in_h * in_w;  // in_h x kTileW after the row pass

  const size_t plane = (size_t)H * W;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;

  for (int i = tid; i < in_h * in_w; i += kThreads) {
    const int r = i / in_w;
    const int c = i - r * in_w;
    const int gy = reflect101(y0 - ry + r, H);
    const int gx = reflect101(x0 - rx + c, W);
    tile[i] = xb[(size_t)gy * W + gx];
  }
  __syncthreads();

  for (int i = tid; i < in_h * kTileW; i += kThreads) {
    const int r = i / kTileW;
    const int c = i - r * kTileW;
    const float* src = tile + r * in_w + c;
    float acc = 0.f;
    for (int k = 0; k <= 2 * rx; ++k) acc += taps.x[k] * src[k];
    rows[i] = acc;
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW;
    const int c = i - r * kTileW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy < H && gx < W) {
      const float* src = rows + r * kTileW + c;
      float acc = 0.f;
      for (int k = 0; k <= 2 * ry; ++k) acc += taps.y[k] * src[k * kTileW];
      yb[(size_t)gy * W + gx] = acc;
    }
  }
}

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, H, W) f32 contiguous on the device; ky: 2*ry+1 taps, kx:
// 2*rx+1 taps (f32, host memory, copied into the launch's parameters).
// The caller guarantees radii <= 64, B <= 65535.
extern "C" int separable_blur_f32(const float* x, float* y, int B, int H,
                                  int W, const float* ky, int ry,
                                  const float* kx, int rx, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  Taps taps = {};
  std::memcpy(taps.y, ky, sizeof(float) * (2 * ry + 1));
  std::memcpy(taps.x, kx, sizeof(float) * (2 * rx + 1));
  const size_t smem = sizeof(float) * (size_t)(kTileH + 2 * ry) *
                      (kTileW + 2 * rx + kTileW);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        separable_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  separable_blur_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, y, H, W, taps, ry, rx);
  return (int)cudaGetLastError();
}
