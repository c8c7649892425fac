// (N, S, S) windows of one f32 image at per-window integer origins.
//
// Replaces vo_tpu/ops/pallas_crop.py:_crop_kernel (TPU Pallas), which
// DMA'd an (S, 256) strip per window from an 8-aligned row and a
// 128-aligned column block and picked the S columns with a one-hot matmul
// (so it needed S % 8 == 0, S <= 128 and oy % 8 == 0). Plain version:
// vo_tpu_torch/ops/crop_cuda.py:crop_windows_reference. On SIFT's path it
// cuts the orientation (S = 37) and descriptor (S = 79) windows out of the
// layer-flattened gradient maps (vo_tpu/frontend/sift.py:_sample_grad_win).
//
// Bound on the H100: bytes. It moves N*S*S*4 bytes each way and computes
// nothing. Design: one block per window; consecutive threads take
// consecutive elements of the window, so a window row is one coalesced
// read of S contiguous floats of the image and the output is written
// contiguously. Any S up to 128 and any origin: samples outside the image
// are 0 (the Pallas wrapper's zero pad), so no padded copy of the image is
// made in device memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void crop_windows_kernel(const float* __restrict__ img, int H,
                                    int W, const int32_t* __restrict__ ox,
                                    const int32_t* __restrict__ oy, int S,
                                    float* __restrict__ out) {
  const int n = blockIdx.x;
  const int x0 = ox[n];
  const int y0 = oy[n];
  float* o = out + (size_t)n * S * S;
  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int r = i / S;
    const int gy = y0 + r;
    const int gx = x0 + (i - r * S);
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    o[i] = in ? img[(size_t)gy * W + gx] : 0.f;
  }
}

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// img: (H, W) f32; ox, oy: (N,) int32 window origins (top-left corner,
// column and row); out: (N, S, S) f32; all contiguous on the device. The
// caller guarantees 0 < S <= 128.
extern "C" int crop_windows_f32(const float* img, int H, int W,
                                const int32_t* ox, const int32_t* oy, int N,
                                int S, float* out, void* stream) {
  if (N == 0) return 0;
  crop_windows_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, ox, oy, S, out);
  return (int)cudaGetLastError();
}
