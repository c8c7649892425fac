// Same-size separable correlation with reflect-101 borders, batched.
//
// Replaces vo_tpu/ops/pallas_blur.py:_blur_kernel (TPU Pallas), which ran
// both passes as banded matmuls over row bands DMA'd with their halo.
// Plain version: vo_tpu_torch/ops/blur_cuda.py:separable_blur_reference.
//
// Bound on the H100: bytes. Each output pixel costs 2*(2r+1) multiply-adds
// (radius 12: 50) against 8 bytes of device traffic (one f32 read, one f32
// write), below the ~20 flops/byte where f32 arithmetic would bind.
// Design: one block per output tile. The tile and its halo are read once
// into shared memory by asynchronous copies (cp.async), so all of a
// thread's loads are in flight at once; tiles that touch an edge reflect
// their rows and columns once into a table. The row pass writes its
// (TH+2r) x TW rows to shared memory and the column pass reads them from
// there, so each input pixel leaves device memory about (1 + 2r/TH)(1 +
// 2r/TW) times. The radii of the main paths (3: the Harris 7-tap blur; 5,
// 6, 8, 10, 12: SIFT's scale space at sigma 1.6 with 3 layers) are
// compiled as constants: the tap loops unroll, the taps are read at static
// offsets of a parameter holding just 2r+1 per axis (200 bytes at r = 12:
// a small octave's blur is mostly launch, and the launch grows with its
// parameters), and each thread computes a strip of KS outputs along the
// pass's axis from KS + 2r values held in registers (shared-memory loads
// per output (KS + 2r) / KS, not 2r + 1). A warp's threads sit on
// consecutive rows (row pass, odd pitch) or columns (column pass), so
// shared memory serves each load in one wavefront. Large planes take 64x64
// tiles (halo overhead 1.4x at r = 12); a plane that gives fewer than two
// such tiles per SM takes 32x64 tiles if that gives one per SM (SIFT's
// 376x1241 octave), else 16x32 tiles, so that the small octaves spread
// over more SMs. Any other radius up to 64 runs a generic kernel with
// runtime taps. Leading dims ride on blockIdx.z (the three Harris maps in
// one launch).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstring>

#include "reflect101.cuh"

namespace {

constexpr int kMaxTaps = 129;  // radius <= 64 on each axis
constexpr int kSMs = 132;      // H100 SXM

struct Taps {  // generic: 1,032 bytes of kernel parameters (limit 4 KB)
  float y[kMaxTaps];
  float x[kMaxTaps];
};

// rows x cols of the plane from (gy0, gx0), reflect-101 outside it, into
// tile (row pitch `pitch`); a warp reads along a row (coalesced). The
// copies are asynchronous (cp.async), so every load of a thread is in
// flight at once. Tiles that touch an edge first reflect their rows and
// columns once into `idx` (rows + cols ints). Ends with the block's
// barrier.
__device__ __forceinline__ void load_tile(const float* __restrict__ xb,
                                          float* tile, int* idx, int pitch,
                                          int rows, int cols, int gy0,
                                          int gx0, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (gy0 >= 0 && gx0 >= 0 && gy0 + rows <= H && gx0 + cols <= W) {
    for (int r = warp; r < rows; r += nw) {
      const float* src = xb + (size_t)(gy0 + r) * W + gx0;
      for (int c = lane; c < cols; c += 32) {
        __pipeline_memcpy_async(tile + r * pitch + c, src + c, sizeof(float));
      }
    }
  } else {
    int* ry = idx;
    int* rx = idx + rows;
    for (int i = threadIdx.x; i < rows + cols; i += blockDim.x) {
      idx[i] = i < rows ? reflect101(gy0 + i, H) * W
                        : reflect101(gx0 + i - rows, W);
    }
    __syncthreads();
    for (int r = warp; r < rows; r += nw) {
      const float* src = xb + ry[r];
      for (int c = lane; c < cols; c += 32) {
        __pipeline_memcpy_async(tile + r * pitch + c, src + rx[c],
                                sizeof(float));
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Radius R on both axes; TH x TW output tile; strips of KS outputs.
template <int R, int TH, int TW, int KS>
struct Tile {
  static constexpr int LH = TH + 2 * R;  // rows with halo
  static constexpr int LW = TW + 2 * R;  // columns with halo
  static constexpr int LP = LW | 1;      // odd pitch
  static constexpr int MP = TW + 1;      // odd pitch of the row pass
  static constexpr size_t smem = sizeof(float) * (LH * (LP + MP) + LH + LW);
  static_assert(TW % KS == 0 && TH % KS == 0, "strips must tile the tile");
};

// The taps of a compiled radius: 2r+1 per axis (200 bytes at r = 12).
template <int R>
struct TapsR {
  float y[2 * R + 1];
  float x[2 * R + 1];
};

template <int R, int TH, int TW, int KS, int NT>
__global__ void __launch_bounds__(NT)
    blur_fixed(const float* __restrict__ x, float* __restrict__ y, int H,
               int W, const TapsR<R> taps) {
  using L = Tile<R, TH, TW, KS>;
  constexpr int NV = KS + 2 * R;
  extern __shared__ float smem[];
  float* tile = smem;                 // LH x LW input with halo
  float* mid = tile + L::LH * L::LP;  // LH x TW after the row pass
  int* idx = reinterpret_cast<int*>(mid + L::LH * L::MP);

  const size_t plane = (size_t)H * W;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  load_tile(xb, tile, idx, L::LP, L::LH, L::LW, y0 - R, x0 - R, H, W);

  // row pass: thread t takes row t % LH, strip t / LH
  for (int t = threadIdx.x; t < L::LH * (TW / KS); t += NT) {
    const int r = t % L::LH;
    const int sx = t / L::LH;
    const float* src = tile + r * L::LP + sx * KS;
    float v[NV], acc[KS];
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = src[j];
#pragma unroll
    for (int i = 0; i < KS; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
#pragma unroll
      for (int i = 0; i < KS; ++i) acc[i] += taps.x[k] * v[i + k];
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) mid[r * L::MP + sx * KS + i] = acc[i];
  }
  __syncthreads();

  // column pass: thread t takes column t % TW, strip t / TW
  for (int t = threadIdx.x; t < TW * (TH / KS); t += NT) {
    const int c = t % TW;
    const int sy = t / TW;
    const float* src = mid + sy * KS * L::MP + c;
    float v[NV], acc[KS];
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = src[j * L::MP];
#pragma unroll
    for (int i = 0; i < KS; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) {
#pragma unroll
      for (int i = 0; i < KS; ++i) acc[i] += taps.y[k] * v[i + k];
    }
    const int gx = x0 + c;
    if (gx < W) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int gy = y0 + sy * KS + i;
        if (gy < H) yb[(size_t)gy * W + gx] = acc[i];
      }
    }
  }
}

constexpr int kGenTH = 32;
constexpr int kGenTW = 64;
constexpr int kGenThreads = 256;

// Any radii up to 64, one output per thread and pass, taps read at runtime
// offsets straight from the parameters (__grid_constant__: no local copy).
__global__ void __launch_bounds__(kGenThreads)
    blur_generic(const float* __restrict__ x, float* __restrict__ y, int H,
                 int W, const __grid_constant__ Taps taps, int ry, int rx) {
  extern __shared__ float smem[];
  const int LH = kGenTH + 2 * ry;
  const int LP = (kGenTW + 2 * rx) | 1;
  constexpr int MP = kGenTW + 1;
  float* tile = smem;
  float* mid = tile + LH * LP;
  int* idx = reinterpret_cast<int*>(mid + LH * MP);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int nw = kGenThreads / 32;

  const size_t plane = (size_t)H * W;
  const float* xb = x + blockIdx.z * plane;
  float* yb = y + blockIdx.z * plane;
  const int x0 = blockIdx.x * kGenTW;
  const int y0 = blockIdx.y * kGenTH;
  load_tile(xb, tile, idx, LP, LH, kGenTW + 2 * rx, y0 - ry, x0 - rx, H,
            W);

  for (int c = warp; c < kGenTW; c += nw) {  // a warp down a column
    for (int r = lane; r < LH; r += 32) {
      const float* src = tile + r * LP + c;
      float acc = 0.f;
      for (int k = 0; k <= 2 * rx; ++k) acc += taps.x[k] * src[k];
      mid[r * MP + c] = acc;
    }
  }
  __syncthreads();

  for (int r = warp; r < kGenTH; r += nw) {  // a warp along a row
    for (int c = lane; c < kGenTW; c += 32) {
      const int gy = y0 + r;
      const int gx = x0 + c;
      if (gy < H && gx < W) {
        const float* src = mid + r * MP + c;
        float acc = 0.f;
        for (int k = 0; k <= 2 * ry; ++k) acc += taps.y[k] * src[k * MP];
        yb[(size_t)gy * W + gx] = acc;
      }
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int R, int TH, int TW, int KS, int NT>
int launch_fixed(const float* x, float* y, int B, int H, int W,
                 const TapsR<R>& taps, cudaStream_t stream) {
  auto kernel = blur_fixed<R, TH, TW, KS, NT>;
  const size_t smem = Tile<R, TH, TW, KS>::smem;
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, stream>>>(x, y, H, W, taps);
  return (int)cudaGetLastError();
}

template <int R>
int launch_radius(const float* x, float* y, int B, int H, int W,
                  const float* ky, const float* kx, cudaStream_t stream) {
  TapsR<R> taps;
  std::memcpy(taps.y, ky, sizeof(taps.y));
  std::memcpy(taps.x, kx, sizeof(taps.x));
  auto blocks = [&](int th, int tw) {
    return (long)((W + tw - 1) / tw) * ((H + th - 1) / th) * B;
  };
  if (blocks(64, 64) >= 2 * kSMs) {
    return launch_fixed<R, 64, 64, 8, 256>(x, y, B, H, W, taps, stream);
  }
  if (blocks(32, 64) >= kSMs) {
    return launch_fixed<R, 32, 64, 8, 256>(x, y, B, H, W, taps, stream);
  }
  return launch_fixed<R, 16, 32, 4, 128>(x, y, B, H, W, taps, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ry == rx) {
    switch (ry) {
      case 3: return launch_radius<3>(x, y, B, H, W, ky, kx, s);
      case 5: return launch_radius<5>(x, y, B, H, W, ky, kx, s);
      case 6: return launch_radius<6>(x, y, B, H, W, ky, kx, s);
      case 8: return launch_radius<8>(x, y, B, H, W, ky, kx, s);
      case 10: return launch_radius<10>(x, y, B, H, W, ky, kx, s);
      case 12: return launch_radius<12>(x, y, B, H, W, ky, kx, s);
      default: break;
    }
  }
  Taps taps = {};
  std::memcpy(taps.y, ky, sizeof(float) * (2 * ry + 1));
  std::memcpy(taps.x, kx, sizeof(float) * (2 * rx + 1));
  const int LH = kGenTH + 2 * ry, LW = kGenTW + 2 * rx;
  const size_t smem = sizeof(float) * (LH * ((LW | 1) + kGenTW + 1) + LH + LW);
  const int e = allow_smem(blur_generic, smem);
  if (e) return e;
  dim3 grid((W + kGenTW - 1) / kGenTW, (H + kGenTH - 1) / kGenTH, B);
  blur_generic<<<grid, kGenThreads, smem, s>>>(x, y, H, W, taps, ry, rx);
  return (int)cudaGetLastError();
}
