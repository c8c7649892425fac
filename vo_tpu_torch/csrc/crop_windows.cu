// (N, S, S) windows of one f32 map, or of two maps at the same origins, at
// per-window integer origins.
//
// Replaces vo_tpu/ops/pallas_crop.py:_crop_kernel (TPU Pallas), which
// DMA'd an (S, 256) strip per window from an 8-aligned row and a
// 128-aligned column block and picked the S columns with a one-hot matmul
// (so it needed S % 8 == 0, S <= 128 and oy % 8 == 0). Plain version:
// vo_tpu_torch/ops/crop_cuda.py:crop_windows_reference. On SIFT's path it
// cuts the orientation (S = 37) and descriptor (S = 79) windows out of the
// layer-flattened gradient maps gx and gy (vo_tpu/frontend/sift.py:
// _sample_grad_win), both maps at the same origins in one launch.
//
// Bound on the H100: bytes, and almost all of them writes. One SIFT detect
// writes 381 MB of windows and reads ~31 MB of distinct map pixels: the
// windows overlap (about 15x at S = 79), so the reads mostly hit L2 and
// the stores set the pace. Design: the (N, S, S) output is one flat array
// cut into 16-byte chunks of 4 samples; a grid sized to the SMs walks it,
// each thread two chunks per step, their 8 loads (16 for two maps) issued
// before any store. Every store is a float4, and a warp writes 512
// contiguous bytes as streaming stores (__stcs), which keep the windows
// from evicting the maps from L2. A chunk's window, row and column come
// from one division by S*S and one by S (compile-time for the path's
// S = 37 and 79: a multiply and a shift; one generic instantiation for any
// other S <= 128), then its 4 samples step along the window row. A chunk
// inside one window that lies wholly inside the map loads with no bounds
// test; chunks that cross a window's end, reach outside the map or hold
// the ragged tail (N*S*S not a multiple of 4) test each sample, and
// samples outside the map are 0 (the Pallas wrapper's zero pad), so no
// padded copy of the map is made in device memory. Flat indices are
// 64-bit; the divisions are 32-bit where N*S*S fits. Two maps at the same
// origins (SIFT's gx and gy) share each chunk's index work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // chunks per thread and step, loads batched

// Streaming stores: the windows are written once and read later by
// another kernel, so they should not evict the maps from L2.
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Window n, row r and column c of flat sample e (S*S = SS samples per
// window); 32-bit divisions where the flat index fits.
__device__ __forceinline__ void position(uint64_t e, uint32_t SS, int S,
                                         bool small, uint64_t& n, int& r,
                                         int& c) {
  n = small ? (uint64_t)((uint32_t)e / SS) : e / SS;
  const uint32_t rem = (uint32_t)(e - n * SS);
  r = (int)(rem / (uint32_t)S);
  c = (int)rem - r * S;
}

// The chunk of samples e .. e+3 (e < M) sample by sample: for chunks that
// cross a window's end, reach outside the map or hold the tail. 0 outside
// the map.
template <int kMaps>
__device__ __forceinline__ void crop_chunk_checked(
    const float* __restrict__ a, const float* __restrict__ b, int H, int W,
    const int32_t* __restrict__ ox, const int32_t* __restrict__ oy, int S,
    uint32_t SS, bool small, uint64_t M, uint64_t e,
    float* __restrict__ out_a, float* __restrict__ out_b) {
  uint64_t n;
  int r, c;
  position(e, SS, S, small, n, r, c);
  int x0 = __ldg(ox + n);
  int y0 = __ldg(oy + n);
  float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (e + k < M) {
      const int gy = y0 + r;
      const int gx = x0 + c;
      if ((unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W) {
        const int64_t o = (int64_t)gy * W + gx;
        at(va, k) = __ldg(a + o);
        if (kMaps == 2) at(vb, k) = __ldg(b + o);
      }
      if (++c == S) {
        c = 0;
        if (++r == S) {  // the next window (each sample, at S = 1)
          r = 0;
          if (k < 3 && e + k + 1 < M) {
            ++n;
            x0 = __ldg(ox + n);
            y0 = __ldg(oy + n);
          }
        }
      }
    }
  }
  if (e + 4 <= M) {
    store4(out_a + e, va);
    if (kMaps == 2) store4(out_b + e, vb);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e + k < M) {
        out_a[e + k] = at(va, k);
        if (kMaps == 2) out_b[e + k] = at(vb, k);
      }
    }
  }
}

// kS: the window size, 0 for the size given at run time. kMaps: 1 or 2
// maps cut at the same origins (b and out_b unused for 1). out_a and out_b
// are 16-byte aligned; M = N*S*S samples per map.
template <int kS, int kMaps>
__global__ void __launch_bounds__(kThreads)
    crop_kernel(const float* __restrict__ a, const float* __restrict__ b,
                int H, int W, const int32_t* __restrict__ ox,
                const int32_t* __restrict__ oy, int s_rt, uint64_t M,
                float* __restrict__ out_a, float* __restrict__ out_b) {
  const int S = kS > 0 ? kS : s_rt;
  const uint32_t SS = (uint32_t)(S * S);
  const bool small = (M >> 32) == 0;
  const uint64_t chunks = (M + 3) >> 2;
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  for (uint64_t ch0 = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
       ch0 < chunks; ch0 += kUnroll * stride) {
    // the sample offsets of each chunk that lies in one window wholly
    // inside the map (no bounds test), then all their loads, then stores
    int64_t off[kUnroll][4];
    bool fast[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint64_t e = (ch0 + u * stride) << 2;
      fast[u] = false;
      if (e + 4 <= M) {
        uint64_t n;
        int r, c;
        position(e, SS, S, small, n, r, c);
        const int x0 = __ldg(ox + n);
        const int y0 = __ldg(oy + n);
        fast[u] = r * S + c + 4 <= (int)SS && x0 >= 0 && y0 >= 0 &&
                  x0 <= W - S && y0 <= H - S;
        int64_t o = (int64_t)(y0 + r) * W + x0 + c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          off[u][k] = o;
          ++o;
          if (++c == S) {
            c = 0;
            o += W - S;
          }
        }
      }
    }
    float4 va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (fast[u]) {
#pragma unroll
        for (int k = 0; k < 4; ++k) at(va[u], k) = __ldg(a + off[u][k]);
        if (kMaps == 2) {
#pragma unroll
          for (int k = 0; k < 4; ++k) at(vb[u], k) = __ldg(b + off[u][k]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint64_t e = (ch0 + u * stride) << 2;
      if (fast[u]) {
        store4(out_a + e, va[u]);
        if (kMaps == 2) store4(out_b + e, vb[u]);
      } else if (e < M) {
        crop_chunk_checked<kMaps>(a, b, H, W, ox, oy, S, SS, small, M, e,
                                  out_a, out_b);
      }
    }
  }
}

template <int kS, int kMaps>
int launch(const float* a, const float* b, int H, int W, const int32_t* ox,
           const int32_t* oy, int N, int S, float* out_a, float* out_b,
           cudaStream_t stream) {
  const uint64_t M = (uint64_t)N * S * S;
  const uint64_t chunks = (M + 3) / 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, crop_kernel<kS, kMaps>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const uint64_t need = (chunks + kThreads - 1) / kThreads;
  const uint64_t full = (uint64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < full ? need : full);
  crop_kernel<kS, kMaps><<<blocks, kThreads, 0, stream>>>(
      a, b, H, W, ox, oy, S, M, out_a, out_b);
  return (int)cudaGetLastError();
}

template <int kMaps>
int dispatch(const float* a, const float* b, int H, int W,
             const int32_t* ox, const int32_t* oy, int N, int S,
             float* out_a, float* out_b, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 37:  // SIFT's orientation windows
      return launch<37, kMaps>(a, b, H, W, ox, oy, N, S, out_a, out_b, s);
    case 79:  // SIFT's descriptor windows
      return launch<79, kMaps>(a, b, H, W, ox, oy, N, S, out_a, out_b, s);
    default:
      return launch<0, kMaps>(a, b, H, W, ox, oy, N, S, out_a, out_b, s);
  }
}

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// img: (H, W) f32; ox, oy: (N,) int32 window origins (top-left corner,
// column and row); out: (N, S, S) f32, 16-byte aligned; all contiguous on
// the device. The caller guarantees 0 < S <= 128.
extern "C" int crop_windows_f32(const float* img, int H, int W,
                                const int32_t* ox, const int32_t* oy, int N,
                                int S, float* out, void* stream) {
  return dispatch<1>(img, nullptr, H, W, ox, oy, N, S, out, nullptr, stream);
}

// The windows of two (H, W) f32 maps a and b at the same origins, in one
// launch: out_a and out_b are (N, S, S) f32, each 16-byte aligned.
extern "C" int crop_windows_pair_f32(const float* a, const float* b, int H,
                                     int W, const int32_t* ox,
                                     const int32_t* oy, int N, int S,
                                     float* out_a, float* out_b,
                                     void* stream) {
  return dispatch<2>(a, b, H, W, ox, oy, N, S, out_a, out_b, stream);
}
