// Same-size 1-D correlation along rows, along columns, or both from one
// read, reflect-101 borders, batched over planes.
//
// Replaces vo_tpu/ops/pallas_conv.py:_row_conv_kernel (TPU Pallas), which
// accumulated the taps over overlapped 512-wide column tiles copied out in
// XLA beforehand, and did the column pass as transpose, row pass,
// transpose. Plain version: vo_tpu_torch/ops/rowconv_cuda.py:
// conv_reference. On SIFT's path it computes both gradient maps of the
// layer-flattened Gaussian canvas in one launch (vo_tpu/frontend/sift.py:
// _grad_maps): a (7056, 2560) f32 plane at KITTI shape, taps (-0.5, 0,
// 0.5).
//
// Bound on the H100: bytes. A 3-tap pass costs 2 multiplies and an add per
// pixel against 8 bytes of device traffic (one f32 read, one f32 write);
// both passes from one read move 12 bytes per pixel.
//
// Design (radius <= 4): a warp owns 128 adjacent columns, a lane 4 of them
// (one float4), over a strip of kRows = 4 rows. The lane issues all loads
// of its float4 of rows y0-r ... y0+kRows-1+r (in batches for r > 1)
// before any store and keeps the last 2r+1 rows in registers for the
// column pass. The row pass takes the neighbouring columns from the
// adjacent lanes by shuffles; the first and last lane of the warp load the
// few columns past the warp themselves. No shared memory, no
// __syncthreads() and no division per element. Short strips make many
// small warps, which hid the loads' latency better than 8- to 32-row
// strips; the rows they read twice (the column pass's halo) come from L2.
// Reflection is done only by warps whose strip touches an edge of the
// plane (and everywhere when W is not a multiple of 4, where rows are not
// 16-byte aligned and loads are scalar); the others take a path without
// index arithmetic. A radius below the compiled one is padded with zero
// taps, which are skipped. The column pass reads its halo rows from the
// plane's neighbouring rows: on the layer-flattened canvas a layer's edge
// row sees the next layer's rows, as vo_tpu's does; reflection happens
// only at the ends of the plane.
//
// Radii 5 .. 64 (one axis only) take the generic kernel below:
// one block per 32x128 output tile, the tile and its halo along the pass's
// axis staged in shared memory with periodic reflect-101 indices.
//
// Each output is the plain version's sum in its order (zero taps skipped,
// products and sums rounded separately, no FMA), so every kernel here
// agrees with it bit for bit. Taps travel by value in the parameters.

#include <cuda_runtime.h>

#include <cstring>

#include "reflect101.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- radius <= 4: registers and shuffles ----------------------------------

constexpr int kWarps = 4;        // warps per block, side by side
constexpr int kWarpCols = 128;   // columns per warp: 32 lanes x float4
constexpr int kRows = 4;         // output rows per warp
constexpr int kMaxSmallR = 4;

enum Mode { kRowsOnly = 0, kColsOnly = 1, kBoth = 2 };

template <int kR>
struct SmallTaps {  // 2 kR + 1 taps, a radius below kR padded with zeros
  float t[2 * kR + 1];
};

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void put(float4& v, int k, float f) {
  if (k == 0) v.x = f;
  else if (k == 1) v.y = f;
  else if (k == 2) v.z = f;
  else v.w = f;
}

// The plain version's sum: zero taps skipped, products and sums rounded
// separately. vals(t) is the sample under tap t.
template <int kN, typename F>
__device__ __forceinline__ float tap_sum(const float* t, F vals) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (t[k] != 0.f) {
      const float term = __fmul_rn(t[k], vals(k));
      acc = first ? term : __fadd_rn(acc, term);
      first = false;
    }
  }
  return acc;
}

// Columns x .. x+3 of one row. kEdge: columns may lie outside [0, W)
// (reflected); kAligned: W % 4 == 0, so x .. x+3 is a float4 when x < W.
template <bool kEdge, bool kAligned>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int x,
                                        int W) {
  if (!kEdge) return __ldg(reinterpret_cast<const float4*>(row + x));
  if (kAligned && x < W) return __ldg(reinterpret_cast<const float4*>(row + x));
  float4 v;
#pragma unroll
  for (int j = 0; j < 4; ++j) put(v, j, __ldg(row + reflect101(x + j, W)));
  return v;
}

template <bool kEdge, bool kAligned>
__device__ __forceinline__ void store4(float* __restrict__ row, int x, int W,
                                       float4 v) {
  if (!kEdge || (kAligned && x < W)) {
    *reinterpret_cast<float4*>(row + x) = v;
  } else if (!kAligned) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < W) row[x + j] = get(v, j);
  }
}

// One warp's strip: rows y0 .. y0+kRows-1 of columns x .. x+3 per lane
// (x = xw + 4 lane). yr and yc are the row- and column-pass outputs of the
// plane (one may be unused, as kMode says).
template <int kR, int kMode, bool kEdge, bool kAligned>
__device__ __forceinline__ void conv_strip(const float* __restrict__ xp,
                                           float* __restrict__ yr,
                                           float* __restrict__ yc, int H,
                                           int W, int x, int y0, int lane,
                                           const SmallTaps<kR>& taps) {
  constexpr bool kRowPass = kMode != kColsOnly;
  constexpr bool kColPass = kMode != kRowsOnly;
  constexpr int kHalo = kColPass ? kR : 0;  // halo rows above and below
  constexpr int kLoads = kRows + 2 * kHalo;
  constexpr int kBatch = kR <= 1 ? 8 : 4;
  constexpr int kWin = 2 * kHalo + 1;
  constexpr int kSide = kRowPass ? kR : 1;  // halo columns per side

  float4 win[kWin];  // the column pass's last kWin rows
#pragma unroll
  for (int b0 = 0; b0 < kLoads; b0 += kBatch) {
    float4 cur[kBatch];
    float left[kBatch][kSide], right[kBatch][kSide];
    // every load of the batch before any use
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int li = b0 + i;
      if (li >= kLoads) break;
      const int y = y0 - kHalo + li;
      const float* row = xp + (size_t)(kEdge ? reflect101(y, H) : y) * W;
      cur[i] = load4<kEdge, kAligned>(row, x, W);
      if (kRowPass && li >= kHalo && li < kHalo + kRows) {
        // columns past the warp, for the lanes whose neighbours those are
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const int o = k - kR;  // offsets -kR .. -1
          if (4 * lane + o < 0) {
            const int c = x + o;
            left[i][k] = __ldg(row + (kEdge ? reflect101(c, W) : c));
          }
          const int o2 = 4 + k;  // offsets 4 .. 3+kR
          if (4 * lane + o2 >= kWarpCols) {
            const int c = x + o2;
            right[i][k] = __ldg(row + (kEdge ? reflect101(c, W) : c));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int li = b0 + i;
      if (li >= kLoads) break;
      if (kRowPass && li >= kHalo && li < kHalo + kRows) {
        const int y = y0 + li - kHalo;
        // v[m]: the sample at column x - kR + m
        float v[4 + 2 * kR];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const int o = k - kR;
          const int d = (-o + 3) / 4;  // lanes to the left
          const float s = __shfl_up_sync(kFull, get(cur[i], o + 4 * d), d);
          v[k] = 4 * lane + o < 0 ? left[i][k] : s;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[kR + j] = get(cur[i], j);
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const int o = 4 + k;
          const int d = o / 4;  // lanes to the right
          const float s = __shfl_down_sync(kFull, get(cur[i], o - 4 * d), d);
          v[kR + 4 + k] = 4 * lane + o >= kWarpCols ? right[i][k] : s;
        }
        float4 out;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          put(out, j, tap_sum<2 * kR + 1>(taps.t,
                                          [&](int t) { return v[j + t]; }));
        if (!kEdge || y < H) store4<kEdge, kAligned>(yr + (size_t)y * W, x, W,
                                                     out);
      }
      if (kColPass) {
#pragma unroll
        for (int k = 0; k + 1 < kWin; ++k) win[k] = win[k + 1];
        win[kWin - 1] = cur[i];
        if (li >= 2 * kHalo) {
          const int y = y0 + li - 2 * kHalo;
          float4 out;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            put(out, j, tap_sum<kWin>(taps.t,
                                      [&](int t) { return get(win[t], j); }));
          if (!kEdge || y < H) store4<kEdge, kAligned>(yc + (size_t)y * W, x,
                                                       W, out);
        }
      }
    }
  }
}

// No __launch_bounds__: with one, ptxas capped the registers at 64-128 and
// spilled.
template <int kR, int kMode, bool kAligned>
__global__ void conv_small_kernel(const float* __restrict__ x,
                                  float* __restrict__ yr,
                                  float* __restrict__ yc, int H, int W,
                                  const __grid_constant__ SmallTaps<kR> taps) {
  const int lane = threadIdx.x & 31;
  const int xw = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kWarpCols;
  if (xw >= W) return;  // the whole warp lies past the plane
  const int y0 = blockIdx.y * kRows;
  const size_t plane = (size_t)H * W * blockIdx.z;
  const float* xp = x + plane;
  float* pr = kMode != kColsOnly ? yr + plane : nullptr;
  float* pc = kMode != kRowsOnly ? yc + plane : nullptr;
  const int xl = xw + 4 * lane;
  if constexpr (kAligned) {
    constexpr int hx = kMode != kColsOnly ? kR : 0;
    constexpr int hy = kMode != kRowsOnly ? kR : 0;
    if (xw >= hx && xw + kWarpCols + hx <= W && y0 >= hy &&
        y0 + kRows + hy <= H) {
      conv_strip<kR, kMode, false, true>(xp, pr, pc, H, W, xl, y0, lane,
                                         taps);
      return;
    }
  }
  conv_strip<kR, kMode, true, kAligned>(xp, pr, pc, H, W, xl, y0, lane, taps);
}

template <int kR, int kMode, bool kAligned>
int launch_small(const float* x, float* yr, float* yc, int B, int H, int W,
                 const float* taps, int r, cudaStream_t stream) {
  SmallTaps<kR> t = {};
  std::memcpy(t.t + (kR - r), taps, sizeof(float) * (2 * r + 1));
  dim3 grid((W + kWarps * kWarpCols - 1) / (kWarps * kWarpCols),
            (H + kRows - 1) / kRows, B);
  conv_small_kernel<kR, kMode, kAligned>
      <<<grid, kWarps * 32, 0, stream>>>(x, yr, yc, H, W, t);
  return (int)cudaGetLastError();
}

template <int kMode>
int dispatch_small(const float* x, float* yr, float* yc, int B, int H, int W,
                   const float* taps, int r, cudaStream_t stream) {
  if ((H + kRows - 1) / kRows > 65535) return (int)cudaErrorInvalidValue;
  const bool aligned = W % 4 == 0;
  if (r <= 1)
    return aligned
               ? launch_small<1, kMode, true>(x, yr, yc, B, H, W, taps, r,
                                              stream)
               : launch_small<1, kMode, false>(x, yr, yc, B, H, W, taps, r,
                                               stream);
  return aligned ? launch_small<kMaxSmallR, kMode, true>(x, yr, yc, B, H, W,
                                                         taps, r, stream)
                 : launch_small<kMaxSmallR, kMode, false>(x, yr, yc, B, H, W,
                                                          taps, r, stream);
}

// ---- radius 5 .. 64, one axis: a shared-memory tile ------------------------

constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 129;  // radius <= 64

struct Taps {  // 516 bytes of kernel parameters (the limit is 4 KB)
  float t[kMaxTaps];
};

__global__ void row_conv_wide_kernel(const float* __restrict__ x,
                                     float* __restrict__ y, int H, int W,
                                     const __grid_constant__ Taps taps, int r,
                                     int along_cols) {
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

int launch_wide(const float* x, float* y, int B, int H, int W,
                const float* taps, int r, int along_cols,
                cudaStream_t stream) {
  Taps t = {};
  std::memcpy(t.t, taps, sizeof(float) * (2 * r + 1));
  const int hy = along_cols ? r : 0;
  const int hx = along_cols ? 0 : r;
  const size_t smem =
      sizeof(float) * (size_t)(kTileH + 2 * hy) * (kTileW + 2 * hx);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_conv_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  row_conv_wide_kernel<<<grid, kThreads, smem, stream>>>(x, y, H, W, t, r,
                                                         along_cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, H, W) f32 contiguous on the device, 16-byte aligned; taps:
// 2*r+1 f32 values in host memory (copied into the launch's parameters);
// along_cols: 0 for a pass along each row (the last axis), 1 along each
// column. The caller guarantees r <= 64 and B <= 65535.
extern "C" int row_conv_f32(const float* x, float* y, int B, int H, int W,
                            const float* taps, int r, int along_cols,
                            void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r > kMaxSmallR) return launch_wide(x, y, B, H, W, taps, r, along_cols, s);
  return along_cols
             ? dispatch_small<kColsOnly>(x, nullptr, y, B, H, W, taps, r, s)
             : dispatch_small<kRowsOnly>(x, y, nullptr, B, H, W, taps, r, s);
}

// Both passes from one read of x: yr along each row, yc along each column,
// each (B, H, W) f32 contiguous and 16-byte aligned. The caller guarantees
// r <= 4 and B <= 65535.
extern "C" int row_conv_pair_f32(const float* x, float* yr, float* yc, int B,
                                 int H, int W, const float* taps, int r,
                                 void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (r > kMaxSmallR) return (int)cudaErrorInvalidValue;
  return dispatch_small<kBoth>(x, yr, yc, B, H, W, taps, r,
                               static_cast<cudaStream_t>(stream));
}
