// One pyramidal-LK level for all points: template, structure tensor,
// solvability and the Gauss-Newton iterations, with per-point termination.
//
// Replaces vo_tpu/ops/lk_pallas.py:_refine_kernel (TPU Pallas), which kept
// points on the 128 vector lanes, sampled through an aligned-select over
// padded window stacks, cached a guard patch and exited per lane block.
// None of that carries over: those are workarounds for the TPU's vector
// unit. Plain version: vo_tpu_torch/ops/lk_cuda.py:refine_level_reference.
//
// Semantics (vo_tpu/ops/lk.py:_refine_level, lanes layout):
// - every pixel outside a point's S x S window reads as 0 (the zero pad of
//   the lanes stacks), windows start at integer origins inside the image;
// - samples are bilinear, row blend first, then column blend, in f32 from
//   windows in the working type (bf16 windows: f32 image values are rounded
//   to bf16 on load, as the lanes crop does);
// - a step is applied, then convergence is tested on that same step; a
//   point whose search centre leaves [lo, hi] stops without moving (so does
//   one whose centre is NaN, where the plain version reads garbage);
// - termination is per point: the JAX lanes path with an early exit that
//   never fires before every point has stopped (exit_mult = N + 1).
//
// Bound on the H100: operations, but the kernel is held by latency. Each
// Gauss-Newton iteration is a dependent chain (samples, two warp sums, the
// 2x2 solve, the test), one warp per point, up to 30 links long, and each
// window is a round trip to L2, so the design keeps every point of a level
// resident at once and each link short:
// - three 8-warp blocks per SM (<= 80 registers): 3,168 resident warps for
//   the main path's 2,996 points;
// - the search window is stored in the working type (bf16 under "bf16",
//   where every value is bf16-exact) with a zero border (one pixel before,
//   one or two after: odd and even patch sizes), so the iteration loop
//   reads it without bounds checks (2.7 KB per warp at S=35, 4.8 KB at
//   S=47);
// - of the template window only the (win+3)^2 pixels that the template
//   samples read are loaded (576 of 1,225 or 2,209 at win=21), zero outside
//   the window, so sampling needs no bounds checks either;
// - loads are issued 8 per lane before any store, so a window costs a few
//   memory latencies, not one per pixel; the image's dtype is a template
//   parameter (no branch per pixel);
// - the (win+2)^2 template samples stay in shared memory, not in
//   registers, which leaves the registers to overlap a lane's 14 samples
//   (win=21): the loop reads T from them and computes Tx, Ty from them as
//   the plain version does, or, where three blocks per SM still fit (bf16
//   at S=35, not at S=47), reads (Tx, Ty) pairs stored once per point;
// - win=21, the presets' value, is compiled as a constant, with each lane's
//   pixel offsets packed in registers; other sizes take the generic
//   instantiation, which walks its pixels;
// - no division in any loop: flat indices walk (row, col) by a step found
//   once per walk;
// - warp sums are xor butterflies, which leave every lane the same bits, so
//   the solve and the exit test are warp-uniform without a broadcast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kSmemPerSM = 233472;  // bytes an SM holds, 1 KB per block
                                    // reserved

struct LKArgs {
  const void* img1;
  const void* img2;
  int H, W;
  const float* q1;    // (N, 2) local template coordinates [x, y]
  const float* q20;   // (N, 2) initial local search coordinates
  const float* flow;  // (N, 2) initial flow
  const float* org1;  // (N, 2) integer-valued template window origins
  const float* org2;  // (N, 2) search window origins
  const unsigned char* pre;  // (N,) bool
  int N, S, win, iters;
  int P;           // padded window pitch: S + 1 + (2 - win % 2)
  int samples_at;  // byte offset of the template samples in a warp's part
  int grads_at;    // byte offset of the (Tx, Ty) pairs (kGrads)
  int warp_bytes;  // shared memory per warp
  float eps2, min_eig_thr;
  float* v_out;
  unsigned char* solv_out;  // (N,) bool
  int* it_out;
};

__device__ __forceinline__ float warp_sum(float v) {
  // every lane ends with the same bits: each step adds a pair in both
  // orders, and f32 addition is commutative
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// an image pixel in the working type (f32 rounded to bf16 for bf16 windows)
template <typename Tw, typename Ti>
__device__ __forceinline__ Tw to_work(Ti v) {
  if constexpr (std::is_same_v<Tw, Ti>) {
    return v;
  } else if constexpr (std::is_same_v<Tw, float>) {
    return __bfloat162float(v);
  } else {
    return __float2bfloat16_rn(v);
  }
}

// A lane's flat indices lane, lane + 32, ... over rows of width n, as
// (row, col). A step of 32 is q rows and rem columns, found once, so each
// step is one conditional subtraction (c + rem < 2n).
struct Walk {
  int r, c, q, rem;
  __device__ __forceinline__ Walk(int lane, int n) {
    q = 32 / n;
    rem = 32 - q * n;
    r = lane / n;
    c = lane - r * n;
  }
  __device__ __forceinline__ void next(int n) {
    c += rem;
    r += q;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
};

// rows x cols window pixels from window (r0, c0) on, 0 where a pixel lies
// outside the S x S window at origin (ox, oy), into dst[d0 + r * pitch +
// c]. Each lane issues kBatch loads before any store, so a region costs a
// few memory latencies, not one per pixel.
template <typename Ti, typename Tw>
__device__ void load_region(Tw* dst, int pitch, int d0,
                            const Ti* __restrict__ img, int H, int W,
                            float fox, float foy, int S, int r0, int c0,
                            int rows, int cols, int lane) {
  constexpr int kBatch = 8;
  // origins are integer-valued and clamped by the caller; keep every read
  // in the image regardless
  const int ox = min(max(static_cast<int>(fox), 0), W - S);
  const int oy = min(max(static_cast<int>(foy), 0), H - S);
  const int n = rows * cols;
  Walk at(lane, cols);
  for (int i0 = lane; i0 < n; i0 += 32 * kBatch) {
    Walk st = at;  // the same pixels again for the stores
    Tw v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + at.r, c = c0 + at.c;
      v[u] = Tw(0.f);
      if (i0 + 32 * u < n && r >= 0 && r < S && c >= 0 && c < S) {
        v[u] = to_work<Tw>(img[(size_t)(oy + r) * W + ox + c]);
      }
      at.next(cols);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + 32 * u < n) dst[d0 + st.r * pitch + st.c] = v[u];
      st.next(cols);
    }
  }
}

// The S x S window into a P x P buffer with a zero border: window pixel
// (r, c) at (r + 1, c + 1).
template <typename Ti, typename Tw>
__device__ void load_window(Tw* w, const Ti* __restrict__ img, int H, int W,
                            float fox, float foy, int S, int P, int lane) {
  const Tw zero = Tw(0.f);
  for (int j = lane; j < P; j += 32) {  // border rows and columns
    w[j] = zero;
    for (int r = S + 1; r < P; ++r) w[r * P + j] = zero;
  }
  for (int r = 1 + lane; r <= S; r += 32) {
    w[r * P] = zero;
    for (int c = S + 1; c < P; ++c) w[r * P + c] = zero;
  }
  load_region(w, P, P + 1, img, H, W, fox, foy, S, 0, 0, S, S, lane);
  __syncwarp();
}

// bilinear sample whose top-left corner is buffer index i
template <typename Tw>
__device__ __forceinline__ float bil(const Tw* w, int i, int P, float fy,
                                     float fx) {
  const float a = to_f32(w[i]) * (1.f - fy) + to_f32(w[i + P]) * fy;
  const float b = to_f32(w[i + 1]) * (1.f - fy) + to_f32(w[i + P + 1]) * fy;
  return a * (1.f - fx) + b * fx;
}

// integer base (minus half) and fraction of a local coordinate; far-out
// values (templates outside their window, whose result is discarded) are
// clamped so the int conversion stays defined
__device__ __forceinline__ void split(float q, int S, int half, int* o,
                                      float* f) {
  const float b = floorf(q);
  *f = q - b;
  *o = (int)fminf(fmaxf(b, -2.f * S), 2.f * S) - half;
}

// Calls f(m, i) for the lane's flat indices i = lane + 32 m below n. With
// a compile-time bound M > 0 the loop is unrolled, so per-lane arrays
// indexed by m stay in registers; M == 0 runs any n.
template <int M, typename F>
__device__ __forceinline__ void for_lane(int lane, int n, F f) {
  if constexpr (M > 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (lane + 32 * m < n) f(m, lane + 32 * m);
    }
  } else {
    for (int i = lane, m = 0; i < n; i += 32, ++m) f(m, i);
  }
}

// WIN > 0: the patch size as a constant, pixel offsets in registers;
// WIN == 0: any size, offsets walked. kGrads: (Tx, Ty) stored per pixel.
template <int WIN, typename Tw, typename Ti, bool kGrads>
__global__ void __launch_bounds__(32 * kMaxWarps, 3)
    lk_refine_kernel(const LKArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.N) return;  // whole warps leave together; no block barriers

  const int win = WIN > 0 ? WIN : a.win;
  const int npx = win * win;
  const int wp = win + 2;  // template samples with their one-pixel border
  const int S = a.S, P = a.P;
  unsigned char* mine = smem + (size_t)warp * a.warp_bytes;
  Tw* w = reinterpret_cast<Tw*>(mine);  // template patch, then window
  float* Pt = reinterpret_cast<float*>(mine + a.samples_at);  // (wp, wp)
  float2* G2 = reinterpret_cast<float2*>(mine + a.grads_at);   // (npx,)
  const int half = (win + 1) / 2;  // (wp - 1) / 2
  const float lo = half - 1.f;
  const float hi = (float)(S - half);

  const float q1x = a.q1[2 * n], q1y = a.q1[2 * n + 1];
  const float q20x = a.q20[2 * n], q20y = a.q20[2 * n + 1];
  float vx = a.flow[2 * n], vy = a.flow[2 * n + 1];

  // template samples at q1 from the (wp + 1)^2 window pixels they read
  int oy, ox;
  float fy, fx;
  split(q1y, S, half, &oy, &fy);
  split(q1x, S, half, &ox, &fx);
  load_region(w, wp + 1, 0, static_cast<const Ti*>(a.img1), a.H, a.W,
              a.org1[2 * n], a.org1[2 * n + 1], S, oy, ox, wp + 1, wp + 1,
              lane);
  __syncwarp();
  constexpr int KP = WIN > 0 ? ((WIN + 2) * (WIN + 2) + 31) / 32 : 0;
  {
    Walk at(lane, wp);
    for_lane<KP>(lane, wp * wp, [&](int, int i) {
      Pt[i] = bil(w, at.r * (wp + 1) + at.c, wp + 1, fy, fx);
      at.next(wp);
    });
  }
  __syncwarp();

  // T, Tx, Ty of pixel (r, c), from the samples around index (r+1, c+1)
  auto tmpl = [&](int c, float* t, float* tx, float* ty) {
    *t = Pt[c];
    *tx = (Pt[c + 1] - Pt[c - 1]) * 0.5f;
    *ty = (Pt[c + wp] - Pt[c - wp]) * 0.5f;
  };
  constexpr int K = WIN > 0 ? (WIN * WIN + 31) / 32 : 0;
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  {
    Walk at(lane, win);
    for_lane<K>(lane, npx, [&](int, int i) {
      float t, tx, ty;
      tmpl((at.r + 1) * wp + at.c + 1, &t, &tx, &ty);
      if constexpr (kGrads) G2[i] = make_float2(tx, ty);
      gxx += tx * tx;
      gxy += tx * ty;
      gyy += ty * ty;
      at.next(win);
    });
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = gxx * gyy - gxy * gxy;
  const float trace = gxx + gyy;
  float min_eig = (trace - sqrtf(trace * trace - 4.f * det + 1e-12f)) / 2.f;
  min_eig = min_eig / (float)npx;
  const bool solvable = (det > 1e-7f) && (min_eig > a.min_eig_thr);
  const float inv_det = 1.f / (det > 1e-7f ? det : 1.f);

  int it = 0;
  if (solvable && a.pre[n]) {
    load_window(w, static_cast<const Ti*>(a.img2), a.H, a.W, a.org2[2 * n],
                a.org2[2 * n + 1], S, P, lane);
    // per pixel: window offset r * P + c (low half) and sample index
    // (r + 1) * wp + c + 1 (high half); P * P < 2^16 for this path
    unsigned off[K > 0 ? K : 1];
    if constexpr (WIN > 0) {
      Walk at(lane, win);
      for_lane<K>(lane, npx, [&](int k, int) {
        off[k] = (at.r * P + at.c) | (((at.r + 1) * wp + at.c + 1) << 16);
        at.next(win);
      });
    }
    while (it < a.iters) {
      const float q2x = q20x + vx;
      const float q2y = q20y + vy;
      // left the window (or NaN)
      if (!(q2x >= lo && q2x <= hi && q2y >= lo && q2y <= hi)) break;
      split(q2y, S, half, &oy, &fy);
      split(q2x, S, half, &ox, &fx);
      // pixel (r, c) samples window (oy + 1 + r, ox + 1 + c), which is
      // buffer (oy + 2 + r, ox + 2 + c): always inside the zero border
      const int base = (oy + 2) * P + ox + 2;
      float bx = 0.f, by = 0.f;
      auto pixel = [&](int o, int c, int i) {
        float t, tx, ty;
        if constexpr (kGrads) {
          const float2 g = G2[i];
          t = Pt[c];
          tx = g.x;
          ty = g.y;
        } else {
          tmpl(c, &t, &tx, &ty);
        }
        const float dI = bil(w, base + o, P, fy, fx) - t;
        bx += dI * tx;
        by += dI * ty;
      };
      if constexpr (WIN > 0) {
        for_lane<K>(lane, npx, [&](int k, int i) {
          pixel(off[k] & 0xffffu, off[k] >> 16, i);
        });
      } else {
        Walk at(lane, win);
        for_lane<0>(lane, npx, [&](int, int i) {
          pixel(at.r * P + at.c, (at.r + 1) * wp + at.c + 1, i);
          at.next(win);
        });
      }
      bx = warp_sum(bx);
      by = warp_sum(by);
      const float dvx = -(gyy * bx - gxy * by) * inv_det;
      const float dvy = -(-gxy * bx + gxx * by) * inv_det;
      vx += dvx;
      vy += dvy;
      ++it;
      if (dvx * dvx + dvy * dvy < a.eps2) break;
    }
  }
  if (lane == 0) {
    a.v_out[2 * n] = vx;
    a.v_out[2 * n + 1] = vy;
    a.solv_out[n] = solvable;
    a.it_out[n] = it;
  }
}

template <int WIN, typename Tw, typename Ti, bool kGrads>
int launch(const LKArgs& a, cudaStream_t stream) {
  const int warps = min(kMaxWarps, kSmemLimit / a.warp_bytes);
  if (warps < 1) return (int)cudaErrorInvalidValue;  // window too large
  const size_t smem = (size_t)warps * a.warp_bytes;
  auto kernel = lk_refine_kernel<WIN, Tw, Ti, kGrads>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.N + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WIN, typename Tw, typename Ti>
int launch_grads(const LKArgs& a, cudaStream_t s) {
  return a.grads_at ? launch<WIN, Tw, Ti, true>(a, s)
                    : launch<WIN, Tw, Ti, false>(a, s);
}

template <int WIN>
int launch_types(const LKArgs& a, int bf16_images, int bf16_windows,
                 cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (bf16_windows) {
    return bf16_images ? launch_grads<WIN, bf16, bf16>(a, s)
                       : launch_grads<WIN, bf16, float>(a, s);
  }
  return bf16_images ? launch_grads<WIN, float, bf16>(a, s)
                     : launch_grads<WIN, float, float>(a, s);
}

constexpr int kFixedWin = 21;  // the presets' window

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// img1/img2: (H, W) level images of the template and search frames, both
// bf16 (bf16_images) or both f32; bf16_windows stores windows in bf16 (f32
// pixels are rounded on load), else in f32. q1, q20, flow, org1, org2:
// (N, 2) f32 (origins integer-valued); pre: (N,) bool. Outputs: v (N, 2)
// f32, solvable (N,) bool, iterations (N,) i32.
extern "C" int lk_refine_level(const void* img1, const void* img2,
                               int bf16_images, int bf16_windows, int H,
                               int W, const float* q1, const float* q20,
                               const float* flow, const unsigned char* pre,
                               const float* org1, const float* org2, int N,
                               int S, int win, int iters, float eps2,
                               float min_eig_thr, float* v_out,
                               unsigned char* solv_out, int* it_out,
                               void* stream) {
  if (N == 0) return 0;
  LKArgs a{img1, img2, H, W, q1, q20, flow, org1, org2, pre, N, S, win,
           iters, 0, 0, 0, 0, eps2, min_eig_thr, v_out, solv_out, it_out};
  a.P = S + 1 + (2 - win % 2);
  // per warp: the window (which first holds the template patch), the
  // template samples, and where they fit the (Tx, Ty) pairs
  auto up16 = [](size_t b) { return (b + 15) & ~(size_t)15; };
  const size_t cells = (size_t)max(a.P * a.P, (win + 3) * (win + 3));
  const size_t wbytes = up16(cells * (bf16_windows ? 2 : 4));
  const size_t samples = up16((size_t)(win + 2) * (win + 2) * sizeof(float));
  const size_t grads = (size_t)win * win * sizeof(float2);
  size_t warp_bytes = wbytes + samples;
  // the pairs save 3 shared-memory loads and 4 operations per sample, but
  // only pay while three 8-warp blocks still fit an SM (bf16 at S=35, not
  // at S=47): otherwise a level no longer fits on the card at once
  if (3 * (kMaxWarps * (warp_bytes + grads) + 1024) <= (size_t)kSmemPerSM) {
    a.grads_at = (int)warp_bytes;
    warp_bytes += grads;
  }
  if (warp_bytes > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  a.samples_at = (int)wbytes;
  a.warp_bytes = (int)up16(warp_bytes);
  const bool fixed = win == kFixedWin && a.P * a.P < 65536;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fixed ? launch_types<kFixedWin>(a, bf16_images, bf16_windows, s)
               : launch_types<0>(a, bf16_images, bf16_windows, s);
}
