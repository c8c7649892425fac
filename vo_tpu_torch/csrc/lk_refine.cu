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
//   point whose search centre leaves [lo, hi] stops without moving;
// - termination is per point: the JAX lanes path with an early exit that
//   never fires before every point has stopped (exit_mult = N + 1).
//
// Bound on the H100: operations. Per solvable point the function needs
// (win+2)^2 bilinear samples for the template, then per iteration one
// sample per template pixel and two products, against a few KB of window
// reads. Design: one warp per point (4 per block). The point's window is
// read from the level image once into shared memory (template window
// first, then the search window in the same buffer); the (win+2)^2
// template samples are taken once into shared memory and the gradients are
// their central differences (as in the plain version), so the template
// costs one sample per patch pixel; T, Tx and Ty are stored contiguous for
// the iterations (reading T from inside the padded patch cost ~7 % of the
// kernel's time on an H100); every bilinear sample reads shared
// memory directly; sums are warp shuffles; the iteration loop runs inside
// the kernel, so the host never waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return __shfl_sync(kFull, v, 0);  // every lane takes lane 0's value
}

__device__ __forceinline__ float load_px(const void* img, int is_bf16,
                                         size_t idx, int round_bf16) {
  float v = is_bf16
                ? __bfloat162float(static_cast<const __nv_bfloat16*>(img)[idx])
                : static_cast<const float*>(img)[idx];
  if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// window value, zero outside the S x S window
__device__ __forceinline__ float wv(const float* w, int S, int r, int c) {
  return (r >= 0 && r < S && c >= 0 && c < S) ? w[r * S + c] : 0.f;
}

// bilinear sample between window rows r, r+1 and cols c, c+1
__device__ __forceinline__ float bil(const float* w, int S, int r, int c,
                                     float fy, float fx) {
  const float a = wv(w, S, r, c) * (1.f - fy) + wv(w, S, r + 1, c) * fy;
  const float b = wv(w, S, r, c + 1) * (1.f - fy) + wv(w, S, r + 1, c + 1) * fy;
  return a * (1.f - fx) + b * fx;
}

__device__ __forceinline__ void load_window(float* w, const void* img,
                                            int is_bf16, int round_bf16,
                                            int H, int W, int ox, int oy,
                                            int S, int lane) {
  ox = min(max(ox, 0), W - S);  // origins are clamped by the caller; keep
  oy = min(max(oy, 0), H - S);  // every read in the image regardless
  for (int i = lane; i < S * S; i += 32) {
    const int r = i / S;
    const int c = i - r * S;
    w[i] = load_px(img, is_bf16, (size_t)(oy + r) * W + (ox + c), round_bf16);
  }
  __syncwarp();
}

// integer base and fraction of a local coordinate; far-out values (points
// whose template lies outside the window, whose result is discarded) are
// clamped so the int conversion stays defined
__device__ __forceinline__ void split(float q, int S, int half, int* o,
                                      float* f) {
  const float b = floorf(q);
  *f = q - b;
  *o = (int)fminf(fmaxf(b, -2.f * S), 2.f * S) - half;
}

__global__ void lk_refine_kernel(const void* img1, int bf1, const void* img2,
                                 int bf2, int round_bf16, int H, int W,
                                 const float* __restrict__ io,
                                 const unsigned char* __restrict__ pre,
                                 const int* __restrict__ org, int N, int S,
                                 int win, int iters, float eps2,
                                 float min_eig_thr, float* v_out,
                                 unsigned char* solv_out, int* it_out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;  // whole warps leave together; no block barriers

  const int npx = win * win;
  const int wp = win + 2;  // template samples with their one-pixel border
  float* w = smem + warp * (S * S + wp * wp + 3 * npx);
  float* P = w + S * S;  // (wp, wp) samples around the template
  float* T = P + wp * wp;
  float* Tx = T + npx;
  float* Ty = Tx + npx;
  const int half = (win + 1) / 2;  // (wp - 1) / 2
  const float lo = half - 1.f;
  const float hi = (float)(S - half);

  const float* p = io + 6 * n;
  const float q1x = p[0], q1y = p[1], q20x = p[2], q20y = p[3];
  float vx = p[4], vy = p[5];

  // template samples at q1, then central-difference gradients
  load_window(w, img1, bf1, round_bf16, H, W, org[4 * n], org[4 * n + 1], S,
              lane);
  int oy, ox;
  float fy, fx;
  split(q1y, S, half, &oy, &fy);
  split(q1x, S, half, &ox, &fx);
  for (int i = lane; i < wp * wp; i += 32) {
    P[i] = bil(w, S, oy + i / wp, ox + i % wp, fy, fx);
  }
  __syncwarp();
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  for (int i = lane; i < npx; i += 32) {
    const int c = (i / win + 1) * wp + i % win + 1;  // T[i] is P[c]
    const float tx = (P[c + 1] - P[c - 1]) * 0.5f;
    const float ty = (P[c + wp] - P[c - wp]) * 0.5f;
    T[i] = P[c];
    Tx[i] = tx;
    Ty[i] = ty;
    gxx += tx * tx;
    gxy += tx * ty;
    gyy += ty * ty;
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = gxx * gyy - gxy * gxy;
  const float trace = gxx + gyy;
  float min_eig = (trace - sqrtf(trace * trace - 4.f * det + 1e-12f)) / 2.f;
  min_eig = min_eig / (float)npx;
  const bool solvable = (det > 1e-7f) && (min_eig > min_eig_thr);
  const float inv_det = 1.f / (det > 1e-7f ? det : 1.f);

  int it = 0;
  if (solvable && pre[n]) {
    __syncwarp();  // every lane is done with the template window
    load_window(w, img2, bf2, round_bf16, H, W, org[4 * n + 2],
                org[4 * n + 3], S, lane);
    while (it < iters) {
      const float q2x = q20x + vx;
      const float q2y = q20y + vy;
      if (q2x < lo || q2x > hi || q2y < lo || q2y > hi) break;  // left window
      split(q2y, S, half, &oy, &fy);
      split(q2x, S, half, &ox, &fx);
      float bx = 0.f, by = 0.f;
      for (int i = lane; i < npx; i += 32) {
        const float dI =
            bil(w, S, oy + i / win + 1, ox + i % win + 1, fy, fx) - T[i];
        bx += dI * Tx[i];
        by += dI * Ty[i];
      }
      bx = warp_sum(bx);
      by = warp_sum(by);
      const float dvx = -(gyy * bx - gxy * by) * inv_det;
      const float dvy = -(-gxy * bx + gxx * by) * inv_det;
      vx += dvx;
      vy += dvy;
      ++it;
      if (dvx * dvx + dvy * dvy < eps2) break;
    }
  }
  if (lane == 0) {
    v_out[2 * n] = vx;
    v_out[2 * n + 1] = vy;
    solv_out[n] = solvable;
    it_out[n] = it;
  }
}

}  // namespace

extern "C" const char* vo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// img1/img2: (H, W) level images of the template and search frames, f32 or
// bf16 (is_bf16 flags); round_bf16 rounds f32 pixels to bf16 on load.
// io: (N, 6) f32 [q1x, q1y, q20x, q20y, v0x, v0y]; pre: (N,) u8;
// org: (N, 4) i32 [o1x, o1y, o2x, o2y]. Outputs: v (N, 2) f32, solvable
// (N,) u8, iterations (N,) i32.
extern "C" int lk_refine_level(const void* img1, int bf1, const void* img2,
                               int bf2, int round_bf16, int H, int W,
                               const float* io, const unsigned char* pre,
                               const int* org, int N, int S, int win,
                               int iters, float eps2, float min_eig_thr,
                               float* v_out, unsigned char* solv_out,
                               int* it_out, void* stream) {
  if (N == 0) return 0;
  const size_t wp = win + 2;
  const size_t smem =
      sizeof(float) * kWarps * ((size_t)S * S + wp * wp + 3 * win * win);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lk_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kWarps - 1) / kWarps;
  lk_refine_kernel<<<blocks, 32 * kWarps, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      img1, bf1, img2, bf2, round_bf16, H, W, io, pre, org, N, S, win, iters,
      eps2, min_eig_thr, v_out, solv_out, it_out);
  return (int)cudaGetLastError();
}
