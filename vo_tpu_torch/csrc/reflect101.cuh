// Reflect-101 border rule shared by the kernels that read past an edge
// (separable_blur.cu, row_conv.cu). Python's copy: ops/conv.py:reflect101.
#pragma once

// Periodic reflect-101: index mod 2(n-1), then mirrored, so a halo wider
// than the axis (SIFT's 6x20 octave under a radius-12 blur) reflects again
// and again, as jnp.pad(mode="reflect") does; n == 1 maps to 0. Every
// index, also far past a ragged tile edge, lands inside the axis.
__device__ __forceinline__ int reflect101(int i, int n) {
  if ((unsigned)i < (unsigned)n) return i;  // inside: no division
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i > n - 1 ? p - i : i;
}
