// What the stencil kernels share: the packed tap layout, the sliding window
// that gives a thread four outputs of a 1-D convolution from one walk over
// its source (rl_half.cu, rl_iter.cu), the rounding of Biggs' extrapolated
// point, the circular index, and the shared-memory opt-in.
//
// Convention everywhere: (A v)[n] = sum_i k[i] * v[n + r - i], each output
// summed from zero in ascending tap order with one FMA a tap, so every kernel
// that uses these helpers gives the bits of the plain PyTorch version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round32(int n) { return (n + 31) & ~31; }
// Padded length of a k-tap list for the sliding window: 3 zeros, the taps,
// zeros to a multiple of 4, and one more float4 that the window reads ahead.
__host__ __device__ constexpr int window_taps(int k) { return round4(k + 3) + 4; }

// Floats of one term's packed taps: kz (zeros to a multiple of 4), then the
// ky and kx windows.
__host__ __device__ constexpr int term_tap_floats(int nkz, int nky, int nkx) {
  return round4(nkz) + window_taps(nky) + window_taps(nkx);
}

// Four steps of a sliding window on values in registers: acc[j] += t[d + j] *
// v[d], d = 0..3 in this order, t the eight taps of a and b. Walking a source
// down from its last element, step s of output j meets tap s + j - 3 of the
// padded list (window_taps): each output adds its taps in ascending order.
__device__ __forceinline__ void window_fma(const float4 a, const float4 b, const float (&v)[4],
                                           float (&acc)[4]) {
  const float t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(t[d + j], v[d], acc[j]);
}

// The extrapolated point y = max(x + alpha*dx, 0), rounded as the plain
// version rounds it (x + alpha*dx as a product, then a sum, never one
// FMA): every kernel that forms y (as the input of ratio_accel, in the
// epilogue of mult_accel) must form the same y bit for bit, or
// g = x_new - y is off by an ulp.
__device__ __forceinline__ float extrapolate(float x, __nv_bfloat16 d, float alpha) {
  return fmaxf(__fadd_rn(x, __fmul_rn(alpha, __bfloat162float(d))), 0.f);
}

// m mod n in [0, n) for any m: the index of a circular boundary (convzy.cu,
// rl_half.cu built with RL_HALF_WRAP). One wrap by an add; the divisions of
// a true modulo only where a radius reaches past the axis (they were most of
// a seam block's copy issue in rl_half's circular build).
__device__ __forceinline__ int wrap_index(int m, int n) {
  if (m < 0)
    m += n;
  else if (m >= n)
    m -= n;
  return (m >= 0 && m < n) ? m : ((m % n) + n) % n;
}

// Opt in to more than 48 KB of dynamic shared memory.
inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
