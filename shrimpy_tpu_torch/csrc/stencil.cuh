// What the stencil kernels share: the packed tap layout, the sliding window
// that gives a thread four outputs of a 1-D convolution from one walk over
// its source (rl_iter.cu; rl_half.cu walks whole 16-byte pieces with the same
// taps), the rounding of Biggs' extrapolated point, and the shared-memory
// opt-in.
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
__host__ __device__ constexpr int odd(int n) { return n | 1; }

// Floats of one term's packed taps: kz (zeros to a multiple of 4), then the
// ky and kx windows.
__host__ __device__ inline int term_tap_floats(int nkz, int nky, int nkx) {
  return round4(nkz) + window_taps(nky) + window_taps(nkx);
}

// Four steps of the sliding window: acc[j] += t[d + j] * line[(at - d) *
// step], d = 0..3. kLo / kHi clamp the source index to >= 0 / <= last.
template <bool kLo, bool kHi>
__device__ __forceinline__ void window_steps(const float* __restrict__ line, int step, int at,
                                             int last, const float4 a, const float4 b,
                                             float (&acc)[4]) {
  const float t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    int u = at - d;
    if (kHi) u = min(u, last);
    if (kLo) u = max(u, 0);
    const float v = line[u * step];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(t[d + j], v, acc[j]);
  }
}

// acc[j] += sum_i taps[i] * line[(top - 3 - i + j) * step], j = 0..3: four
// outputs at positions pos .. pos + 3 of a k-tap pass over `line`, with
// top = pos + 3 + k - 1 the last source element any of them reads. tp is the
// padded tap list (tp[3 + i] = taps[i]); n4 = round4(k + 3) steps. A source
// index outside [0, last] meets only zero taps and is clamped to a finite
// element: the first four steps can pass `last`, the last four can pass 0.
__device__ __forceinline__ void window4(const float* __restrict__ line, int step, int top,
                                        int last, const float* __restrict__ tp, int n4,
                                        float (&acc)[4]) {
  const float4* tp4 = reinterpret_cast<const float4*>(tp);
  float4 a = tp4[0], b = tp4[1];
  if (n4 == 4) {
    window_steps<true, true>(line, step, top, last, a, b, acc);
    return;
  }
  window_steps<false, true>(line, step, top, last, a, b, acc);
  int n = 4;
  for (; n < n4 - 4; n += 4) {
    a = b;
    b = tp4[(n >> 2) + 1];
    window_steps<false, false>(line, step, top - n, last, a, b, acc);
  }
  a = b;
  b = tp4[(n >> 2) + 1];
  window_steps<true, false>(line, step, top - n, last, a, b, acc);
}

// The extrapolated point y = max(x + alpha*dx, 0), rounded as the plain
// version rounds it (x + alpha*dx as a product, then a sum, never one
// FMA): every kernel that forms y (as the input of ratio_accel, in the
// epilogue of mult_accel) must form the same y bit for bit, or
// g = x_new - y is off by an ulp.
__device__ __forceinline__ float extrapolate(float x, __nv_bfloat16 d, float alpha) {
  return fmaxf(__fadd_rn(x, __fmul_rn(alpha, __bfloat162float(d))), 0.f);
}

// Opt in to more than 48 KB of dynamic shared memory.
inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
