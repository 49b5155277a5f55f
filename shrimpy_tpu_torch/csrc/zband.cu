// The banded z-sum of the fft2z Richardson-Lucy: per-plane OTFs times a
// sliding window of the (y, x) half spectrum, summed over the PSF's planes.
//
// No TPU kernel: the JAX package writes this sum in XLA,
// shrimpy_tpu/ops/deconv.py::_rl_fft2z_jit (:340), its inner band() (:445)
// between the batched 2-D transforms, which XLA fuses on the TPU. Eager
// PyTorch runs it as 2 kz launches, each with a full temporary. Here it is
// one pass. With S the spectrum (gz, gy, gxr), H the per-plane OTFs
// (kz, gy, gxr), both complex64, and rz = kz / 2:
//
//   conv (half-step 1, body_b :459): out[z] = sum_t H[kz-1-t] S[(z+t-rz) mod gz]
//   corr (half-step 2, body_c :480): out[z] = sum_t conj(H[t]) S[(z+t-rz) mod gz]
//
// summed in float32 in ascending t, as band() does. JAX materialises rz
// wrap planes on each side of the spectrum; the kernel indexes modulo gz
// instead: the same sums, one buffer fewer.
//
// Bound on the card: bytes. Each spectrum plane is read once, the taps once
// and the output written once: at the production grid (144, 3000, 961) with
// kz = 15, 3.32 + 0.35 + 3.32 GB over 3.35 TB/s = 2.09 ms. The operations,
// 8 kz a complex output (50 GFLOP there), take 0.75 ms at the float32 peak.
//
// Design: one thread a (y, kx) column, marching z. Its kz taps and a window
// of the last kz spectrum values stay in registers (kz <= 31, odd: the
// register kernel compiled for each such kz), so every spectrum value is
// read once per march; the window is a ring indexed by (step + t) mod kz,
// which the full unroll of kz steps turns into fixed registers (no moves).
// Neighbouring threads read neighbouring columns: a warp's loads are 256
// contiguous bytes a plane. z is split into segments only where the grid
// has too few columns to fill the card (each segment re-reads kz - 1 planes).
// Any other kz (even, or past 31) takes zband_any_kernel, which reads its
// taps and window from memory at every output.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Threads a launch aims for before it splits z into segments.
constexpr long long kWantThreads = 1LL << 20;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ long long wrap(long long i, long long n) {
  long long r = i % n;
  return r < 0 ? r + n : r;
}

// The tap that multiplies window element t: H[kz-1-t] (conv) or conj(H[t]).
__device__ __forceinline__ float2 tap_of(const float2* __restrict__ h, long long kz, long long t,
                                         long long cols, long long col, int corr) {
  if (corr) {
    float2 v = __ldg(h + t * cols + col);
    return make_float2(v.x, -v.y);
  }
  return __ldg(h + (kz - 1 - t) * cols + col);
}

template <int KZ>
__global__ void __launch_bounds__(kThreads)
zband_reg_kernel(const float2* __restrict__ s, const float2* __restrict__ h,
                 float2* __restrict__ out, long long gz, long long cols, long long seg_len,
                 int corr) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  const long long z0 = (long long)blockIdx.y * seg_len;
  const long long z1 = min(z0 + seg_len, gz);
  constexpr int R = KZ / 2;
  float2 tap[KZ];
#pragma unroll
  for (int t = 0; t < KZ; ++t) tap[t] = tap_of(h, KZ, t, cols, col, corr);
  // win[(step + t) % KZ] holds S[z - R + t] for the output z of this step.
  float2 win[KZ];
  long long p = wrap(z0 - R, gz);
#pragma unroll
  for (int i = 0; i < KZ - 1; ++i) {
    win[i] = __ldg(s + p * cols + col);
    p = p + 1 == gz ? 0 : p + 1;
  }
  for (long long zb = z0; zb < z1; zb += KZ) {
#pragma unroll
    for (int r = 0; r < KZ; ++r) {
      if (zb + r >= z1) break;
      win[(r + KZ - 1) % KZ] = __ldg(s + p * cols + col);
      p = p + 1 == gz ? 0 : p + 1;
      float2 acc = cmul(tap[0], win[r % KZ]);
#pragma unroll
      for (int t = 1; t < KZ; ++t) acc = cadd(acc, cmul(tap[t], win[(r + t) % KZ]));
      out[(zb + r) * cols + col] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
zband_any_kernel(const float2* __restrict__ s, const float2* __restrict__ h,
                 float2* __restrict__ out, long long gz, long long kz, long long cols,
                 long long seg_len, int corr) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= cols) return;
  const long long z0 = (long long)blockIdx.y * seg_len;
  const long long z1 = min(z0 + seg_len, gz);
  for (long long z = z0; z < z1; ++z) {
    long long p = wrap(z - kz / 2, gz);
    float2 acc = cmul(tap_of(h, kz, 0, cols, col, corr), __ldg(s + p * cols + col));
    for (long long t = 1; t < kz; ++t) {
      p = p + 1 == gz ? 0 : p + 1;
      acc = cadd(acc, cmul(tap_of(h, kz, t, cols, col, corr), __ldg(s + p * cols + col)));
    }
    out[z * cols + col] = acc;
  }
}

}  // namespace

// spec (gz, cols) and taps (kz, cols) complex64 as float2, out (gz, cols);
// corr 0 = conv, 1 = corr. Returns cudaGetLastError().
extern "C" int shrimpy_zband(const void* spec, const void* taps, void* out, long long gz,
                             long long kz, long long cols, int corr, void* stream) {
  if (gz < 1 || kz < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  long long nseg = (kWantThreads + cols - 1) / cols;
  nseg = nseg < 1 ? 1 : (nseg > gz ? gz : nseg);
  if (nseg > 65535) nseg = 65535;
  const long long seg_len = (gz + nseg - 1) / nseg;
  nseg = (gz + seg_len - 1) / seg_len;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads), (unsigned)nseg);
  const float2* s = static_cast<const float2*>(spec);
  const float2* h = static_cast<const float2*>(taps);
  float2* o = static_cast<float2*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kz) {
#define SHRIMPY_ZBAND_CASE(K) \
  case K:                     \
    zband_reg_kernel<K><<<grid, kThreads, 0, st>>>(s, h, o, gz, cols, seg_len, corr); \
    break;
    SHRIMPY_ZBAND_CASE(1)
    SHRIMPY_ZBAND_CASE(3)
    SHRIMPY_ZBAND_CASE(5)
    SHRIMPY_ZBAND_CASE(7)
    SHRIMPY_ZBAND_CASE(9)
    SHRIMPY_ZBAND_CASE(11)
    SHRIMPY_ZBAND_CASE(13)
    SHRIMPY_ZBAND_CASE(15)
    SHRIMPY_ZBAND_CASE(17)
    SHRIMPY_ZBAND_CASE(19)
    SHRIMPY_ZBAND_CASE(21)
    SHRIMPY_ZBAND_CASE(23)
    SHRIMPY_ZBAND_CASE(25)
    SHRIMPY_ZBAND_CASE(27)
    SHRIMPY_ZBAND_CASE(29)
    SHRIMPY_ZBAND_CASE(31)
#undef SHRIMPY_ZBAND_CASE
    default:
      zband_any_kernel<<<grid, kThreads, 0, st>>>(s, h, o, gz, kz, cols, seg_len, corr);
  }
  return (int)cudaGetLastError();
}
