// One Richardson-Lucy half-step: zero-boundary separable 3-D convolution
// over T rank-1 terms plus the RL epilogue.
//
// Replaces the TPU kernel shrimpy_tpu/ops/rl_fused.py::_rl_fused_pass in
// modes "ratio", "mult" and "plain" (callers conv3_fused and rl_fused).
// Semantics (oracle: richardson_lucy_reference_separable(boundary="zero")):
//
//   conv(v) = sum_t X_t Y_t Z_t v,   (A v)[n] = sum_i k[i] * v[n + r - i]
//
// with zero outside the G grid (the reflect-padded image). The adjoint
// pass is the same operator with every tap list reversed (host side).
//   ratio: out = aux / max(conv(in), eps)   (aux = data)
//   mult:  out = aux * conv(in)             (aux = est, may alias out)
//   plain: out = conv(in)
//
// Two kernels, launched by ops/rl_fused.py::half_step_cuda per term as
// z pass -> y pass -> x pass:
//   * conv_axis: a 1-D convolution along the middle axis of an
//     (outer, n, inner) view (z: (1, gz, gy*gx), y: (gz, gy, gx)).
//     Threads run along the contiguous inner axis, so every load
//     coalesces; each thread stages its own column of kTileN outputs plus
//     the 2r halo in shared memory (no block-level exchange, so no
//     barrier) and reads each input value once per tile.
//   * conv_x: the x pass on contiguous rows, one block per (z, y) row:
//     the whole row plus halo is staged in shared memory, then each
//     thread produces outputs, adds the partial sum of earlier terms
//     (prev) and applies the epilogue in the same launch.
// All arithmetic is float32 FMA (no TF32, no tensor cores). The TPU
// layout machinery (y<->x swap, staggered est offset, 128-lane rounding,
// bf16 hi/lo split) is not ported: these kernels work on the exact G
// grid and mask their own ragged edges.
//
// Bound on the card: memory. Per term the three passes move ~7 carry
// volumes (z: read+write, y: read+write, x: read+aux+write); at the
// production carry (136, 2908, 1620) f32 = 2.56 GB that is ~18 GB and
// ~5.4 ms per half-step at 3.35 TB/s, against 9 + 21 + 21 = 51 FMAs per
// voxel (65 GFLOP per half-step, ~1 ms at 67 TFLOP/s fp32).
// Fusing the passes (z+y in one launch, a ring of planes in shared
// memory, TMA) is the lever for a later change.

#include <cuda_runtime.h>

namespace {

// Tile constants chosen by a sweep at the production carry on an H100
// SXM 80 GB at 700 W (PERF.md): a 32-output column with its loads
// unrolled 8-deep keeps more loads in flight per SM than a 64-output
// column (z pass 5.5 -> 2.7 ms, y pass 7.5 -> 4.3 ms); 128 threads per
// x row beat 256.
constexpr int kThreadsInner = 128;  // threads along the contiguous axis
constexpr int kTileN = 32;          // outputs per thread along the conv axis
constexpr int kThreadsRow = 128;    // threads per x row

__global__ void conv_axis_kernel(const float* __restrict__ in,
                                 float* __restrict__ out,
                                 const float* __restrict__ taps, int k,
                                 long long n, long long inner) {
  extern __shared__ float col[];  // [(kTileN + 2r) * kThreadsInner]
  const int r = k / 2;
  const long long i = (long long)blockIdx.x * kThreadsInner + threadIdx.x;
  if (i >= inner) return;  // no barrier below: each thread owns its column
  const long long n0 = (long long)blockIdx.y * kTileN;
  const long long plane = (long long)blockIdx.z * n * inner;
  const float* src = in + plane + i;
  float* dst = out + plane + i;
  const int span = kTileN + 2 * r;
#pragma unroll 8
  for (int j = 0; j < span; ++j) {
    const long long m = n0 - r + j;
    col[j * kThreadsInner + threadIdx.x] =
        (m >= 0 && m < n) ? src[m * inner] : 0.f;
  }
  const int count = (int)min((long long)kTileN, n - n0);
  for (int o = 0; o < count; ++o) {
    // out[n0 + o] = sum_t k[t] * in[n0 + o + r - t]; in[m] sits at
    // column row m - n0 + r, i.e. o + 2r - t.
    float acc = 0.f;
    const float* c = col + (o + 2 * r) * kThreadsInner + threadIdx.x;
    for (int t = 0; t < k; ++t) {
      acc = fmaf(taps[t], c[-t * kThreadsInner], acc);
    }
    dst[(n0 + o) * inner] = acc;
  }
}

// prev, aux and out may alias each other (in-place mult pass): no
// __restrict__ on them. Each element is read and written by one thread.
__global__ void conv_x_kernel(const float* __restrict__ in, const float* prev,
                              const float* aux, float* out,
                              const float* __restrict__ taps, int k,
                              long long n, int mode, float eps) {
  extern __shared__ float row[];  // [n + 2r]
  const int r = k / 2;
  const long long base = (long long)blockIdx.x * n;
  for (long long j = threadIdx.x; j < n + 2 * r; j += kThreadsRow) {
    const long long m = j - r;
    row[j] = (m >= 0 && m < n) ? in[base + m] : 0.f;
  }
  __syncthreads();
  for (long long x = threadIdx.x; x < n; x += kThreadsRow) {
    float acc = 0.f;
    const float* c = row + x + 2 * r;
    for (int t = 0; t < k; ++t) {
      acc = fmaf(taps[t], c[-t], acc);
    }
    if (prev != nullptr) acc += prev[base + x];
    float v = acc;
    if (mode == 1) {
      v = aux[base + x] / fmaxf(acc, eps);
    } else if (mode == 2) {
      v = aux[base + x] * acc;
    }
    out[base + x] = v;
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int shrimpy_conv_axis(const void* in, void* out, const void* taps,
                                 int k, long long outer, long long n,
                                 long long inner, void* stream) {
  const size_t smem = (size_t)(kTileN + 2 * (k / 2)) * kThreadsInner * sizeof(float);
  int err = set_smem((const void*)conv_axis_kernel, smem);
  if (err != 0) return err;
  dim3 grid((unsigned)((inner + kThreadsInner - 1) / kThreadsInner),
            (unsigned)((n + kTileN - 1) / kTileN), (unsigned)outer);
  conv_axis_kernel<<<grid, kThreadsInner, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (const float*)taps, k, n, inner);
  return (int)cudaGetLastError();
}

extern "C" int shrimpy_conv_x(const void* in, const void* prev, const void* aux,
                              void* out, const void* taps, int k,
                              long long rows, long long n, int mode, float eps,
                              void* stream) {
  const size_t smem = (size_t)(n + 2 * (k / 2)) * sizeof(float);
  int err = set_smem((const void*)conv_x_kernel, smem);
  if (err != 0) return err;
  conv_x_kernel<<<(unsigned)rows, kThreadsRow, smem, (cudaStream_t)stream>>>(
      (const float*)in, (const float*)prev, (const float*)aux, (float*)out,
      (const float*)taps, k, n, mode, eps);
  return (int)cudaGetLastError();
}
