// Three on-chip probes: what a kernel design for this card may rely on.
//
// Replace the three TPU probes of scripts/probe_mosaic.py:
//   * probe_dynamic_lane_slice (a dynamic 128-aligned slice of an on-chip
//     buffer) -> probe_smem_slice: a slice of dynamic shared memory at an
//     offset computed at run time;
//   * probe_vmem (how much on-chip scratch one kernel may hold) ->
//     probe_smem: the largest opt-in dynamic shared memory a block can
//     launch with, every word touched and read back;
//   * probe_bf16_dot (error of the 3-pass bf16 hi/lo product with float32
//     accumulation) -> probe_split_dot: the same product on the tensor
//     cores through nvcuda::wmma, as bf16x3 hi/lo, one-pass bf16, one-pass
//     TF32 and 3xTF32, beside a float32 FMA product.
// Each probe's plain version is in kernels/probes.py. Launches and
// arithmetic are tiny: these measure what the hardware accepts and how it
// rounds, not speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

// x is (rows, cols) float32; block i stages all of it in dynamic shared
// memory, then reads the `width`-column slice j = max(i - 1, 0) at a
// run-time offset and writes twice it into columns [i*width, (i+1)*width).
__global__ void smem_slice_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int rows, int cols, int width) {
  extern __shared__ float buf[];
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) buf[i] = x[i];
  __syncthreads();
  const int i = blockIdx.x;
  const int start = (i > 0 ? i - 1 : 0) * width;
  for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
    const int r = e / width, c = e % width;
    out[r * cols + i * width + c] = 2.f * buf[r * cols + start + c];
  }
}

// Touch `words` 32-bit words of dynamic shared memory with a pattern, read
// them back: out[0] += words that read back right, out[1] += the sum of
// the pattern modulo 2^32 (the wrapper zeroes out; no static shared
// memory here, which would count against the block's limit).
__global__ void smem_touch_kernel(unsigned* __restrict__ out, int words) {
  extern __shared__ unsigned cells[];
  for (int i = threadIdx.x; i < words; i += blockDim.x) cells[i] = (unsigned)i * 2654435761u;
  __syncthreads();
  unsigned g = 0u, s = 0u;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    // Another thread's word: the one `words / 2` further on, wrapped.
    const int j = (i + words / 2) % words;
    const unsigned v = cells[j];
    g += v == (unsigned)j * 2654435761u;
    s += v;
  }
  atomicAdd(&out[0], g);
  atomicAdd(&out[1], s);
}

// hi = bf16(v), lo = bf16(v - hi): the two pieces of a float32 value.
__global__ void split_bf16_kernel(const float* __restrict__ v, __nv_bfloat16* __restrict__ hi,
                                  __nv_bfloat16* __restrict__ lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const __nv_bfloat16 h = __float2bfloat16_rn(v[i]);
  hi[i] = h;
  lo[i] = __float2bfloat16_rn(v[i] - __bfloat162float(h));
}

// One warp per 16 x 16 tile of C = A B, A (m, k) and B (k, n) row-major
// bf16 pieces. three: a_hi b_hi + a_lo b_hi + a_hi b_lo, the small products
// first; else a_hi b_hi alone. Float32 accumulation in the fragment.
__global__ void dot_bf16_kernel(const __nv_bfloat16* __restrict__ a_hi,
                                const __nv_bfloat16* __restrict__ a_lo,
                                const __nv_bfloat16* __restrict__ b_hi,
                                const __nv_bfloat16* __restrict__ b_lo, float* __restrict__ c,
                                int n, int k, int three) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ah, al;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bh, bl;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  const int row = blockIdx.y * 16, col = blockIdx.x * 16;
  for (int kk = 0; kk < k; kk += 16) {
    wmma::load_matrix_sync(ah, a_hi + row * k + kk, k);
    wmma::load_matrix_sync(bh, b_hi + kk * n + col, n);
    if (three) {
      wmma::load_matrix_sync(al, a_lo + row * k + kk, k);
      wmma::load_matrix_sync(bl, b_lo + kk * n + col, n);
      wmma::mma_sync(acc, al, bh, acc);
      wmma::mma_sync(acc, ah, bl, acc);
    }
    wmma::mma_sync(acc, ah, bh, acc);
  }
  wmma::store_matrix_sync(c + row * n + col, acc, n, wmma::mem_row_major);
}

// The same product from float32 operands in TF32: each fragment element is
// rounded to TF32 (big), and with `three` its remainder too (small):
// small_a big_b + big_a small_b + big_a big_b.
__global__ void dot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ c, int n, int k, int three) {
  wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> ab, a_small;
  wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> bb, b_small;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc;
  wmma::fill_fragment(acc, 0.f);
  const int row = blockIdx.y * 16, col = blockIdx.x * 16;
  for (int kk = 0; kk < k; kk += 8) {
    wmma::load_matrix_sync(ab, a + row * k + kk, k);
    wmma::load_matrix_sync(bb, b + kk * n + col, n);
    for (int i = 0; i < ab.num_elements; ++i) {
      const float v = ab.x[i];
      ab.x[i] = wmma::__float_to_tf32(v);
      a_small.x[i] = wmma::__float_to_tf32(v - ab.x[i]);
    }
    for (int i = 0; i < bb.num_elements; ++i) {
      const float v = bb.x[i];
      bb.x[i] = wmma::__float_to_tf32(v);
      b_small.x[i] = wmma::__float_to_tf32(v - bb.x[i]);
    }
    if (three) {
      wmma::mma_sync(acc, a_small, bb, acc);
      wmma::mma_sync(acc, ab, b_small, acc);
    }
    wmma::mma_sync(acc, ab, bb, acc);
  }
  wmma::store_matrix_sync(c + row * n + col, acc, n, wmma::mem_row_major);
}

// The float32 yardstick: one thread per element, FMAs in k order.
__global__ void dot_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                               float* __restrict__ c, int m, int n, int k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x, row = blockIdx.y;
  if (col >= n || row >= m) return;
  float acc = 0.f;
  for (int i = 0; i < k; ++i) acc = fmaf(a[row * k + i], b[i * n + col], acc);
  c[row * n + col] = acc;
}

}  // namespace

extern "C" int shrimpy_probe_smem_slice(const void* x, void* out, int rows, int cols, int width,
                                        void* stream) {
  const size_t smem = (size_t)rows * cols * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute((const void*)smem_slice_kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err != 0) return err;
  }
  smem_slice_kernel<<<cols / width, 128, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, rows, cols, width);
  return (int)cudaGetLastError();
}

// Returns the CUDA error of the opt-in or the launch (0: the block ran
// with `bytes` of dynamic shared memory). A refusal is the answer the
// probe is after, so the error is cleared for the next call.
extern "C" int shrimpy_probe_smem(void* out, int bytes, void* stream) {
  int err = (int)cudaFuncSetAttribute((const void*)smem_touch_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) {
    smem_touch_kernel<<<1, 256, (size_t)bytes, (cudaStream_t)stream>>>((unsigned*)out,
                                                                       bytes / 4);
    err = (int)cudaGetLastError();
  } else {
    (void)cudaGetLastError();
  }
  return err;
}

// mode 0: bf16x3 hi/lo, 1: one-pass TF32, 2: 3xTF32, 3: one-pass bf16,
// 4: float32 FMA. m and n multiples of 16, k of 16; the four scratch
// arrays hold the bf16 pieces of a (m*k) and b (k*n).
extern "C" int shrimpy_probe_split_dot(const void* a, const void* b, void* a_hi, void* a_lo,
                                       void* b_hi, void* b_lo, void* c, int m, int n, int k,
                                       int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 tiles(n / 16, m / 16);
  if (mode == 0 || mode == 3) {
    split_bf16_kernel<<<(m * k + 255) / 256, 256, 0, s>>>(
        (const float*)a, (__nv_bfloat16*)a_hi, (__nv_bfloat16*)a_lo, m * k);
    split_bf16_kernel<<<(k * n + 255) / 256, 256, 0, s>>>(
        (const float*)b, (__nv_bfloat16*)b_hi, (__nv_bfloat16*)b_lo, k * n);
    dot_bf16_kernel<<<tiles, 32, 0, s>>>(
        (const __nv_bfloat16*)a_hi, (const __nv_bfloat16*)a_lo, (const __nv_bfloat16*)b_hi,
        (const __nv_bfloat16*)b_lo, (float*)c, n, k, mode == 0);
  } else if (mode == 1 || mode == 2) {
    dot_tf32_kernel<<<tiles, 32, 0, s>>>((const float*)a, (const float*)b, (float*)c, n, k,
                                         mode == 2);
  } else {
    dot_fma_kernel<<<dim3((n + 127) / 128, m), 128, 0, s>>>((const float*)a, (const float*)b,
                                                            (float*)c, m, n, k);
  }
  return (int)cudaGetLastError();
}
