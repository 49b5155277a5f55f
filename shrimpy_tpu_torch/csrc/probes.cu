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
//     accumulation, the "manual 3-pass HIGH building block") ->
//     probe_split_dot: the same product on the tensor cores through
//     wgmma.mma_async (wgmma.cuh), as bf16x3 hi/lo, one-pass bf16, one-pass
//     TF32 and 3xTF32, beside a float32 FMA product on the CUDA cores.
// Each probe's plain version is in kernels/probes.py.
//
// Bounds. The slice and the shared-memory block are one launch each of a
// few blocks, so the launch itself is their floor (empty_kernel, launched
// with the same shape, measures it); the block of probe_smem is bound by
// one SM's shared memory, 128 bytes a clock. Each product mode is one
// launch, latency-bound at the probe's (128, 160) @ (160, 512): a block owns
// a 64 x 32 tile of C (32 blocks; 64 x 128 tiles, 8 blocks, took twice as
// long), TMA copies float32 k-chunks of A and B into a ring of two, two
// warpgroups split each chunk in shared memory into the pieces the tensor
// cores take (bf16 hi/lo, TF32 big/small; what the TPU kernel does in its
// body) while the third runs the passes of the chunk before on wgmma. The
// split, not the products, sets the pace. The fma mode stays on the CUDA
// cores: 16 x 16 tiles (256 blocks), a thread a row of 4 outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

constexpr unsigned kPattern = 2654435761u;
constexpr int kSliceWidth = 128;   // floats a slice: 32 float4 pieces
constexpr int kSliceThreads = 128;  // 4 rows of 32 pieces a pass
constexpr int kTouchThreads = 1024;

// A launch that does nothing: the floor of a launch of its shape.
__global__ void empty_kernel() {}

// x is (rows, cols4) float4; block i stages all of it in dynamic shared
// memory, then reads the 128-column slice j = max(i - 1, 0) at a run-time
// offset and writes twice it into columns [128 i, 128 (i + 1)). Thread t
// walks piece t % 32 of rows t / 32, t / 32 + 4, ...
__global__ void __launch_bounds__(kSliceThreads)
    smem_slice_kernel(const float4* __restrict__ x, float4* __restrict__ out, int rows,
                      int cols4) {
  extern __shared__ float4 buf[];
  for (int i = threadIdx.x; i < rows * cols4; i += kSliceThreads) buf[i] = x[i];
  __syncthreads();
  constexpr int kPieces = kSliceWidth / 4;
  const int from = (blockIdx.x > 0 ? blockIdx.x - 1 : 0) * kPieces + (threadIdx.x % kPieces);
  const int to = blockIdx.x * kPieces + (threadIdx.x % kPieces);
  for (int r = threadIdx.x / kPieces; r < rows; r += kSliceThreads / kPieces) {
    float4 v = buf[r * cols4 + from];
    v.x *= 2.f;
    v.y *= 2.f;
    v.z *= 2.f;
    v.w *= 2.f;
    out[r * cols4 + to] = v;
  }
}

// Touch `words` (>= 64) 32-bit words of dynamic shared memory with a
// pattern, read them back: out[0] = the words that read back right, out[1] =
// the sum of the pattern modulo 2^32. The per-warp sums are gathered in the
// first 64 words once every word has been read (no static shared memory,
// which would count against the block's limit).
__global__ void __launch_bounds__(kTouchThreads) smem_touch_kernel(unsigned* __restrict__ out,
                                                                   int words) {
  extern __shared__ unsigned cells[];
  for (int i = threadIdx.x; i < words; i += kTouchThreads) cells[i] = (unsigned)i * kPattern;
  __syncthreads();
  const int half = words / 2;
  unsigned g = 0u, s = 0u;
  for (int i = threadIdx.x; i < words; i += kTouchThreads) {
    // Another thread's word: the one `half` further on, wrapped.
    int j = i + half;
    if (j >= words) j -= words;
    const unsigned v = cells[j];
    g += v == (unsigned)j * kPattern;
    s += v;
  }
  g = __reduce_add_sync(0xffffffffu, g);
  s = __reduce_add_sync(0xffffffffu, s);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    cells[warp] = g;
    cells[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    g = __reduce_add_sync(0xffffffffu, cells[lane]);
    s = __reduce_add_sync(0xffffffffu, cells[32 + lane]);
    if (lane == 0) {
      out[0] = g;
      out[1] = s;
    }
  }
}

// The split products. Block tile kDotM x kDotN of C, k-chunks of kDotK.
// Warpgroup 0 issues the products; the other threads split (thread
// kIssuer also issues the copies).
constexpr int kDotM = 64, kDotN = 32, kDotK = 64, kDotThreads = 384;
constexpr int kSplitThreads = kDotThreads - 128, kIssuer = 128;
constexpr int kStageFloats = kDotM * kDotK + kDotK * kDotN;  // A then B, row-major
static_assert(kDotK % 64 == 0, "a k-chunk fills whole 128-byte rows of bf16 pieces");

// mode 0: bf16x3 hi/lo, 1: one-pass TF32, 2: 3xTF32, 3: one-pass bf16.
__host__ __device__ constexpr int piece_bytes(int mode) { return mode == 1 || mode == 2 ? 4 : 2; }
__host__ __device__ constexpr bool three_pass(int mode) { return mode == 0 || mode == 2; }
// Bytes of a set of pieces (A big, A small, B big, B small).
__host__ __device__ constexpr int piece_set_bytes(int mode) {
  return 2 * (kDotM + kDotN) * kDotK * piece_bytes(mode);
}
// Two sets of pieces, two float32 stages, their two mbarriers, and 1024
// bytes to align the pieces to the swizzle's 1024-byte groups.
__host__ __device__ constexpr int dot_smem_bytes(int mode) {
  return 2 * piece_set_bytes(mode) + 2 * kStageFloats * 4 + 16 + 1024;
}

__device__ __forceinline__ float tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

// The big and small pieces of four consecutive k values of one row, stored
// at byte `off` of the big and the small tile.
template <int MODE>
__device__ __forceinline__ void store_pieces(unsigned char* big, unsigned char* small,
                                             unsigned off, float v0, float v1, float v2,
                                             float v3) {
  if constexpr (piece_bytes(MODE) == 4) {
    const float4 b = make_float4(tf32_round(v0), tf32_round(v1), tf32_round(v2), tf32_round(v3));
    *reinterpret_cast<float4*>(big + off) = b;
    if constexpr (three_pass(MODE))
      *reinterpret_cast<float4*>(small + off) = make_float4(
          tf32_round(v0 - b.x), tf32_round(v1 - b.y), tf32_round(v2 - b.z), tf32_round(v3 - b.w));
  } else {
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v0, v1), h23 = __floats2bfloat162_rn(v2, v3);
    *reinterpret_cast<uint2*>(big + off) =
        make_uint2(*reinterpret_cast<const unsigned*>(&h01), *reinterpret_cast<const unsigned*>(&h23));
    if constexpr (three_pass(MODE)) {
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(v0 - f01.x, v1 - f01.y),
                           l23 = __floats2bfloat162_rn(v2 - f23.x, v3 - f23.y);
      *reinterpret_cast<uint2*>(small + off) = make_uint2(
          *reinterpret_cast<const unsigned*>(&l01), *reinterpret_cast<const unsigned*>(&l23));
    }
  }
}

template <int MODE>
__device__ __forceinline__ void mma(float (&d)[kDotN / 2], unsigned a, unsigned b) {
  if constexpr (piece_bytes(MODE) == 4)
    wgmma_tf32<kDotN>(d, sw128_desc(a), sw128_desc(b));
  else
    wgmma_bf16<kDotN>(d, sw128_desc(a), sw128_desc(b));
}

// C = A B, A (m, k) and B (k, n) row-major float32 (read through the TMA
// maps a_map and b_map); m a multiple of 64, n of 8, k of 8 (the copies
// zero-fill a chunk's tail and B's columns past n). Chunk j is copied into
// stage j % 2 and split into piece set j % 2 while warpgroup 0 runs the
// products of chunk j - 1 on the other set. The passes of the three-pass
// modes run in the order small A x big B, big A x small B, big A x big B at
// each product's depth.
template <int MODE>
__global__ void __launch_bounds__(kDotThreads)
    dot_split_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, float* __restrict__ c, int m,
                     int n, int k) {
  constexpr int E = piece_bytes(MODE);
  constexpr int kA = kDotM * kDotK * E, kB = kDotN * kDotK * E;  // bytes of a piece tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const pieces = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* const stages = reinterpret_cast<float*>(pieces + 2 * piece_set_bytes(MODE));
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(stages + 2 * kStageFloats);
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kDotM, n0 = blockIdx.x * kDotN;
  const int chunks = (k + kDotK - 1) / kDotK;

  auto issue = [&](int ch) {
    float* const sa = stages + (ch & 1) * kStageFloats;
    mbar_expect(full + (ch & 1), 4u * kStageFloats);
    tma_load_3d(sa, &a_map, ch * kDotK, m0, 0, full + (ch & 1));
    tma_load_3d(sa + kDotM * kDotK, &b_map, n0, ch * kDotK, 0, full + (ch & 1));
  };
  // The pieces of chunk ch: A row by row (K-major as it lies), B transposed.
  auto split = [&](int ch) {
    const int s = t - (kDotThreads - kSplitThreads);
    mbar_wait(full + (ch & 1), (unsigned)(ch >> 1) & 1u);
    const float* const sa = stages + (ch & 1) * kStageFloats;
    const float* const sb = sa + kDotM * kDotK;
    unsigned char* const a_big = pieces + (ch & 1) * piece_set_bytes(MODE);
    unsigned char* const a_small = a_big + kA;
    unsigned char* const b_big = a_small + kA;
    unsigned char* const b_small = b_big + kB;
#pragma unroll
    for (int i = s; i < kDotM * kDotK / 4; i += kSplitThreads) {
      const int r = i / (kDotK / 4), kk = 4 * (i % (kDotK / 4));
      const float4 v = reinterpret_cast<const float4*>(sa)[i];
      store_pieces<MODE>(a_big, a_small, sw128_offset<E>(r, kk, kDotM), v.x, v.y, v.z, v.w);
    }
#pragma unroll
    for (int i = s; i < kDotN * kDotK / 4; i += kSplitThreads) {
      const int nn = i % kDotN, kk = 4 * (i / kDotN);
      const float* const col = sb + kk * kDotN + nn;
      store_pieces<MODE>(b_big, b_small, sw128_offset<E>(nn, kk, kDotN), col[0], col[kDotN],
                         col[2 * kDotN], col[3 * kDotN]);
    }
    fence_async_smem();  // the pieces, written by threads, before the products read them
  };

  if (t == kIssuer) {
    mbar_init(full, 1);
    mbar_init(full + 1, 1);
  }
  __syncthreads();
  if (t == kIssuer) {
    issue(0);
    if (chunks > 1) issue(1);
  }
  if (t >= kDotThreads - kSplitThreads) split(0);
  __syncthreads();
  if (t == kIssuer && chunks > 2) issue(2);

  float d[kDotN / 2];
#pragma unroll
  for (int i = 0; i < kDotN / 2; ++i) d[i] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    if (t < 128) {
      // Products of depth 32 bytes; those past k read zeros.
      const int steps = ((k - ch * kDotK < kDotK ? k - ch * kDotK : kDotK) * E + 31) / 32;
      const unsigned ab = smem_u32(pieces + (ch & 1) * piece_set_bytes(MODE));
      const unsigned as = ab + kA, bb = ab + 2 * kA, bs = bb + kB;
      wgmma_fence_operands(d);
      wgmma_fence();
      for (int s = 0; s < steps; ++s) {
        const unsigned oa = (s / 4) * kDotM * 128 + (s % 4) * 32;
        const unsigned ob = (s / 4) * kDotN * 128 + (s % 4) * 32;
        if constexpr (three_pass(MODE)) {
          mma<MODE>(d, as + oa, bb + ob);
          mma<MODE>(d, ab + oa, bs + ob);
        }
        mma<MODE>(d, ab + oa, bb + ob);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(d);
    } else if (ch + 1 < chunks) {
      split(ch + 1);
    }
    __syncthreads();  // set ch % 2 and stage (ch + 1) % 2 are free
    if (t == kIssuer && ch + 3 < chunks) issue(ch + 3);
  }
  if (t < 128) {
    const int w = t / 32, l = t % 32;
    const size_t row = m0 + 16 * w + l / 4;
#pragma unroll
    for (int j = 0; j < kDotN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (l % 4);
      if (col < n) {
        *reinterpret_cast<float2*>(c + row * n + col) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(c + (row + 8) * n + col) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// The float32 yardstick on the CUDA cores: a block owns a kFmaM x kFmaN tile
// of C, k-chunks of kFmaK of A and B go through a ring of two in shared
// memory (cp.async), and thread (ty, tx) holds columns 4 tx .. 4 tx + 3 of
// rows ty + kFmaStep i in registers. Every output is one chain of FMAs in k
// order from 0, as a thread per output took it before.
constexpr int kFmaM = 16, kFmaN = 16, kFmaK = 64, kFmaThreads = 64, kFmaPitch = kFmaK + 4;
constexpr int kFmaStep = kFmaThreads / (kFmaN / 4), kFmaRows = kFmaM / kFmaStep;

__global__ void __launch_bounds__(kFmaThreads)
    dot_fma_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                   int m, int n, int k) {
  __shared__ __align__(16) float sa[2][kFmaM * kFmaPitch];
  __shared__ __align__(16) float sb[2][kFmaK * kFmaN];
  const int t = threadIdx.x, tx = t % (kFmaN / 4), ty = t / (kFmaN / 4);
  const int m0 = blockIdx.y * kFmaM, n0 = blockIdx.x * kFmaN;
  const int chunks = (k + kFmaK - 1) / kFmaK;

  auto load = [&](int ch) {
    const int k0 = ch * kFmaK;
#pragma unroll
    for (int i = t; i < kFmaM * kFmaK / 4; i += kFmaThreads) {
      const int r = i / (kFmaK / 4), kk = k0 + 4 * (i % (kFmaK / 4));
      const bool ok = kk < k;
      copy16z(&sa[ch & 1][r * kFmaPitch + kk - k0], ok ? a + (size_t)(m0 + r) * k + kk : a, ok);
    }
#pragma unroll
    for (int i = t; i < kFmaK * kFmaN / 4; i += kFmaThreads) {
      const int kk = k0 + i / (kFmaN / 4), nn = n0 + 4 * (i % (kFmaN / 4));
      const bool ok = kk < k && nn < n;
      copy16z(&sb[ch & 1][4 * i], ok ? b + (size_t)kk * n + nn : b, ok);
    }
    copies_commit();
  };

  float acc[kFmaRows][4] = {};
  load(0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load(ch + 1);
      copies_wait_but<1>();
    } else {
      copies_wait();
    }
    __syncthreads();
    const float* const xa = sa[ch & 1];
    const float* const xb = sb[ch & 1];
    const int kc = k - ch * kFmaK < kFmaK ? k - ch * kFmaK : kFmaK;
    for (int kk = 0; kk < kc; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(xb + kk * kFmaN + 4 * tx);
#pragma unroll
      for (int i = 0; i < kFmaRows; ++i) {
        const float av = xa[(ty + kFmaStep * i) * kFmaPitch + kk];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
    __syncthreads();  // the next load refills this stage
  }
  const int col = n0 + 4 * tx;
  if (col < n) {
#pragma unroll
    for (int i = 0; i < kFmaRows; ++i)
      *reinterpret_cast<float4*>(c + (size_t)(m0 + ty + kFmaStep * i) * n + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int MODE>
int launch_split(const float* a, const float* b, float* c, int m, int n, int k, cudaStream_t s) {
  CUtensorMap a_map, b_map;
  int err = box_map(&a_map, a, 1, m, k, 1, kDotM, kDotK);
  if (err == 0) err = box_map(&b_map, b, 1, k, n, 1, kDotK, kDotN);
  if (err != 0) return err;
  const int smem = dot_smem_bytes(MODE);
  err = (int)cudaFuncSetAttribute((const void*)dot_split_kernel<MODE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dot_split_kernel<MODE><<<dim3((n + kDotN - 1) / kDotN, m / kDotM), kDotThreads, smem, s>>>(
      a_map, b_map, c, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out (rows, cols) float32, 16-byte aligned; width must be 128.
extern "C" int shrimpy_probe_smem_slice(const void* x, void* out, int rows, int cols, int width,
                                        void* stream) {
  if (width != kSliceWidth || cols % kSliceWidth != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * cols * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute((const void*)smem_slice_kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err != 0) return err;
  }
  smem_slice_kernel<<<cols / kSliceWidth, kSliceThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, rows, cols / 4);
  return (int)cudaGetLastError();
}

// Returns the CUDA error of the opt-in or the launch (0: the block ran
// with `bytes` of dynamic shared memory and will write out[0..1]). A
// refusal is the answer the probe is after, so the error is cleared for
// the next call.
extern "C" int shrimpy_probe_smem(void* out, int bytes, void* stream) {
  if (bytes < 64 * 4) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute((const void*)smem_touch_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) {
    smem_touch_kernel<<<1, kTouchThreads, (size_t)bytes, (cudaStream_t)stream>>>(
        (unsigned*)out, bytes / 4);
    err = (int)cudaGetLastError();
  } else {
    (void)cudaGetLastError();
  }
  return err;
}

// mode 0: bf16x3 hi/lo, 1: one-pass TF32, 2: 3xTF32, 3: one-pass bf16
// (wgmma), 4: float32 FMA. One launch. m a multiple of 64, n of 8, k of 8.
extern "C" int shrimpy_probe_split_dot(const void* a, const void* b, void* c, int m, int n, int k,
                                       int mode, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % 64 || n % 8 || k % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fa = (const float*)a, *fb = (const float*)b;
  float* fc = (float*)c;
  switch (mode) {
    case 0: return launch_split<0>(fa, fb, fc, m, n, k, s);
    case 1: return launch_split<1>(fa, fb, fc, m, n, k, s);
    case 2: return launch_split<2>(fa, fb, fc, m, n, k, s);
    case 3: return launch_split<3>(fa, fb, fc, m, n, k, s);
    case 4:
      dot_fma_kernel<<<dim3((n + kFmaN - 1) / kFmaN, m / kFmaM), kFmaThreads, 0, s>>>(fa, fb, fc,
                                                                                   m, n, k);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch shape of a mode at (m, n): blocks, threads a block and bytes
// of dynamic shared memory, into shape[0..2] (0, or an error for a mode
// that does not exist).
extern "C" int shrimpy_probe_split_dot_launch(int m, int n, int mode, int* shape) {
  if (mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  const int tile_m = mode == 4 ? kFmaM : kDotM, tile_n = mode == 4 ? kFmaN : kDotN;
  shape[0] = (n + tile_n - 1) / tile_n * (m / tile_m);
  shape[1] = mode == 4 ? kFmaThreads : kDotThreads;
  shape[2] = mode == 4 ? 0 : dot_smem_bytes(mode);
  return 0;
}

// The launch floor: `blocks` blocks of `threads` threads with `bytes` of
// dynamic shared memory, running nothing.
extern "C" int shrimpy_probe_empty(int blocks, int threads, int bytes, void* stream) {
  const int err = (int)cudaFuncSetAttribute((const void*)empty_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != 0) return err;
  empty_kernel<<<blocks, threads, (size_t)bytes, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
