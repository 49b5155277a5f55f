// The three-pass route's passes compiled for their tap count: a 1-D
// convolution along the middle axis (z and y passes) and along the
// contiguous x rows (x pass, with the partial sum of earlier terms and the
// RL epilogue), built once for every tap count that is run
// (RL_PASS_NK, kernels/build.py::build_geometries, kind "rl_pass").
//
// Replaces, for tap lists of at most kMaxTaps, csrc/rl_fused.cu's
// conv_axis_kernel and conv_x_kernel / conv_x_accel_kernel: the z, y and x
// passes of ops/rl_fused.py::half_step_three_pass (the TPU kernel
// shrimpy_tpu/ops/rl_fused.py::_rl_fused_pass past rl_half.cu's block:
// BASELINE.md config 2's measured PSF), the two-pass z+y route of
// ops/conv3_cuda.py::convzy_two_pass past the march's block, and the x pass
// of linear_pallas, zy_pallas and conv3_circular past its block. Longer
// tap lists keep rl_fused.cu's runtime-length kernels (ops/rl_fused.py::
// axis_pass_route, x_pass_route choose from the shapes alone).
//
// Semantics, those of the kernels it replaces: out[n] = sum_t k[t] *
// in[n + r - t], each output summed from zero in ascending tap order with
// one fmaf a tap (zeros outside the grid are multiplied in too), so the
// results are the plain PyTorch version's bits (ops/rl_fused.py::
// _conv_axis_plain, _conv_axis_circular_plain, conv3_plain).
//
// What bounds the card here, and what the design does about it. The
// runtime-length kernels issued two loads an FMA (a staged value from
// shared memory and the tap from device memory; the loop could not unroll),
// and an SM serves about a quarter as many loads as FMAs: they ran at ~23 %
// of their byte bound at config 2's grid on an H100 SXM 80 GB at 700 W
// (PERF.md). Here the tap count is a
// compile-time constant and the taps arrive by value in the kernel's
// parameters (the constant bank), so an FFMA takes its tap as an operand
// and no instruction loads it:
//   * axis_pass_kernel: a thread walks one column of the axis (or a tile of
//     it) from its far end with a ring of kNk accumulators in registers,
//     the ring's slot of each tap fixed by a loop unrolled kNk deep. Each
//     input value is loaded once from device memory (all kNk of a step of
//     the ring are issued before its FMAs, for loads in flight) and feeds
//     kNk FFMAs; walking down the axis gives every output its taps in
//     ascending order. No shared memory. Bound: bytes (read + write a
//     carry; FMAs at ~1.1x the taps with the ring's warm-up).
//   * x_pass_kernel: a block stages a piece of a row with its halo in
//     shared memory (as before); each thread then computes 4 consecutive
//     outputs from a window it reads once in 16-byte loads (consecutive
//     threads on consecutive 16 bytes: no bank conflict), so a shared load
//     serves ~kNk FMAs instead of one. prev, aux and the epilogue stay in
//     the launch. Bound: bytes (in, prev, aux read, out written).
//   * x_pass_accel_kernel: the same x loop with the mult_accel epilogue
//     and conv_x_accel_kernel's fixed-order partial sums.
// A launch's grid is taken chunk by chunk past its limits, as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

// The longest tap list compiled here: the axis pass keeps a ring of kNk
// accumulators and the kNk values of a step in registers.
constexpr int kMaxTaps = 63;
constexpr int kAxisThreads = 128;  // threads along the contiguous inner axis
constexpr int kRowThreads = 128;   // threads per x row piece
constexpr int kRowOut = 4;         // consecutive outputs a thread of the x pass computes
constexpr long long kMaxGridX = 2147483647LL, kMaxGridYZ = 65535LL;

// Floats of the x pass's staged piece of len outputs for an nk-tap list:
// element s holds the row at column p0 - round4(r) + s, and the last group
// of 4 outputs reads chunks of 4 up to its window's end.
__host__ __device__ constexpr int x_window_chunks(int nk) {
  return (3 + round4(nk / 2) + nk / 2) / 4 + 1;
}
__host__ __device__ constexpr long long x_staged_floats(int nk, long long len) {
  return 4 * ((len + kRowOut - 1) / kRowOut - 1 + x_window_chunks(nk));
}

}  // namespace

// Bytes of dynamic shared memory a block of the x pass takes for a piece of
// len columns with an nk-tap list (ops/rl_fused.py::x_pass_smem_bytes is the
// same sum); the accelerated pass adds a static 32 bytes.
extern "C" int shrimpy_rl_pass_smem(int nk, long long len) {
  return (int)(x_staged_floats(nk, len) * (long long)sizeof(float));
}

#ifdef RL_PASS_NK
namespace {

constexpr int kNk = RL_PASS_NK;
constexpr int kR = kNk / 2;
constexpr int kP = round4(kR);  // the staged row's lead before column p0
constexpr int kChunks = x_window_chunks(kNk);
// The axis pass loads a ring pass's inputs while the pass before computes.
constexpr bool kPrefetch = true;
static_assert(kNk % 2 == 1 && kNk >= 1 && kNk <= kMaxTaps, "RL_PASS_NK: an odd count to 63");

// The taps, passed by value: they live in the kernel's parameter bank.
struct Taps {
  float k[kNk];
};

// m mod n in [0, n) for any m.
__device__ __forceinline__ long long wrap_at(long long m, long long n) {
  return (m >= 0 && m < n) ? m : ((m % n) + n) % n;
}

// The (outer, n, inner) view: the block takes inner tile blockIdx.x, axis
// tile t0 + blockIdx.y (outputs n0 .. n1 - 1) and outer index z0 +
// blockIdx.z. A thread walks inputs m from n1 - 1 + r down to n0 - r; at the
// step with input m, output o gets tap o + r - m, so output m - r starts
// (tap 0) and output m + r finishes (tap kNk - 1). Output o sits in ring
// slot (m_top - r - o) mod kNk, so at the step j (mod kNk) of a ring pass
// slot s takes tap (j - s) mod kNk, and slot j + 1 finishes: it is stored
// and zeroed, and starts the next output at the next step.
// kAccel: the input is y = max(x + alpha dx, 0) formed on load (zero
// boundary). kWrap: in[m] = in[m mod n] (r >= n wraps more than once).
template <bool kAccel, bool kWrap>
__global__ void __launch_bounds__(kAxisThreads)
    axis_pass_kernel(const float* __restrict__ in, float* __restrict__ out, const Taps taps,
                     long long n, long long inner, long long tile, long long z0, long long t0,
                     const __nv_bfloat16* __restrict__ dx, const float* __restrict__ alpha) {
  const long long i = (long long)blockIdx.x * kAxisThreads + threadIdx.x;
  if (i >= inner) return;
  const long long n0 = (t0 + blockIdx.y) * tile;
  const long long n1 = min(n0 + tile, n);
  const long long plane = (z0 + blockIdx.z) * n * inner;
  const float* src = in + plane + i;
  float* dst = out + plane + i;
  const __nv_bfloat16* dsrc = kAccel ? dx + plane + i : nullptr;
  const float a = kAccel ? *alpha : 0.f;
  const long long m_top = n1 - 1 + kR, m_end = n0 - kR;
  // The inputs the walk loads: zero outside the grid, and past m_end.
  const long long lo = kWrap ? m_end : max(m_end, 0LL);
  const long long hi = kWrap ? m_top + 1 : min(m_top + 1, n);
  // The kNk inputs of the ring pass from m0 down.
  auto load = [&](float (&v)[kNk], long long m0) {
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      const long long m = m0 - j;
      float x = 0.f;
      if (m >= lo && m < hi) {
        if (kWrap) {
          x = src[wrap_at(m, n) * inner];
        } else {
          x = src[m * inner];
          if (kAccel) x = extrapolate(x, dsrc[m * inner], a);
        }
      }
      v[j] = x;
    }
  };
  float acc[kNk], v[kNk];
#pragma unroll
  for (int s = 0; s < kNk; ++s) acc[s] = 0.f;
  load(v, m_top);
  for (long long m0 = m_top; m0 >= m_end; m0 -= kNk) {
    // The next ring pass's loads go out before this one's FMAs.
    float next[kNk];
    if (kPrefetch) load(next, m0 - kNk);
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
#pragma unroll
      for (int s = 0; s < kNk; ++s) acc[s] = fmaf(taps.k[(j - s + kNk) % kNk], v[j], acc[s]);
      const int e = (j + 1) % kNk;
      const long long o = m0 - j + kR;
      if (o >= n0 && o < n1) dst[o * inner] = acc[e];
      acc[e] = 0.f;
    }
    if (kPrefetch) {
#pragma unroll
      for (int j = 0; j < kNk; ++j) v[j] = next[j];
    } else {
      load(v, m0 - kNk);
    }
  }
}

// Stage columns p0 - kP .. of row `base - p0` (row length n) into `row`,
// span floats, zero (or wrapped) outside the row.
template <bool kWrap>
__device__ __forceinline__ void stage_row(float* row, const float* __restrict__ in,
                                          long long base, long long p0, long long n, int span) {
  for (int s = threadIdx.x; s < span; s += kRowThreads) {
    const long long m = p0 - kP + s;
    float v;
    if (kWrap) {
      // 32-bit: a row is shorter than 2^31 (a 64-bit modulo is emulated).
      v = in[base - p0 + wrap_index((int)m, (int)n)];
    } else {
      v = (m >= 0 && m < n) ? in[base - p0 + m] : 0.f;
    }
    row[s] = v;
  }
}

// acc[i] = sum_t k[t] * row(x + r - t) for the 4 outputs x = 4 g + i of
// the staged piece: the window's chunks g .. g + kChunks - 1 walked from the
// top, so each output takes its taps in ascending order. Element s of the
// window is the column x0 - kP + s (x0 = 4 g), so output i takes element
// s with tap i + r + kP - s.
__device__ __forceinline__ void x_window(const float4* row4, int g, const Taps& taps,
                                         float (&acc)[kRowOut]) {
#pragma unroll
  for (int i = 0; i < kRowOut; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = kChunks - 1; c >= 0; --c) {
    const float4 w = row4[g + c];
    const float vals[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 3; e >= 0; --e) {
#pragma unroll
      for (int i = 0; i < kRowOut; ++i) {
        const int t = i + kR + kP - (4 * c + e);
        if (t >= 0 && t < kNk) acc[i] = fmaf(taps.k[t], vals[e], acc[i]);
      }
    }
  }
}

// One output of the x pass: + prev where there are earlier terms, then the
// epilogue (mode 1 ratio: aux / max(acc, eps); 2 mult: aux * acc; 0 plain).
__device__ __forceinline__ float x_out(float acc, bool has_prev, float p, float a, int mode,
                                       float eps) {
  if (has_prev) acc += p;
  if (mode == 1) return a / fmaxf(acc, eps);
  if (mode == 2) return a * acc;
  return acc;
}

// prev, aux and out may alias each other (in-place mult pass, the running
// sum): no __restrict__ on them; each element is read and written by one
// thread. The block takes piece pc0 + blockIdx.y (columns p0 .. p0 + piece)
// of row row0 + blockIdx.x; kPieces false compiles a row that is one piece
// (p0 = 0). vec: prev, aux and out are read and written 16 bytes at a time
// (n % 4 == 0 and 16-byte aligned pointers; a piece is a multiple of 128).
template <bool kWrap, bool kPieces>
__global__ void __launch_bounds__(kRowThreads)
    x_pass_kernel(const float* __restrict__ in, const float* prev, const float* aux, float* out,
                  const Taps taps, long long n, long long piece, long long row0, long long pc0,
                  int mode, float eps, int vec) {
  extern __shared__ float4 row4[];
  const long long p0 = kPieces ? (pc0 + blockIdx.y) * piece : 0;
  const long long base = (row0 + blockIdx.x) * n + p0;  // the piece's first output
  const int len = (int)(kPieces ? min(piece, n - p0) : n);
  const int groups = (len + kRowOut - 1) / kRowOut;
  stage_row<kWrap>(reinterpret_cast<float*>(row4), in, base, p0, n,
                   (int)x_staged_floats(kNk, len));
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += kRowThreads) {
    float acc[kRowOut];
    x_window(row4, g, taps, acc);
    const long long e0 = base + (long long)kRowOut * g;
    const int count = min(kRowOut, len - kRowOut * g);
    const bool has_prev = prev != nullptr;
    if (vec && count == kRowOut) {
      const float4 p4 = has_prev ? *reinterpret_cast<const float4*>(prev + e0) : float4{};
      const float4 a4 = mode != 0 ? *reinterpret_cast<const float4*>(aux + e0) : float4{};
      *reinterpret_cast<float4*>(out + e0) = make_float4(
          x_out(acc[0], has_prev, p4.x, a4.x, mode, eps),
          x_out(acc[1], has_prev, p4.y, a4.y, mode, eps),
          x_out(acc[2], has_prev, p4.z, a4.z, mode, eps),
          x_out(acc[3], has_prev, p4.w, a4.w, mode, eps));
    } else {
      for (int i = 0; i < count; ++i) {
        out[e0 + i] = x_out(acc[i], has_prev, has_prev ? prev[e0 + i] : 0.f,
                            mode != 0 ? aux[e0 + i] : 0.f, mode, eps);
      }
    }
  }
}

// The x pass of mode mult_accel (zero boundary; x, dx and g read and written
// in place, none __restrict__). Block b = (pc0 + blockIdx.y) * rows + row0 +
// blockIdx.x of B = rows * pieces writes partials[b] and partials[B + b]:
// its piece's sums of g*g_prev and g*g over the bf16-rounded g in a fixed
// order (a thread's outputs in order, warp shuffles, the warps in order), so
// the sums do not depend on the order the blocks run in.
__global__ void __launch_bounds__(kRowThreads)
    x_pass_accel_kernel(const float* __restrict__ in, const float* prev, float* x,
                        __nv_bfloat16* dx, __nv_bfloat16* g, const float* __restrict__ alpha,
                        float* __restrict__ partials, const Taps taps, long long rows,
                        long long n, long long piece, long long row0, long long pc0) {
  extern __shared__ float4 row4[];
  __shared__ float red[2][kRowThreads / 32];
  const long long p0 = (pc0 + blockIdx.y) * piece;
  const long long base = (row0 + blockIdx.x) * n + p0;
  const int len = (int)min(piece, n - p0);
  const int groups = (len + kRowOut - 1) / kRowOut;
  stage_row<false>(reinterpret_cast<float*>(row4), in, base, p0, n,
                   (int)x_staged_floats(kNk, len));
  __syncthreads();
  const float a = *alpha;
  float s_num = 0.f, s_den = 0.f;
  for (int q = threadIdx.x; q < groups; q += kRowThreads) {
    float acc[kRowOut];
    x_window(row4, q, taps, acc);
    const long long e0 = base + (long long)kRowOut * q;
    const int count = min(kRowOut, len - kRowOut * q);
    for (int i = 0; i < count; ++i) {
      const long long e = e0 + i;
      float v = acc[i];
      if (prev != nullptr) v += prev[e];
      const float xo = x[e];
      const float y = extrapolate(xo, dx[e], a);
      const float xn = __fmul_rn(y, v);
      const __nv_bfloat16 gb = __float2bfloat16_rn(__fsub_rn(xn, y));
      const float gf = __bfloat162float(gb);
      const float gp = __bfloat162float(g[e]);
      x[e] = xn;
      dx[e] = __float2bfloat16_rn(__fsub_rn(xn, xo));
      g[e] = gb;
      s_num = fmaf(gf, gp, s_num);
      s_den = fmaf(gf, gf, s_den);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    s_num += __shfl_down_sync(0xffffffffu, s_num, off);
    s_den += __shfl_down_sync(0xffffffffu, s_den, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s_num;
    red[1][warp] = s_den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t_num = 0.f, t_den = 0.f;
    for (int w = 0; w < kRowThreads / 32; ++w) {
      t_num += red[0][w];
      t_den += red[1][w];
    }
    const long long b = (pc0 + blockIdx.y) * rows + row0 + blockIdx.x;
    partials[b] = t_num;
    partials[rows * ((n + piece - 1) / piece) + b] = t_den;
  }
}

Taps taps_of(const float* host) {
  Taps t;
  for (int i = 0; i < kNk; ++i) t.k[i] = host[i];
  return t;
}

}  // namespace

// taps: the nk float32 taps in host memory (copied into the launch's
// parameters). tile: outputs a thread takes along the axis
// (ops/rl_fused.py::axis_tile). dx == nullptr: plain input, otherwise y =
// max(in + *alpha * dx, 0) (zero boundary only). wrap != 0: a circular axis.
extern "C" int shrimpy_axis_pass(const void* in, void* out, const void* taps, int nk,
                                 long long outer, long long n, long long inner, long long tile,
                                 const void* dx, const void* alpha, int wrap, void* stream) {
  if (nk != kNk || tile < 1 || (dx != nullptr && wrap)) return (int)cudaErrorInvalidValue;
  const auto kernel = dx != nullptr ? axis_pass_kernel<true, false>
                      : wrap        ? axis_pass_kernel<false, true>
                                    : axis_pass_kernel<false, false>;
  const Taps t = taps_of((const float*)taps);
  const long long n_inner = (inner + kAxisThreads - 1) / kAxisThreads;
  const long long n_tiles = (n + tile - 1) / tile;
  if (n_inner > kMaxGridX) return (int)cudaErrorInvalidValue;
  for (long long z0 = 0; z0 < outer; z0 += kMaxGridYZ) {
    for (long long t0 = 0; t0 < n_tiles; t0 += kMaxGridYZ) {
      const dim3 grid((unsigned)n_inner, (unsigned)min(n_tiles - t0, kMaxGridYZ),
                      (unsigned)min(outer - z0, kMaxGridYZ));
      kernel<<<grid, kAxisThreads, 0, (cudaStream_t)stream>>>(
          (const float*)in, (float*)out, t, n, inner, tile, z0, t0, (const __nv_bfloat16*)dx,
          (const float*)alpha);
      const int err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}

// piece: the columns a block stages (ops/rl_fused.py::x_piece; n where the
// row fits). wrap != 0: circular rows. vec: see x_pass_kernel.
extern "C" int shrimpy_x_pass(const void* in, const void* prev, const void* aux, void* out,
                              const void* taps, int nk, long long rows, long long n,
                              long long piece, int mode, float eps, int wrap, int vec,
                              void* stream) {
  if (nk != kNk || piece < 1 || piece > n) return (int)cudaErrorInvalidValue;
  const long long pieces = (n + piece - 1) / piece;
  const size_t smem = (size_t)shrimpy_rl_pass_smem(kNk, piece);
  const auto kernel = pieces > 1 ? (wrap ? x_pass_kernel<true, true> : x_pass_kernel<false, true>)
                                 : (wrap ? x_pass_kernel<true, false> : x_pass_kernel<false, false>);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  const Taps t = taps_of((const float*)taps);
  for (long long pc0 = 0; pc0 < pieces; pc0 += kMaxGridYZ) {
    for (long long row0 = 0; row0 < rows; row0 += kMaxGridX) {
      const dim3 grid((unsigned)min(rows - row0, kMaxGridX),
                      (unsigned)min(pieces - pc0, kMaxGridYZ));
      kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(
          (const float*)in, (const float*)prev, (const float*)aux, (float*)out, t, n, piece,
          row0, pc0, mode, eps, vec);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}

// partials: 2 x rows x pieces floats (ops/rl_fused.py::x_blocks).
extern "C" int shrimpy_x_pass_accel(const void* in, const void* prev, void* x, void* dx, void* g,
                                    const void* alpha, void* partials, const void* taps, int nk,
                                    long long rows, long long n, long long piece, void* stream) {
  if (nk != kNk || piece < 1 || piece > n) return (int)cudaErrorInvalidValue;
  const long long pieces = (n + piece - 1) / piece;
  const size_t smem = (size_t)shrimpy_rl_pass_smem(kNk, piece);
  int err = set_smem((const void*)x_pass_accel_kernel, smem);
  if (err != 0) return err;
  const Taps t = taps_of((const float*)taps);
  for (long long pc0 = 0; pc0 < pieces; pc0 += kMaxGridYZ) {
    for (long long row0 = 0; row0 < rows; row0 += kMaxGridX) {
      const dim3 grid((unsigned)min(rows - row0, kMaxGridX),
                      (unsigned)min(pieces - pc0, kMaxGridYZ));
      x_pass_accel_kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(
          (const float*)in, (const float*)prev, (float*)x, (__nv_bfloat16*)dx,
          (__nv_bfloat16*)g, (const float*)alpha, (float*)partials, t, rows, n, piece, row0,
          pc0);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}
#endif  // RL_PASS_NK
