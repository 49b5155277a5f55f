// One Richardson-Lucy half-step: zero-boundary separable 3-D convolution
// over T rank-1 terms plus the RL epilogue.
//
// Replaces the TPU kernel shrimpy_tpu/ops/rl_fused.py::_rl_fused_pass in
// modes "ratio", "mult", "plain", "ratio_accel" and "mult_accel"
// (callers conv3_fused and rl_fused).
// Semantics (oracle: richardson_lucy_reference_separable(boundary="zero")):
//
//   conv(v) = sum_t X_t Y_t Z_t v,   (A v)[n] = sum_i k[i] * v[n + r - i]
//
// with zero outside the G grid (the reflect-padded image). The adjoint
// pass is the same operator with every tap list reversed (host side).
//   ratio: out = aux / max(conv(in), eps)   (aux = data)
//   mult:  out = aux * conv(in)             (aux = est, may alias out)
//   plain: out = conv(in)
// Biggs-Andrews accelerated modes (alpha is a device scalar, dx and g
// are bf16 carries; y = max(x + alpha*dx, 0) never exists in memory):
//   ratio_accel: out = data / max(conv(y), eps), y formed as the z pass
//                of every term loads x (conv_axis_kernel<true>)
//   mult_accel:  x_new = y * conv(ratio) over x, dx = bf16(x_new - x)
//                over dx, g = bf16(x_new - y) over g_prev, and per-block
//                float32 partial sums of g*g_prev and g*g
//                (conv_x_accel_kernel); the wrapper sums the partials
//                with torch.sum (deterministic: no float atomics)
//
// Three kernels, launched by ops/rl_fused.py::half_step_cuda per term as
// z pass -> y pass -> x pass:
//   * conv_axis: a 1-D convolution along the middle axis of an
//     (outer, n, inner) view (z: (1, gz, gy*gx), y: (gz, gy, gx)).
//     Threads run along the contiguous inner axis, so every load
//     coalesces; each thread stages its own column of kTileN outputs plus
//     the 2r halo in shared memory (no block-level exchange, so no
//     barrier) and reads each input value once per tile. kWrap makes the
//     axis circular (the two-pass route of ops/conv3_cuda.py, zy_pallas).
//   * conv_x: the x pass on contiguous rows: a block takes one piece of a
//     (z, y) row (the whole row where it fits shared memory) and stages
//     the piece plus its 2r halo, then each thread produces outputs, adds
//     the partial sum of earlier terms (prev) and applies the epilogue in
//     the same launch. The linear_pallas and zy_pallas routes
//     (ops/conv3_cuda.py) run their x axis with it too, zy_pallas with
//     circular rows (kWrap).
//   * conv_x_accel: conv_x with the mult_accel epilogue, the last term's
//     x pass of that mode. The TPU kernel carries its partials in one
//     resident (8, 128) block across a sequential grid; here blocks run
//     in no order, so each writes its own pair and a second pass sums.
// A block of each kernel takes one tile; where an extent needs more blocks
// than a launch's grid holds (2^31 - 1 on x, 65535 on y and z), the entry
// point launches the kernel once for each chunk of the grid, with the
// chunk's offset, so any extent runs and a carry that fits one grid keeps
// its one launch and the kernel's code (a grid-stride loop in the kernel
// made every pass slower at the production carry).
// The accelerated modes move more: ratio_accel's z pass reads the bf16
// dx (half a carry) per term; mult_accel's x pass reads dx and g_prev and
// writes them back (two carries' worth of bf16).
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
// csrc/rl_half.cu fuses the three passes of a half-step into one launch and
// csrc/convzy.cu the z and y passes of the other stencil backends; these
// kernels run past those kernels' blocks, and conv_x is the x pass of the
// linear_pallas and zy_pallas routes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

// Tile constants chosen by a sweep at the production carry on an H100
// SXM 80 GB at 700 W (PERF.md): a 32-output column with its loads
// unrolled 8-deep keeps more loads in flight per SM than a 64-output
// column (z pass 5.5 -> 2.7 ms, y pass 7.5 -> 4.3 ms); 128 threads per
// x row beat 256.
constexpr int kThreadsInner = 128;  // threads along the contiguous axis
constexpr int kTileN = 32;          // outputs per thread along the conv axis
constexpr int kThreadsRow = 128;    // threads per x row
// The most taps one staged column of conv_axis serves: kTileN + kMaxChunk - 1
// rows of kThreadsInner floats fill a block's 232,448 bytes (radius 211).
constexpr int kMaxChunk = 232448 / (4 * kThreadsInner) - kTileN + 1;

// The most blocks a launch asks for on gridDim.x and on y or z.
constexpr long long kMaxGridX = 2147483647LL, kMaxGridYZ = 65535LL;

// m mod n in [0, n) for any m (a true modulo, only off the axis).
__device__ __forceinline__ long long wrap_at(long long m, long long n) {
  return (m >= 0 && m < n) ? m : ((m % n) + n) % n;
}

// kAccel: the input is y formed on load from x (in), dx and *alpha.
// kWrap: circular, in[m] = in[m mod n] (a true modulo, so r >= n wraps
// more than once); otherwise zero outside. The block takes inner tile
// blockIdx.x, tile t0 + blockIdx.y of the axis and outer index z0 +
// blockIdx.z. kChunks: the taps come in chunks of `chunk`, each staged as a
// column of kTileN + chunk - 1 rows, for tap lists whose whole column
// outgrows shared memory (k > kMaxChunk); each chunk goes on from the partial
// sums the chunk before wrote to out, so every output still sums its taps
// in ascending order from zero and keeps the bits of one column. A list
// that fits runs the one-column body (kChunks false): the chunked body on
// one chunk took 3-63 % longer at the production carry (profile_step.py
// --conv-axis, NVIDIA H100 80GB HBM3, 700 W).
template <bool kAccel, bool kWrap, bool kChunks>
__global__ void conv_axis_kernel(const float* __restrict__ in,
                                 float* __restrict__ out,
                                 const float* __restrict__ taps, int k, int chunk,
                                 long long n, long long inner, long long z0, long long t0,
                                 const __nv_bfloat16* __restrict__ dx,
                                 const float* __restrict__ alpha) {
  extern __shared__ float col[];  // [(kTileN + min(k, chunk) - 1) * kThreadsInner]
  const int r = k / 2;
  const long long i = (long long)blockIdx.x * kThreadsInner + threadIdx.x;
  if (i >= inner) return;  // no barrier below: each thread owns its column
  const long long n0 = (t0 + blockIdx.y) * kTileN;
  const long long plane = (z0 + blockIdx.z) * n * inner;
  const float* src = in + plane + i;
  float* dst = out + plane + i;
  const __nv_bfloat16* dsrc = kAccel ? dx + plane + i : nullptr;
  const float a = kAccel ? *alpha : 0.f;
  const int count = (int)min((long long)kTileN, n - n0);
  const int n_chunks = kChunks ? (k + chunk - 1) / chunk : 1;
  for (int c = 0; c < n_chunks; ++c) {
    // Taps tc .. tc + kc - 1 read in[m] for m from n0 + r - tc - kc + 1: the
    // column's row j holds in[that + j].
    const int tc = kChunks ? c * chunk : 0;
    const int kc = kChunks ? min(chunk, k - tc) : k;
    const long long m0 = n0 + r - tc - kc + 1;
    const int span = kTileN + kc - 1;
#pragma unroll 8
    for (int j = 0; j < span; ++j) {
      const long long m = m0 + j;
      float v = 0.f;
      if (kWrap) {
        v = src[wrap_at(m, n) * inner];
      } else if (m >= 0 && m < n) {
        v = src[m * inner];
        if (kAccel) v = extrapolate(v, dsrc[m * inner], a);
      }
      col[j * kThreadsInner + threadIdx.x] = v;
    }
    for (int o = 0; o < count; ++o) {
      // out[n0 + o] = sum_t k[t] * in[n0 + o + r - t]; in[m] sits at
      // column row m - m0, i.e. o + kc - 1 - (t - tc).
      float acc = (kChunks && c > 0) ? dst[(n0 + o) * inner] : 0.f;
      const float* cp = col + (o + kc - 1) * kThreadsInner + threadIdx.x;
      for (int t = 0; t < kc; ++t) {
        acc = fmaf(taps[tc + t], cp[-t * kThreadsInner], acc);
      }
      dst[(n0 + o) * inner] = acc;
    }
  }
}

// prev, aux and out may alias each other (in-place mult pass): no
// __restrict__ on them. Each element is read and written by one thread.
// kWrap: the row is circular (the x axis of the zy_pallas route and of
// conv3_circular, ops/conv3_cuda.py): row[j] = in[(p0 + j - r) mod n], with
// a true modulo so r >= n wraps more than once; otherwise zero outside.
// The block takes piece pc0 + blockIdx.y (columns p0 .. p0 + piece) of row
// row0 + blockIdx.x; a row that fits shared memory is one piece, and
// kPieces false compiles that case with p0 = 0 (a run-time p0 made the
// wrapped pass slower at the production carry).
template <bool kWrap, bool kPieces>
__global__ void conv_x_kernel(const float* __restrict__ in, const float* prev,
                              const float* aux, float* out,
                              const float* __restrict__ taps, int k,
                              long long n, long long piece, long long row0, long long pc0,
                              int mode, float eps) {
  extern __shared__ float row[];  // [piece + 2r]
  const int r = k / 2;
  const long long p0 = kPieces ? (pc0 + blockIdx.y) * piece : 0;
  const long long base = (row0 + blockIdx.x) * n + p0;  // the piece's first element
  const long long len = kPieces ? min(piece, n - p0) : n;
  for (long long j = threadIdx.x; j < len + 2 * r; j += kThreadsRow) {
    const long long m = p0 + j - r;
    if (kWrap) {
      // 32-bit: a row is shorter than 2^31, and a 64-bit modulo is
      // emulated (it cost 0.2-0.4 ms a pass at the production carry).
      const int mi = (int)m, ni = (int)n;
      row[j] = in[base - p0 + ((mi >= 0 && mi < ni) ? mi : ((mi % ni) + ni) % ni)];
    } else {
      row[j] = (m >= 0 && m < n) ? in[base + j - r] : 0.f;
    }
  }
  __syncthreads();
  for (long long x = threadIdx.x; x < len; x += kThreadsRow) {
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

// The x pass of mode mult_accel. x, dx and g are read and written in
// place (each element by one thread), so none of them is __restrict__.
// Pieces as conv_x_kernel's. Block b = (pc0 + blockIdx.y) * rows + row0 +
// blockIdx.x of B = rows * pieces writes partials[b] and partials[B + b]: its
// piece's
// sums of g*g_prev and g*g over the bf16-rounded g, in a fixed order (a
// thread's elements in order, then warp shuffles, then the warps in order),
// so the sums do not depend on the order the blocks run in.
__global__ void conv_x_accel_kernel(const float* __restrict__ in,
                                    const float* prev, float* x,
                                    __nv_bfloat16* dx, __nv_bfloat16* g,
                                    const float* __restrict__ alpha,
                                    float* __restrict__ partials,
                                    const float* __restrict__ taps, int k,
                                    long long rows, long long n, long long piece,
                                    long long row0, long long pc0) {
  extern __shared__ float row[];  // [piece + 2r]
  __shared__ float red[2][kThreadsRow / 32];
  const int r = k / 2;
  const long long p0 = (pc0 + blockIdx.y) * piece;
  const long long base = (row0 + blockIdx.x) * n + p0;
  const long long len = min(piece, n - p0);
  for (long long j = threadIdx.x; j < len + 2 * r; j += kThreadsRow) {
    const long long m = p0 + j - r;
    row[j] = (m >= 0 && m < n) ? in[base + j - r] : 0.f;
  }
  __syncthreads();
  const float a = *alpha;
  float s_num = 0.f, s_den = 0.f;
  for (long long c0 = threadIdx.x; c0 < len; c0 += kThreadsRow) {
    float acc = 0.f;
    const float* c = row + c0 + 2 * r;
    for (int t = 0; t < k; ++t) {
      acc = fmaf(taps[t], c[-t], acc);
    }
    if (prev != nullptr) acc += prev[base + c0];
    const long long e = base + c0;
    const float xo = x[e];
    const float y = extrapolate(xo, dx[e], a);
    const float xn = __fmul_rn(y, acc);
    const __nv_bfloat16 gb = __float2bfloat16_rn(__fsub_rn(xn, y));
    const float gf = __bfloat162float(gb);
    const float gp = __bfloat162float(g[e]);
    x[e] = xn;
    dx[e] = __float2bfloat16_rn(__fsub_rn(xn, xo));
    g[e] = gb;
    s_num = fmaf(gf, gp, s_num);
    s_den = fmaf(gf, gf, s_den);
  }
  // Fixed-order block reduction: warp shuffles, then warp 0 in order.
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
    for (int w = 0; w < kThreadsRow / 32; ++w) {
      t_num += red[0][w];
      t_den += red[1][w];
    }
    const long long b = (pc0 + blockIdx.y) * rows + row0 + blockIdx.x;
    partials[b] = t_num;
    partials[rows * ((n + piece - 1) / piece) + b] = t_den;
  }
}

}  // namespace

// dx == nullptr: plain input; otherwise y = max(in + *alpha * dx, 0) (zero
// boundary only). wrap != 0: a circular axis. A tap list whose column of
// kTileN + k - 1 rows outgrows a block's shared memory (k > kMaxChunk, a
// radius past 211) runs in chunks of kMaxChunk taps (conv_axis_kernel's
// kChunks).
extern "C" int shrimpy_conv_axis(const void* in, void* out, const void* taps,
                                 int k, long long outer, long long n,
                                 long long inner, const void* dx,
                                 const void* alpha, int wrap, void* stream) {
  if (dx != nullptr && wrap) return (int)cudaErrorInvalidValue;
  const bool chunks = k > kMaxChunk;
  const size_t smem = (size_t)(kTileN + min(k, kMaxChunk) - 1) * kThreadsInner * sizeof(float);
  const auto kernel = dx != nullptr ? (chunks ? conv_axis_kernel<true, false, true>
                                              : conv_axis_kernel<true, false, false>)
                      : wrap        ? (chunks ? conv_axis_kernel<false, true, true>
                                              : conv_axis_kernel<false, true, false>)
                                    : (chunks ? conv_axis_kernel<false, false, true>
                                              : conv_axis_kernel<false, false, false>);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  const long long n_inner = (inner + kThreadsInner - 1) / kThreadsInner;
  const long long n_tiles = (n + kTileN - 1) / kTileN;
  if (n_inner > kMaxGridX) return (int)cudaErrorInvalidValue;
  for (long long z0 = 0; z0 < outer; z0 += kMaxGridYZ) {
    for (long long t0 = 0; t0 < n_tiles; t0 += kMaxGridYZ) {
      const dim3 grid((unsigned)n_inner, (unsigned)min(n_tiles - t0, kMaxGridYZ),
                      (unsigned)min(outer - z0, kMaxGridYZ));
      kernel<<<grid, kThreadsInner, smem, (cudaStream_t)stream>>>(
          (const float*)in, (float*)out, (const float*)taps, k, kMaxChunk, n, inner, z0, t0,
          (const __nv_bfloat16*)dx, (const float*)alpha);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}

// piece: the columns a block stages (ops/rl_fused.py::x_piece; n where the
// row fits). wrap != 0: circular rows (conv_x_kernel<true>).
extern "C" int shrimpy_conv_x(const void* in, const void* prev, const void* aux,
                              void* out, const void* taps, int k,
                              long long rows, long long n, long long piece, int mode,
                              float eps, int wrap, void* stream) {
  if (piece < 1 || piece > n) return (int)cudaErrorInvalidValue;
  const long long pieces = (n + piece - 1) / piece;
  const size_t smem = (size_t)(piece + 2 * (k / 2)) * sizeof(float);
  const auto kernel = pieces > 1 ? (wrap ? conv_x_kernel<true, true> : conv_x_kernel<false, true>)
                                 : (wrap ? conv_x_kernel<true, false> : conv_x_kernel<false, false>);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  for (long long pc0 = 0; pc0 < pieces; pc0 += kMaxGridYZ) {
    for (long long row0 = 0; row0 < rows; row0 += kMaxGridX) {
      const dim3 grid((unsigned)min(rows - row0, kMaxGridX), (unsigned)min(pieces - pc0, kMaxGridYZ));
      kernel<<<grid, kThreadsRow, smem, (cudaStream_t)stream>>>(
          (const float*)in, (const float*)prev, (const float*)aux, (float*)out,
          (const float*)taps, k, n, piece, row0, pc0, mode, eps);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}

// partials: 2 x rows x pieces floats (ops/rl_fused.py::x_blocks).
extern "C" int shrimpy_conv_x_accel(const void* in, const void* prev, void* x,
                                    void* dx, void* g, const void* alpha,
                                    void* partials, const void* taps, int k,
                                    long long rows, long long n, long long piece,
                                    void* stream) {
  if (piece < 1 || piece > n) return (int)cudaErrorInvalidValue;
  const long long pieces = (n + piece - 1) / piece;
  const size_t smem = (size_t)(piece + 2 * (k / 2)) * sizeof(float);
  int err = set_smem((const void*)conv_x_accel_kernel, smem);
  if (err != 0) return err;
  for (long long pc0 = 0; pc0 < pieces; pc0 += kMaxGridYZ) {
    for (long long row0 = 0; row0 < rows; row0 += kMaxGridX) {
      const dim3 grid((unsigned)min(rows - row0, kMaxGridX), (unsigned)min(pieces - pc0, kMaxGridYZ));
      conv_x_accel_kernel<<<grid, kThreadsRow, smem, (cudaStream_t)stream>>>(
          (const float*)in, (const float*)prev, (float*)x, (__nv_bfloat16*)dx,
          (__nv_bfloat16*)g, (const float*)alpha, (float*)partials,
          (const float*)taps, k, rows, n, piece, row0, pc0);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  return 0;
}
