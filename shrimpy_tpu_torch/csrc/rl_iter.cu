// One whole Richardson-Lucy iteration in one launch:
//
//   out = est * conv^T(data / max(conv(est), eps))
//
// on the exact (gz, gy, gx) G grid, zero outside it, float32 FMA, with
//   conv(v) = sum_t Z_t Y_t X_t v,   (A v)[n] = sum_i k[i] * v[n + r - i]
// and conv^T the same operator with every tap list reversed (the host
// packs both directions, ops/rl_fused_iter.py::pack_taps). The ratio and
// every per-axis intermediate live in shared memory only: the launch reads
// est and data and writes out. out must alias neither input (neighbouring
// blocks read est halos while this one stores).
//
// Replaces the TPU kernel shrimpy_tpu/ops/rl_fused_iter.py::_rl_iter_pass.
// That kernel walks a sequential grid with three rings of 8-plane slabs of
// ~170 x ~1280 voxels in on-chip memory and runs the y and x axes as
// matrix products against banded stencils. None of that carries over: a
// block here has 227 KB, so the tile is small, the rings hold single
// planes, and all three axes are shifted FMAs.
//
// A block owns a (ty, tx) column of the (y, x) plane and marches through z
// one plane a step, p = 0 .. gz - 1 + 2 rz, with a lag of 2 rz planes
// between the est plane it loads and the out plane it stores:
//   A. load the (ty + 4ry) x (tx + 4rx) slab of est plane p (zero outside
//      the grid); per term the x pass into scratch and the y pass into slot
//      p mod K of ring A, K = 2rz + 1: (ty + 2ry) x (tx + 2rx) values, the
//      footprint the adjoint needs of the ratio.
//   B. q = p - rz: the z pass over ring A gives conv(est) on plane q; the
//      ratio plane is data / max(conv, eps), and exactly 0 outside the grid
//      (the adjoint's zero boundary), written over the dead est slab. Per
//      term the adjoint x pass into scratch and the adjoint y pass into slot
//      q mod K of ring B: ty x tx values.
//   C. o = q - rz: the adjoint z pass over ring B, times est[o] re-read from
//      global memory, is out[o].
// Planes outside [0, gz) are zero: both rings start zeroed, and slots of
// planes past gz are zeroed as the march reaches them.
//
// Bound on the card: operations and shared-memory loads, not DRAM. The
// halo recompute makes each output voxel cost
//   [(ty+4ry)(tx+2rx) kx + (ty+2ry)(tx+2rx)(ky + kz)
//    + (ty+2ry) tx kx + ty tx (ky + kz)] / (ty tx)
// FMAs per term: ~200 at the production radii (4, 10, 10) on the (32, 48)
// tile and ~306 on (16, 32), against 102 for the six bare passes. A thread
// therefore computes four outputs at once so that a shared-memory load
// feeds four FMAs:
//   - x and y passes: four consecutive outputs along the convolved axis
//     slide over one window of the source; a step loads one source value
//     and (every fourth step, as a float4) four taps, for four FMAs each.
//     The taps arrive zero-padded by 3 on the left so that every output
//     runs the same steps; a padded tap meets a clamped, finite source
//     value and adds an exact zero.
//   - the x pass walks rows across a warp's lanes, so the row strides of
//     what it reads and writes (slab, ratio, scratch) are odd: no bank
//     conflict. The y and z passes walk columns across lanes.
//   - z passes: four rows a quarter of the plane apart share each tap.
// Each output still sums its taps in ascending order from zero, so the
// result does not depend on the tile. Device memory sees three carries
// (est, data, out) plus the slab halos, which neighbouring blocks share
// through L2. Plane offsets are 64-bit, in-plane indices 32-bit.
//
// Measured on the card (PERF.md): the time falls with the tile's area, since
// a larger tile recomputes less halo and gives every barrier interval more
// work to hide latency under, so the wrapper takes the largest tile whose
// rings fit.

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

// The x pass: dst[r * dst_stride + c] = sum_i taps[i] * src[r * src_stride +
// c + k - 1 - i] for r < rows, c < cols (src is k - 1 wider than dst). Lanes
// walk rows: both strides are odd.
template <int kThreads>
__device__ __forceinline__ void x_pass(const float* __restrict__ src, int src_stride,
                                       float* __restrict__ dst, int dst_stride, int rows,
                                       int cols, const float* __restrict__ tp, int k) {
  const int groups = (cols + 3) >> 2, n4 = round4(k + 3);
  for (int w = threadIdx.x; w < groups * rows; w += kThreads) {
    const int g = w / rows, r = w - g * rows, c = g << 2;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    window4(src + r * src_stride, 1, c + k + 2, cols + k - 2, tp, n4, acc);
    float* d = dst + r * dst_stride + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < cols) d[j] = acc[j];
  }
}

// The y pass: dst[r * dst_stride + c] = sum_i taps[i] * src[(r + k - 1 - i) *
// src_stride + c] (src is k - 1 taller than dst). Lanes walk columns.
template <int kThreads>
__device__ __forceinline__ void y_pass(const float* __restrict__ src, int src_stride,
                                       float* __restrict__ dst, int dst_stride, int rows,
                                       int cols, const float* __restrict__ tp, int k) {
  const int groups = (rows + 3) >> 2, n4 = round4(k + 3);
  for (int w = threadIdx.x; w < groups * cols; w += kThreads) {
    const int g = w / cols, c = w - g * cols, r = g << 2;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    window4(src + c, src_stride, r + k + 2, rows + k - 2, tp, n4, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r + j < rows) dst[(r + j) * dst_stride + c] = acc[j];
  }
}

// The z pass at column c of rows r0 + j * quarter, j = 0..3 (clamped to the
// last row): sum_t sum_i kz_t[i] * ring_t[slot of plane (last - i)], `last`
// the newest plane it reads (slot `slot_last`). Planes are rows x cols,
// compact.
__device__ __forceinline__ void z_pass4(const float* __restrict__ ring, int rows, int cols,
                                        int ring_planes, int slot_last,
                                        const float* __restrict__ taps, int term_taps,
                                        int n_terms, int r0, int quarter, int c,
                                        float (&total)[4]) {
  const int plane_elems = rows * cols;
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) off[j] = min(r0 + j * quarter, rows - 1) * cols + c;
  for (int t = 0; t < n_terms; ++t) {
    const float* kz = taps + t * term_taps;
    const float* rt = ring + t * ring_planes * plane_elems;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int slot = slot_last;
    for (int i = 0; i < ring_planes; ++i) {
      const float tap = kz[i];
      const float* pl = rt + slot * plane_elems;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(tap, pl[off[j]], acc[j]);
      slot = slot == 0 ? ring_planes - 1 : slot - 1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) total[j] = t == 0 ? acc[j] : total[j] + acc[j];
  }
}

template <int kThreads>
__device__ __forceinline__ void fill_zero(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.f;
}

// Floats of shared memory a block takes (the host's sum and the kernel's
// carve-up, in one place).
__host__ __device__ inline size_t smem_floats(int n_terms, int nkz, int nky, int nkx, int ty,
                                              int tx) {
  const int ry = nky / 2, rx = nkx / 2;
  const int sr = ty + 4 * ry, sc = tx + 4 * rx, mr = ty + 2 * ry, mc = tx + 2 * rx;
  return (size_t)2 * n_terms * term_tap_floats(nkz, nky, nkx) + (size_t)sr * odd(sc) +
         (size_t)sr * odd(mc) + (size_t)n_terms * nkz * (mr * mc + ty * tx);
}

// 1024 threads for the tiles that fill them (one block an SM), else 512 with
// registers held to two blocks an SM.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 512 ? 2 : 1)
rl_iter_kernel(const float* __restrict__ est, const float* __restrict__ data,
               float* __restrict__ out, const float* __restrict__ taps_g, int n_terms,
               int nkz, int nky, int nkx, int gz, int gy, int gx, int ty, int tx, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rz = nkz / 2, ry = nky / 2, rx = nkx / 2;
  const int sr = ty + 4 * ry, sc = tx + 4 * rx;  // est slab
  const int mr = ty + 2 * ry, mc = tx + 2 * rx;  // ratio footprint, ring A planes
  const int ss = odd(sc), ms = odd(mc), ts = odd(tx);  // row strides the x pass walks
  const int a_elems = mr * mc, b_elems = ty * tx;
  const int term_taps = term_tap_floats(nkz, nky, nkx);
  const int ky_at = round4(nkz), kx_at = ky_at + window_taps(nky);
  float* taps = smem;                            // [2][n_terms][kz | ky window | kx window]
  const float* taps_adj = taps + n_terms * term_taps;
  float* slab = taps + 2 * n_terms * term_taps;  // sr x ss; then the mr x ms ratio plane
  float* scratch = slab + sr * ss;               // sr x ms; then mr x ts (adjoint)
  float* ring_a = scratch + sr * ms;             // [n_terms][nkz][mr x mc]
  float* ring_b = ring_a + n_terms * nkz * a_elems;  // [n_terms][nkz][ty x tx]

  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;
  const long long plane = (long long)gy * gx;

  for (int i = threadIdx.x; i < 2 * n_terms * term_taps; i += kThreads) taps[i] = taps_g[i];
  fill_zero<kThreads>(ring_a, n_terms * nkz * a_elems);
  fill_zero<kThreads>(ring_b, n_terms * nkz * b_elems);
  __syncthreads();

  for (int p = 0; p < gz + 2 * rz; ++p) {
    const int slot_a = p % nkz;
    if (p < gz) {
      // A. the est slab of plane p, zero outside the grid.
      const float* src = est + p * plane;
      for (int w = threadIdx.x; w < sr * sc; w += kThreads) {
        const int r = w / sc, c = w - r * sc;
        const int y = y0 - 2 * ry + r, x = x0 - 2 * rx + c;
        slab[r * ss + c] = (y >= 0 && y < gy && x >= 0 && x < gx) ? src[y * gx + x] : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < n_terms; ++t) {
        const float* kt = taps + t * term_taps;
        x_pass<kThreads>(slab, ss, scratch, ms, sr, mc, kt + kx_at, nkx);
        __syncthreads();
        y_pass<kThreads>(scratch, ms, ring_a + (t * nkz + slot_a) * a_elems, mc, mr, mc,
                         kt + ky_at, nky);
        __syncthreads();
      }
    } else {
      for (int t = 0; t < n_terms; ++t)
        fill_zero<kThreads>(ring_a + (t * nkz + slot_a) * a_elems, a_elems);
      __syncthreads();
    }

    const int q = p - rz;
    if (q < 0) continue;
    const int slot_b = q % nkz;
    if (q < gz) {
      // B. conv(est) on plane q from ring A (planes p - 2rz .. p), then the
      // ratio over the dead slab: 0 outside the grid.
      const float* dsrc = data + q * plane;
      float* ratio = slab;
      const int quarter = (mr + 3) >> 2;
      for (int w = threadIdx.x; w < quarter * mc; w += kThreads) {
        const int r0 = w / mc, c = w - r0 * mc;
        float conv[4];
        z_pass4(ring_a, mr, mc, nkz, slot_a, taps, term_taps, n_terms, r0, quarter, c, conv);
        const int x = x0 - rx + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + j * quarter, y = y0 - ry + r;
          if (r < mr)
            ratio[r * ms + c] = (y >= 0 && y < gy && x >= 0 && x < gx)
                                    ? dsrc[y * gx + x] / fmaxf(conv[j], eps)
                                    : 0.f;
        }
      }
      __syncthreads();
      for (int t = 0; t < n_terms; ++t) {
        const float* kt = taps_adj + t * term_taps;
        x_pass<kThreads>(ratio, ms, scratch, ts, mr, tx, kt + kx_at, nkx);
        __syncthreads();
        y_pass<kThreads>(scratch, ts, ring_b + (t * nkz + slot_b) * b_elems, tx, ty, tx,
                         kt + ky_at, nky);
        __syncthreads();
      }
    } else {
      for (int t = 0; t < n_terms; ++t)
        fill_zero<kThreads>(ring_b + (t * nkz + slot_b) * b_elems, b_elems);
      __syncthreads();
    }

    const int o = q - rz;
    if (o < 0) continue;
    // C. the adjoint z pass over ring B (planes q - 2rz .. q), times est[o].
    // The next step's first barrier comes before anything writes ring B.
    const long long base = o * plane;
    const int quarter = (ty + 3) >> 2;
    for (int w = threadIdx.x; w < quarter * tx; w += kThreads) {
      const int r0 = w / tx, c = w - r0 * tx;
      float acc[4];
      z_pass4(ring_b, ty, tx, nkz, slot_b, taps_adj, term_taps, n_terms, r0, quarter, c, acc);
      const int x = x0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + j * quarter, y = y0 + r;
        if (r < ty && y < gy && x < gx) {
          const long long e = base + y * gx + x;
          out[e] = est[e] * acc[j];
        }
      }
    }
  }
}

}  // namespace

// Bytes of shared memory a block of the kernel takes with this geometry and
// tile (ops/rl_fused_iter.py::iter_smem_bytes is the same sum).
extern "C" int shrimpy_rl_iter_smem(int n_terms, int nkz, int nky, int nkx, int ty, int tx) {
  return (int)(smem_floats(n_terms, nkz, nky, nkx, ty, tx) * sizeof(float));
}

namespace {

template <int kThreads>
int launch(const float* est, const float* data, float* out, const float* taps, int n_terms,
           int nkz, int nky, int nkx, int gz, int gy, int gx, int ty, int tx, float eps,
           cudaStream_t stream) {
  const size_t smem = smem_floats(n_terms, nkz, nky, nkx, ty, tx) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute((const void*)rl_iter_kernel<kThreads>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)smem);
    if (err != 0) return err;
  }
  dim3 grid((unsigned)((gx + tx - 1) / tx), (unsigned)((gy + ty - 1) / ty));
  rl_iter_kernel<kThreads><<<grid, kThreads, smem, stream>>>(est, data, out, taps, n_terms, nkz,
                                                             nky, nkx, gz, gy, gx, ty, tx, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// taps: float32 [2][n_terms][round4(nkz) + window(nky) + window(nkx)], the
// convolution's then the adjoint's, each list padded as the kernel reads it
// (pack_taps). threads: 512 or 1024 a block. The wrapper has checked that
// the tile's shared memory fits.
extern "C" int shrimpy_rl_iter(const void* est, const void* data, void* out, const void* taps,
                               int n_terms, int nkz, int nky, int nkx, long long gz,
                               long long gy, long long gx, int ty, int tx, int threads,
                               float eps, void* stream) {
  const auto run = threads == 1024 ? launch<1024> : threads == 512 ? launch<512> : nullptr;
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  return run((const float*)est, (const float*)data, (float*)out, (const float*)taps, n_terms,
             nkz, nky, nkx, (int)gz, (int)gy, (int)gx, ty, tx, eps, (cudaStream_t)stream);
}
