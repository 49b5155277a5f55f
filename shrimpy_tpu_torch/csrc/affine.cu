// Trilinear affine warp (scipy order 1, 'grid-constant') and its gradient
// with respect to the map.
//
// No TPU kernel: on the TPU the JAX package computes this function in XLA,
// shrimpy_tpu/ops/register.py::affine_apply (:472) in four tiers that each
// avoid a gather there (masked rolls for a translation, 1-D shear passes
// for a triangular map, a blocked candidate window, and the one-shot gather
// _affine_apply_jit + _trilinear_sample). On the H100 a gather of the 8
// corners of a near-identity map reads nearly the cache lines a stencil
// reads, so one kernel computes all four tiers' function in one pass.
// The gradient replaces jax.grad through the gather in
// register.py::_refine_jit (:609).
//
//   in = M . out + t              (ZYX, the inverse map; M row-major)
//   out[u] = sum over the 8 corners c of floor(in):
//            w_z(c) w_y(c) w_x(c) vol[c],  corners outside vol weigh 0
//
// Coordinates: float32 M . u + t, as the JAX gather forms it, rounds by up
// to ~2.4e-4 px at u ~ 2888, which moves a trilinear sample of noisy data
// by more than 1e-4 of its scale. Here each warp forms its row's start
// M[:, 0] z + M[:, 1] y + t and slope M[:, 2] in float64 and turns them
// into fixed point, Q32.32 in an int64 (exact: a scaling by 2^32 and one
// rounding, 2^-33 px); the lanes then step along x by integer adds. The
// floor is the high word, the fraction the low word's top 23 bits (a
// float32 in [0, 1) built from its bits). So the inner loop does no
// float64 work and no conversion: the first version formed every
// coordinate in float64 (a DFMA, a floor, two conversions an axis) and
// took 6.84 ms at the production volume, 4.8x the bound, the same for
// every map: it was bound by those instructions, not by memory. A row whose
// coordinates leave +-2^29 px (a diverging refine), or a map that is not
// finite, takes the float64 path per voxel. The weights and the sum are
// float32, in the JAX order (z, then y, then x corners; acc += w * v).
//
// affine_warp_kernel: a persistent 1-D grid; a warp takes an output row
// (z, y) at a time, rows warp_id, + n_warps, ... in 64 bits, and its lanes
// walk x, so output stores coalesce and a near-identity map's corner loads
// nearly do (the x + 1 corner is the next lane's x corner, from L1). The 8
// corners come through the read-only path (__ldg); a corner out of range is
// not read. Linear indices are 64-bit. With `support` the kernel also
// writes the warp of a volume of ones (the same weights summed in the same
// order: the bits of warping torch.ones), which the refine's mask reads.
// Bound on the card: bytes, each input voxel the map reads once and each
// output written once: 2 x 2.366 GB / 3.35 TB/s = 1.41 ms for a
// near-identity map of the production deskewed volume (128, 2888, 1600).
//
// affine_warp_grad_kernel: d loss / d (M, t) from grad_out = d loss / d out.
// Per voxel it recomputes the corners and the trilinear derivative g_a =
// d out / d in_a (one-sided at integer coordinates: d frac / d in = 1, as
// jax.grad takes it through floor), and sums s_a = grad_out * g_a times
// (z, y, x, 1): 12 sums. A lane sums s_a and s_a x along its part of a row
// in float32 (at most ox / 32 terms) and adds them, times z and y, to its
// float64 sums at the row's end; a block reduces
// them by warp shuffles and shared memory to one partial row; a second
// launch sums the rows in block order. No atomics: the grid is fixed by the
// device and the extents, so two runs give the same bits. Bound: bytes,
// grad_out and the input voxels the map reads, once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 12;
constexpr double kFix = 4294967296.0;  // 2^32: Q32.32 coordinates
// A row runs in fixed point when its coordinates stay inside +-2^29 px and
// its slope under 2^23 px a voxel: every value a lane's sum reaches, also
// the steps past the row's end, then stays inside +-2^30 px.
constexpr double kFixLimit = 536870912.0;
constexpr double kFixSlope = 8388608.0;
constexpr long long kMaxExtent = 1LL << 30;
// One block an SM is all the launch bounds ask for, so the unrolled x
// loops keep their registers (~120): with __launch_bounds__(kThreads)
// alone nvcc capped both kernels at 80 and the warp took 3.41 ms, not 2.71.
constexpr int kMinBlocks = 1;

struct Extents {
  int nz, ny, nx;     // vol
  long long oz, oy;   // out rows
  int ox;
  long long sy, sz;   // strides of vol in floats: nx, ny * nx
};

struct Map {
  double m[9];
  double t[3];
};

__device__ __forceinline__ Map load_map(const double* __restrict__ p) {
  Map map;
#pragma unroll
  for (int i = 0; i < 9; ++i) map.m[i] = __ldg(p + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) map.t[i] = __ldg(p + 9 + i);
  return map;
}

// One axis of a sample: the low corner i = floor(c), the fraction, and
// whether corners i and i + 1 lie in [0, n).
struct Axis {
  int i;
  float f;
  bool lo, hi;
};

__device__ __forceinline__ Axis finish(Axis a, int n) {
  a.lo = (unsigned)a.i < (unsigned)n;
  a.hi = (unsigned)(a.i + 1) < (unsigned)n;
  return a;
}

// c in Q32.32 inside +-2^30 px.
__device__ __forceinline__ Axis axis_fixed(long long c, int n) {
  Axis a;
  a.i = (int)(c >> 32);
  a.f = __uint_as_float(0x3f800000u | ((unsigned)c >> 9)) - 1.0f;
  return finish(a, n);
}

// c finite, any size: past either end both corners are out of range.
__device__ __forceinline__ Axis axis_double(double c, int n) {
  const double fl = floor(c);
  Axis a;
  a.i = (int)fmin(fmax(fl, -2.0), (double)n);
  a.f = (float)(c - fl);
  return finish(a, n);
}

// The 8 corners of one sample, v[dz][dy][dx], 0 where out of range (not
// read). kIdx32: the volume has fewer than 2^31 voxels, and linear indices
// are 32-bit (one IMAD.WIDE a row of corners); else 64-bit.
template <bool kIdx32>
__device__ __forceinline__ void corners(const float* __restrict__ vol, const Extents& e,
                                        const Axis& az, const Axis& ay, const Axis& ax,
                                        float v[2][2][2]) {
  const float* rows[2][2];
  if (kIdx32) {
    // Wraps where a corner is out of range (such a corner is not read); an
    // in-range corner's row starts at an index in [-1, 2^31), exact as int.
    const unsigned idx = ((unsigned)az.i * (unsigned)e.ny + (unsigned)ay.i) * (unsigned)e.nx +
                         (unsigned)ax.i;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
        rows[dz][dy] = vol + (int)(idx + (unsigned)(dz ? e.sz : 0) + (unsigned)(dy ? e.sy : 0));
  } else {
    const float* p = vol + ((long long)az.i * e.ny + ay.i) * e.sy + ax.i;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) rows[dz][dy] = p + (dz ? e.sz : 0) + (dy ? e.sy : 0);
  }
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const bool ok_zy = (dz ? az.hi : az.lo) && (dy ? ay.hi : ay.lo);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
        v[dz][dy][dx] = ok_zy && (dx ? ax.hi : ax.lo) ? __ldg(rows[dz][dy] + dx) : 0.0f;
    }
  }
}

// The trilinear sample (corners out of range read as 0) and, with
// kSupport, the sum of the in-range corners' weights, the warp of a volume
// of ones: the product over the axes of the in-range weights' sums.
template <bool kSupport, bool kIdx32>
__device__ __forceinline__ void sample(const float* __restrict__ vol, const Extents& e,
                                       const Axis& az, const Axis& ay, const Axis& ax,
                                       float* value, float* ones) {
  float v[2][2][2];
  corners<kIdx32>(vol, e, az, ay, ax, v);
  const float wz[2] = {1.0f - az.f, az.f}, wy[2] = {1.0f - ay.f, ay.f};
  const float wx[2] = {1.0f - ax.f, ax.f};
  float acc = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
      acc = fmaf(wz[dz] * wy[dy], fmaf(wx[1], v[dz][dy][1], wx[0] * v[dz][dy][0]), acc);
  *value = acc;
  if (kSupport) {
    const float sz = (az.lo ? wz[0] : 0.0f) + (az.hi ? wz[1] : 0.0f);
    const float sy = (ay.lo ? wy[0] : 0.0f) + (ay.hi ? wy[1] : 0.0f);
    const float sx = (ax.lo ? wx[0] : 0.0f) + (ax.hi ? wx[1] : 0.0f);
    *ones = sz * sy * sx;
  }
}

// d out / d in_a: the corner weight's factor of axis a is (1 - f_a) or f_a,
// whose derivatives are -1 and +1.
template <bool kIdx32>
__device__ __forceinline__ void slope(const float* __restrict__ vol, const Extents& e,
                                      const Axis& az, const Axis& ay, const Axis& ax,
                                      float g[3]) {
  float v[2][2][2];
  corners<kIdx32>(vol, e, az, ay, ax, v);
  const float w[3][2] = {{1.0f - az.f, az.f}, {1.0f - ay.f, ay.f}, {1.0f - ax.f, ax.f}};
  g[0] = g[1] = g[2] = 0.0f;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      g[0] += w[1][p] * w[2][q] * (v[1][p][q] - v[0][p][q]);
      g[1] += w[0][p] * w[2][q] * (v[p][1][q] - v[p][0][q]);
      g[2] += w[0][p] * w[1][q] * (v[p][q][1] - v[p][q][0]);
    }
  }
}

// A row's float64 start (x = 0) and slope per axis; true where the row
// runs in fixed point (kFixLimit, kFixSlope; false for a NaN map).
__device__ __forceinline__ bool row_of(const Map& map, long long z, long long y, int ox,
                                       double base[3], double step[3]) {
  bool fixed = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    base[a] = fma(map.m[3 * a], (double)z, fma(map.m[3 * a + 1], (double)y, map.t[a]));
    step[a] = map.m[3 * a + 2];
    const double end = fma(step[a], (double)(ox - 1), base[a]);
    fixed = fixed && fabs(base[a]) < kFixLimit && fabs(end) < kFixLimit &&
            fabs(step[a]) < kFixSlope;
  }
  return fixed;
}

__device__ __forceinline__ bool finite3(const double c[3]) {
  return isfinite(c[0]) && isfinite(c[1]) && isfinite(c[2]);
}

template <bool kSupport, bool kIdx32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    affine_warp_kernel(const float* __restrict__ vol, float* __restrict__ out,
                       float* __restrict__ support, const double* __restrict__ params,
                       Extents e) {
  const Map map = load_map(params);
  const int lane = threadIdx.x & 31;
  const long long n_rows = e.oz * e.oy;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n_rows;
       r += stride) {
    const long long z = r / e.oy, y = r - z * e.oy;
    float* orow = out + r * e.ox;
    float* srow = kSupport ? support + r * e.ox : nullptr;
    double base[3], step[3];
    if (row_of(map, z, y, e.ox, base, step)) {
      long long c[3], dc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const long long s = __double2ll_rn(step[a] * kFix);
        c[a] = __double2ll_rn(base[a] * kFix) + s * lane;
        dc[a] = s * 32;
      }
      // Four voxels a lane in flight, 32 corner loads: 2.71 ms at the
      // deskewed volume, against 3.46 unrolled twice and 3.22 eight times
      // (profile_step.py --affine builds those).
#pragma unroll 4
      for (int x = lane; x < e.ox; x += 32) {
        sample<kSupport, kIdx32>(vol, e, axis_fixed(c[0], e.nz), axis_fixed(c[1], e.ny),
                         axis_fixed(c[2], e.nx), orow + x, kSupport ? srow + x : nullptr);
#pragma unroll
        for (int a = 0; a < 3; ++a) c[a] += dc[a];
      }
      continue;
    }
    for (int x = lane; x < e.ox; x += 32) {
      const double c[3] = {fma(step[0], (double)x, base[0]), fma(step[1], (double)x, base[1]),
                           fma(step[2], (double)x, base[2])};
      if (!finite3(c)) {  // a map that is not finite gives NaN, as JAX's
        orow[x] = __int_as_float(0x7fc00000);
        if (kSupport) srow[x] = __int_as_float(0x7fc00000);
        continue;
      }
      sample<kSupport, kIdx32>(vol, e, axis_double(c[0], e.nz), axis_double(c[1], e.ny),
                       axis_double(c[2], e.nx), orow + x, kSupport ? srow + x : nullptr);
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool kIdx32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    affine_warp_grad_kernel(const float* __restrict__ vol, const float* __restrict__ grad_out,
                            const double* __restrict__ params, double* __restrict__ partials,
                            Extents e) {
  __shared__ double red[kWarps][kSums];
  const Map map = load_map(params);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  const long long n_rows = e.oz * e.oy;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n_rows; r += stride) {
    const long long z = r / e.oy, y = r - z * e.oy;
    const float* grow = grad_out + r * e.ox;
    // This lane's sums along the row: s_a and s_a * x.
    float rs[3] = {0.0f, 0.0f, 0.0f}, rsx[3] = {0.0f, 0.0f, 0.0f};
    double base[3], step[3];
    if (row_of(map, z, y, e.ox, base, step)) {
      long long c[3], dc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const long long s = __double2ll_rn(step[a] * kFix);
        c[a] = __double2ll_rn(base[a] * kFix) + s * lane;
        dc[a] = s * 32;
      }
#pragma unroll 4  // the grad's x loop: 0.521 ms at the refine grid, 0.572 not unrolled
      for (int x = lane; x < e.ox; x += 32) {
        float g[3];
        slope<kIdx32>(vol, e, axis_fixed(c[0], e.nz), axis_fixed(c[1], e.ny),
                      axis_fixed(c[2], e.nx), g);
        const float go = __ldg(grow + x);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float s = go * g[a];
          rs[a] += s;
          rsx[a] = fmaf(s, (float)x, rsx[a]);
          c[a] += dc[a];
        }
      }
    } else {
      for (int x = lane; x < e.ox; x += 32) {
        const double c[3] = {fma(step[0], (double)x, base[0]), fma(step[1], (double)x, base[1]),
                             fma(step[2], (double)x, base[2])};
        float g[3];
        if (!finite3(c)) {
          g[0] = g[1] = g[2] = __int_as_float(0x7fc00000);
        } else {
          slope<kIdx32>(vol, e, axis_double(c[0], e.nz), axis_double(c[1], e.ny),
                        axis_double(c[2], e.nx), g);
        }
        const float go = __ldg(grow + x);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float s = go * g[a];
          rs[a] += s;
          rsx[a] = fmaf(s, (float)x, rsx[a]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[4 * a] = fma((double)rs[a], (double)z, acc[4 * a]);
      acc[4 * a + 1] = fma((double)rs[a], (double)y, acc[4 * a + 1]);
      acc[4 * a + 2] += (double)rsx[a];
      acc[4 * a + 3] += (double)rs[a];
    }
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partials[(long long)blockIdx.x * kSums + threadIdx.x] = s;
  }
}

// Sums the blocks' partial rows in block order: out = (dM row-major, dt).
__global__ void affine_grad_finish_kernel(const double* __restrict__ partials, int blocks,
                                          double* __restrict__ out) {
  const int k = threadIdx.x;
  if (k >= kSums) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partials[(long long)b * kSums + k];
  const int a = k / 4, j = k % 4;
  out[j < 3 ? 3 * a + j : 9 + a] = s;
}

int grid_of(const void* kernel, long long n_rows, int* blocks) {
  int device = 0, sms = 0, per_sm = 0, err;
  if ((err = (int)cudaGetDevice(&device)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != 0)
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
      0)
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = (n_rows + kWarps - 1) / kWarps;
  *blocks = (int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  return 0;
}

// Extents of a launch, or false where one is out of (0, 2^30].
bool extents_of(long long nz, long long ny, long long nx, long long oz, long long oy,
                long long ox, Extents* e) {
  for (long long n : {nz, ny, nx, oz, oy, ox})
    if (n < 1 || n > kMaxExtent) return false;
  *e = {(int)nz, (int)ny, (int)nx, oz, oy, (int)ox, nx, ny * nx};
  return true;
}

// The instance of the grad kernel for a volume of nz x ny x nx.
const void* grad_kernel_of(long long nz, long long ny, long long nx) {
  return nz * ny * nx < (1LL << 31) ? (const void*)affine_warp_grad_kernel<true>
                                    : (const void*)affine_warp_grad_kernel<false>;
}

}  // namespace

// params: 12 float64 on the device, M row-major then t. support may be null.
// Every extent in [1, 2^30].
extern "C" int shrimpy_affine_warp(const void* vol, void* out, void* support, const void* params,
                                   long long nz, long long ny, long long nx, long long oz,
                                   long long oy, long long ox, void* stream) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, ox, &e)) return (int)cudaErrorInvalidValue;
  const bool idx32 = nz * ny * nx < (1LL << 31);
  const auto kernel = support ? (idx32 ? affine_warp_kernel<true, true>
                                       : affine_warp_kernel<true, false>)
                              : (idx32 ? affine_warp_kernel<false, true>
                                       : affine_warp_kernel<false, false>);
  int blocks = 0;
  const int err = grid_of((const void*)kernel, oz * oy, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (float*)out, (float*)support, (const double*)params, e);
  return (int)cudaGetLastError();
}

// The number of partial rows shrimpy_affine_warp_grad writes for a volume of
// nz x ny x nx and an output of oz x oy rows (its scratch holds 12 float64 a
// row), or a negative error.
extern "C" int shrimpy_affine_grad_blocks(long long nz, long long ny, long long nx, long long oz,
                                          long long oy) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, 1, &e)) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = grid_of(grad_kernel_of(nz, ny, nx), oz * oy, &blocks);
  return err != 0 ? -err : blocks;
}

// grad: 12 float64 on the device, d loss / d M row-major then d loss / d t;
// partials: scratch of shrimpy_affine_grad_blocks(oz, oy) x 12 float64.
extern "C" int shrimpy_affine_warp_grad(const void* vol, const void* grad_out, const void* params,
                                        void* partials, void* grad, long long nz, long long ny,
                                        long long nx, long long oz, long long oy, long long ox,
                                        void* stream) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, ox, &e)) return (int)cudaErrorInvalidValue;
  const bool idx32 = nz * ny * nx < (1LL << 31);
  int blocks = 0;
  int err = grid_of(grad_kernel_of(nz, ny, nx), oz * oy, &blocks);
  if (err != 0) return err;
  (idx32 ? affine_warp_grad_kernel<true> : affine_warp_grad_kernel<false>)
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)grad_out, (const double*)params, (double*)partials, e);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  affine_grad_finish_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const double*)partials, blocks,
                                                                (double*)grad);
  return (int)cudaGetLastError();
}
