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
// not read. Linear indices are 64-bit.
// Bound on the card: bytes, each input voxel the map reads once and each
// output written once: 2 x 2.366 GB / 3.35 TB/s = 1.41 ms for a
// near-identity map of the production deskewed volume (128, 2888, 1600).
//
// The refine (register.py::_refine_jit :609, jax.grad through the gather):
// a step of it is two passes over the refine grid that materialise nothing.
// Per voxel u of the grid the loss reads the warp a = out[u], the mask
// w = (support > 0.999) (no gradient: stop_gradient in JAX) and b = fixed[u].
//   affine_refine_sums_kernel: the loss's weighted sums, in float64 from the
//     first voxel on (one pass of raw moments cancels where the data's mean
//     is large beside its spread: float64 keeps ~1e-16 of the mean): ncc
//     n = sum w, sum w a, sum w b, sum w a^2, sum w b^2, sum w a b; mse
//     sum w, sum w (a - b)^2. affine_refine_finish_kernel adds the blocks'
//     partials in block order and forms the loss of register.py::ncc_loss or
//     mse_loss (clamp_min(n, 1), the + 1e-8 of the NCC's denominator) and
//     the coefficients of its derivative: d loss / d a = w (alpha (a - ma) +
//     beta (b - mb)), with ma = mb = 0, alpha = -beta = 2 / n for mse, and
//     for ncc (centred sums S, r = sqrt(Saa Sbb), D = r + 1e-8)
//     alpha = Sab Sbb / (D^2 r), beta = -1 / D.
//   affine_refine_grad_kernel: d loss / d (M, t). Per voxel it recomputes the
//     corners, the sample, the support and the trilinear derivative g_c =
//     d out / d in_c (one-sided at integer coordinates: d frac / d in = 1, as
//     jax.grad takes it through floor), forms grad_out = d loss / d a from the
//     coefficients in float64, and sums s_c = grad_out * g_c times (z, y, x,
//     1): 12 sums. A lane sums s_c and s_c x along its part of a row in
//     float32 (at most ox / 32 terms) and adds them, times z and y, to its
//     float64 sums at the row's end.
// Both reduce a block by warp shuffles and shared memory to one partial row,
// and a second launch sums the rows in block order. No atomics: the grid is
// fixed by the device and the extents, so two runs give the same bits. All
// three kernels walk a row in one function (walk_row) and sample in one
// (blend), so the sample is the warp kernel's, bit for bit, and the support
// the warp of a volume of ones (the same weights summed in the same order).
// Bound: bytes, the input voxels the map reads and fixed, once each; DRAM
// moves whole 32-byte sectors, and the refine grid's stride-4 rows touch
// half the sectors of every other input row: ~1.33 GB at the production
// refine grid (128, 722, 400) of (128, 2888, 1600), 0.40 ms, against 0.74 GB
// and 0.22 ms by the voxels.

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

// The trilinear sample of corners v (out of range read as 0) and, with
// kSupport, the sum of the in-range corners' weights, the warp of a volume
// of ones: the product over the axes of the in-range weights' sums.
template <bool kSupport>
__device__ __forceinline__ void blend(const float v[2][2][2], const Axis& az, const Axis& ay,
                                      const Axis& ax, float* value, float* ones) {
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

template <bool kSupport, bool kIdx32>
__device__ __forceinline__ void sample(const float* __restrict__ vol, const Extents& e,
                                       const Axis& az, const Axis& ay, const Axis& ax,
                                       float* value, float* ones) {
  float v[2][2][2];
  corners<kIdx32>(vol, e, az, ay, ax, v);
  blend<kSupport>(v, az, ay, ax, value, ones);
}

// d out / d in_c: the corner weight's factor of axis c is (1 - f_c) or f_c,
// whose derivatives are -1 and +1.
__device__ __forceinline__ void derivative(const float v[2][2][2], const Axis& az,
                                           const Axis& ay, const Axis& ax, float g[3]) {
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

// The sample, its support and its derivative from one read of the corners.
template <bool kIdx32>
__device__ __forceinline__ void sample_slope(const float* __restrict__ vol, const Extents& e,
                                             const Axis& az, const Axis& ay, const Axis& ax,
                                             float* value, float* ones, float g[3]) {
  float v[2][2][2];
  corners<kIdx32>(vol, e, az, ay, ax, v);
  blend<true>(v, az, ay, ax, value, ones);
  derivative(v, az, ay, ax, g);
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

// Visits this lane's voxels x = lane, lane + 32, .. of output row (z, y):
// visit(x, az, ay, ax) with the sample's axes, in fixed point where the row
// allows (row_of), else in float64 a voxel; visit_nan(x) where the map is
// not finite there.
template <class Visit, class VisitNan>
__device__ __forceinline__ void walk_row(const Map& map, const Extents& e, long long z,
                                         long long y, int lane, Visit visit, VisitNan visit_nan) {
  double base[3], step[3];
  if (row_of(map, z, y, e.ox, base, step)) {
    long long c[3], dc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long long s = __double2ll_rn(step[a] * kFix);
      c[a] = __double2ll_rn(base[a] * kFix) + s * lane;
      dc[a] = s * 32;
    }
    // Four voxels a lane in flight, 32 corner loads: the warp took 2.71 ms
    // at the deskewed volume, against 3.46 unrolled twice and 3.22 eight
    // times (profile_step.py --affine builds those).
#pragma unroll 4  // the x loop
    for (int x = lane; x < e.ox; x += 32) {
      visit(x, axis_fixed(c[0], e.nz), axis_fixed(c[1], e.ny), axis_fixed(c[2], e.nx));
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] += dc[a];
    }
    return;
  }
  for (int x = lane; x < e.ox; x += 32) {
    const double c[3] = {fma(step[0], (double)x, base[0]), fma(step[1], (double)x, base[1]),
                         fma(step[2], (double)x, base[2])};
    if (!finite3(c))
      visit_nan(x);
    else
      visit(x, axis_double(c[0], e.nz), axis_double(c[1], e.ny), axis_double(c[2], e.nx));
  }
}

template <bool kIdx32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    affine_warp_kernel(const float* __restrict__ vol, float* __restrict__ out,
                       const double* __restrict__ params, Extents e) {
  const Map map = load_map(params);
  const int lane = threadIdx.x & 31;
  const long long n_rows = e.oz * e.oy;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n_rows;
       r += stride) {
    const long long z = r / e.oy, y = r - z * e.oy;
    float* orow = out + r * e.ox;
    walk_row(
        map, e, z, y, lane,
        [&](int x, const Axis& az, const Axis& ay, const Axis& ax) {
          sample<false, kIdx32>(vol, e, az, ay, ax, orow + x, nullptr);
        },
        // a map that is not finite gives NaN, as JAX's
        [&](int x) { orow[x] = __int_as_float(0x7fc00000); });
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Adds the block's threads' N sums into row blockIdx.x of partials (kSums
// wide): warp shuffles, then the warps in order.
template <int N>
__device__ __forceinline__ void to_partials(const double (&acc)[N], double* __restrict__ partials) {
  __shared__ double red[kWarps][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    partials[(long long)blockIdx.x * kSums + threadIdx.x] = s;
  }
}

// Sums of the loss: ncc n, a, b, a^2, b^2, a b; mse n, (a - b)^2 (weighted).
template <bool kMse>
struct Loss {
  static constexpr int n = kMse ? 2 : 6;
};

// One voxel's terms of the sums, in float64. w is 0 or 1; a NaN sample
// (a map that is not finite) makes the sums NaN, as w * a does in torch.
template <bool kMse>
__device__ __forceinline__ void add_moments(float a, float b, float ones,
                                            double (&acc)[Loss<kMse>::n]) {
  const double w = ones > 0.999f ? 1.0 : 0.0, da = a, db = b;
  acc[0] += w;
  if constexpr (kMse) {
    const double d = da - db;
    acc[1] = fma(w * d, d, acc[1]);
  } else {
    const double wa = w * da, wb = w * db;
    acc[1] += wa;
    acc[2] += wb;
    acc[3] = fma(wa, da, acc[3]);
    acc[4] = fma(wb, db, acc[4]);
    acc[5] = fma(wa, db, acc[5]);
  }
}

template <bool kMse, bool kIdx32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    affine_refine_sums_kernel(const float* __restrict__ vol, const float* __restrict__ fixed,
                              const double* __restrict__ params, double* __restrict__ partials,
                              Extents e) {
  const Map map = load_map(params);
  const int lane = threadIdx.x & 31;
  double acc[Loss<kMse>::n];
#pragma unroll
  for (int k = 0; k < Loss<kMse>::n; ++k) acc[k] = 0.0;
  const long long n_rows = e.oz * e.oy;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n_rows;
       r += stride) {
    const long long z = r / e.oy, y = r - z * e.oy;
    const float* brow = fixed + r * e.ox;
    walk_row(
        map, e, z, y, lane,
        [&](int x, const Axis& az, const Axis& ay, const Axis& ax) {
          float a, ones;
          sample<true, kIdx32>(vol, e, az, ay, ax, &a, &ones);
          add_moments<kMse>(a, __ldg(brow + x), ones, acc);
        },
        [&](int x) {
          const float nan = __int_as_float(0x7fc00000);
          add_moments<kMse>(nan, __ldg(brow + x), nan, acc);
        });
  }
  to_partials(acc, partials);
}

// Entries of stats: the loss, then alpha, beta, ma, mb of its derivative
// d loss / d a = w (alpha (a - ma) + beta (b - mb)), then sum w.
constexpr int kStats = 6;

// Adds the sums launch's partial rows in block order and forms the loss of
// register.py::ncc_loss or mse_loss and its derivative's coefficients, in
// float64: stats (kStats) and the loss as float32.
template <bool kMse>
__global__ void affine_refine_finish_kernel(const double* __restrict__ partials, int blocks,
                                            double* __restrict__ stats, float* __restrict__ loss) {
  constexpr int n = Loss<kMse>::n;
  __shared__ double tot[n];
  const int k = threadIdx.x;
  if (k < n) {
    double s = 0.0;
    for (int b = 0; b < blocks; ++b) s += partials[(long long)b * kSums + k];
    tot[k] = s;
  }
  __syncthreads();
  if (k != 0) return;
  const double w = tot[0], cnt = fmax(w, 1.0);  // clamp_min(sum w, 1)
  double value, alpha, beta, ma = 0.0, mb = 0.0;
  if constexpr (kMse) {
    value = tot[1] / cnt;
    alpha = 2.0 / cnt;
    beta = -alpha;
  } else {
    // Centred sums from the raw ones: S_uv = sum w u v - mu sum v - mv sum u
    // + mu mv sum w (exact algebra for any clamp of n).
    ma = tot[1] / cnt;
    mb = tot[2] / cnt;
    const double saa = tot[3] - 2.0 * ma * tot[1] + ma * ma * w;
    const double sbb = tot[4] - 2.0 * mb * tot[2] + mb * mb * w;
    const double sab = tot[5] - ma * tot[2] - mb * tot[1] + ma * mb * w;
    const double r = sqrt(saa * sbb), d = r + 1e-8;
    value = 1.0 - sab / d;
    alpha = sab * sbb / (d * d * r);
    beta = -1.0 / d;
  }
  stats[0] = value;
  stats[1] = alpha;
  stats[2] = beta;
  stats[3] = ma;
  stats[4] = mb;
  stats[5] = w;
  *loss = (float)value;
}

template <bool kIdx32>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    affine_refine_grad_kernel(const float* __restrict__ vol, const float* __restrict__ fixed,
                              const double* __restrict__ params, const double* __restrict__ stats,
                              double* __restrict__ partials, Extents e) {
  const Map map = load_map(params);
  const double alpha = __ldg(stats + 1), beta = __ldg(stats + 2), ma = __ldg(stats + 3),
               mb = __ldg(stats + 4);
  const int lane = threadIdx.x & 31;
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  const long long n_rows = e.oz * e.oy;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n_rows;
       r += stride) {
    const long long z = r / e.oy, y = r - z * e.oy;
    const float* brow = fixed + r * e.ox;
    // This lane's sums along the row: s_c and s_c * x.
    float rs[3] = {0.0f, 0.0f, 0.0f}, rsx[3] = {0.0f, 0.0f, 0.0f};
    // grad_out = d loss / d a of the voxel, w (alpha (a - ma) + beta (b - mb)).
    auto add = [&](int x, float a, float ones, const float g[3]) {
      const double w = ones > 0.999f ? 1.0 : 0.0;
      const float go =
          (float)(w * fma(alpha, (double)a - ma, beta * ((double)__ldg(brow + x) - mb)));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float s = go * g[c];
        rs[c] += s;
        rsx[c] = fmaf(s, (float)x, rsx[c]);
      }
    };
    walk_row(
        map, e, z, y, lane,
        [&](int x, const Axis& az, const Axis& ay, const Axis& ax) {
          float a, ones, g[3];
          sample_slope<kIdx32>(vol, e, az, ay, ax, &a, &ones, g);
          add(x, a, ones, g);
        },
        [&](int x) {
          const float nan = __int_as_float(0x7fc00000);
          const float g[3] = {nan, nan, nan};
          add(x, nan, nan, g);
        });
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[4 * c] = fma((double)rs[c], (double)z, acc[4 * c]);
      acc[4 * c + 1] = fma((double)rs[c], (double)y, acc[4 * c + 1]);
      acc[4 * c + 2] += (double)rsx[c];
      acc[4 * c + 3] += (double)rs[c];
    }
  }
  to_partials(acc, partials);
}

// Sums the grad launch's partial rows in block order: out = (dM row-major, dt).
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

// The refine's kernels for a volume of nz x ny x nx: 32-bit indices where it
// has fewer than 2^31 voxels.
struct RefineKernels {
  const void* sums[2];  // ncc, mse
  const void* grad;
};

RefineKernels refine_kernels_of(long long nz, long long ny, long long nx) {
  if (nz * ny * nx < (1LL << 31))
    return {{(const void*)affine_refine_sums_kernel<false, true>,
             (const void*)affine_refine_sums_kernel<true, true>},
            (const void*)affine_refine_grad_kernel<true>};
  return {{(const void*)affine_refine_sums_kernel<false, false>,
           (const void*)affine_refine_sums_kernel<true, false>},
          (const void*)affine_refine_grad_kernel<false>};
}

}  // namespace

// params: 12 float64 on the device, M row-major then t. Every extent in
// [1, 2^30].
extern "C" int shrimpy_affine_warp(const void* vol, void* out, const void* params, long long nz,
                                   long long ny, long long nx, long long oz, long long oy,
                                   long long ox, void* stream) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, ox, &e)) return (int)cudaErrorInvalidValue;
  const auto kernel =
      nz * ny * nx < (1LL << 31) ? affine_warp_kernel<true> : affine_warp_kernel<false>;
  int blocks = 0;
  const int err = grid_of((const void*)kernel, oz * oy, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const float*)vol, (float*)out,
                                                        (const double*)params, e);
  return (int)cudaGetLastError();
}

// The partial rows the refine's launches write for a volume of nz x ny x nx
// and a grid of oz x oy rows (their scratch: 12 float64 a row, the most of
// any of its kernels), or a negative error.
extern "C" int shrimpy_affine_refine_blocks(long long nz, long long ny, long long nx,
                                            long long oz, long long oy) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, 1, &e)) return -(int)cudaErrorInvalidValue;
  const RefineKernels k = refine_kernels_of(nz, ny, nx);
  int most = 0;
  for (const void* kernel : {k.sums[0], k.sums[1], k.grad}) {
    int blocks = 0;
    const int err = grid_of(kernel, oz * oy, &blocks);
    if (err != 0) return -err;
    most = blocks > most ? blocks : most;
  }
  return most;
}

// The refine's sums launch and its finish: warp vol (nz, ny, nx) by params
// onto the grid of fixed (oz, oy, ox), and write stats (kStats float64: the
// loss, the coefficients of its derivative, sum w) and the loss as one
// float32. mse: 0 for ncc_loss, 1 for mse_loss. partials: scratch of
// `capacity` >= shrimpy_affine_refine_blocks rows of 12 float64.
extern "C" int shrimpy_affine_refine_sums(const void* vol, const void* fixed, const void* params,
                                          void* partials, int capacity, void* stats, void* loss,
                                          long long nz, long long ny, long long nx, long long oz,
                                          long long oy, long long ox, int mse, void* stream) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, ox, &e)) return (int)cudaErrorInvalidValue;
  const RefineKernels k = refine_kernels_of(nz, ny, nx);
  const bool idx32 = nz * ny * nx < (1LL << 31);
  int blocks = 0;
  int err = grid_of(k.sums[mse ? 1 : 0], oz * oy, &blocks);
  if (err != 0) return err;
  if (blocks > capacity) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  const auto args = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>((const float*)vol, (const float*)fixed,
                                       (const double*)params, (double*)partials, e);
  };
  if (mse)
    idx32 ? args(affine_refine_sums_kernel<true, true>) : args(affine_refine_sums_kernel<true, false>);
  else
    idx32 ? args(affine_refine_sums_kernel<false, true>)
          : args(affine_refine_sums_kernel<false, false>);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  (mse ? affine_refine_finish_kernel<true> : affine_refine_finish_kernel<false>)<<<1, 32, 0, s>>>(
      (const double*)partials, blocks, (double*)stats, (float*)loss);
  return (int)cudaGetLastError();
}

// The refine's gradient launch and its finish: grad = d loss / d (M, t), 12
// float64 (M row-major, then t), from stats of shrimpy_affine_refine_sums
// with the same map. Arguments as there.
extern "C" int shrimpy_affine_refine_grad(const void* vol, const void* fixed, const void* params,
                                          const void* stats, void* partials, int capacity,
                                          void* grad, long long nz, long long ny, long long nx,
                                          long long oz, long long oy, long long ox, void* stream) {
  Extents e;
  if (!extents_of(nz, ny, nx, oz, oy, ox, &e)) return (int)cudaErrorInvalidValue;
  const bool idx32 = nz * ny * nx < (1LL << 31);
  int blocks = 0;
  int err = grid_of(refine_kernels_of(nz, ny, nx).grad, oz * oy, &blocks);
  if (err != 0) return err;
  if (blocks > capacity) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  (idx32 ? affine_refine_grad_kernel<true> : affine_refine_grad_kernel<false>)
      <<<blocks, kThreads, 0, s>>>((const float*)vol, (const float*)fixed,
                                   (const double*)params, (const double*)stats,
                                   (double*)partials, e);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  affine_grad_finish_kernel<<<1, 32, 0, s>>>((const double*)partials, blocks, (double*)grad);
  return (int)cudaGetLastError();
}
