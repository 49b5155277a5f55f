// One whole Richardson-Lucy iteration in one launch:
//
//   out = est * conv^T(data / max(conv(est), eps))
//
// on the exact (gz, gy, gx) G grid, zero outside it, float32 FMA, with
//   conv(v) = sum_t Z_t Y_t X_t v,   (A v)[n] = sum_i k[i] * v[n + r - i]
// and conv^T the same operator with every tap list reversed (the host packs
// both directions, ops/rl_fused_iter.py::pack_taps). The ratio and every
// per-axis intermediate stay on the chip: the launch reads est and data and
// writes out. out must alias neither input (neighbouring blocks read est
// halos while this one stores).
//
// Order of the sums, the same as rl_iter_plain's: per term the x pass, then
// y, then z, each output summing its taps in ascending order from zero with
// one FMA a tap; the terms added in order; both convolutions alike. So the
// kernel gives the plain version's bits on every tile.
//
// Replaces the TPU kernel shrimpy_tpu/ops/rl_fused_iter.py::_rl_iter_pass,
// which walks a sequential grid with rings of 8-plane slabs of ~170 x ~1280
// voxels and runs the y and x axes as matrix products against banded
// stencils; none of that carries over to a block of 227 KB.
//
// Bound on the card: bytes in principle (12 a voxel: est and data read, out
// written), but a block recomputes the halo that the adjoint needs of the
// ratio, ~220 FMAs a voxel at the production radii (4, 10, 10) on tile
// (32, 48) against 102 for the six bare passes, so issue and shared memory
// bind it. What the design does about it:
//   * A block owns a (ty, tx) column of the (y, x) plane and marches through
//     z with a software pipeline of four stages, two barriers a plane step.
//     Step s:
//       I1: [B] the adjoint y pass of ratio plane s - 2 - rz from bx, its z
//           pass over the planes a thread keeps in registers, out = est *
//           that for plane o = s - 2 - 2rz;
//           [A.z] the z pass of ring A for plane q = s - 1 - rz (planes
//           q - rz .. q + rz are there since step s - 1), the ratio
//           data / max(conv, eps) on the (ty + 2ry) x (tx + 2rx) footprint,
//           exactly 0 outside the grid (the adjoint's zero boundary), into rp;
//           [A.x] the x pass of the est slab of plane s into xs, per term;
//       barrier; the slab of plane s + 1 is requested;
//       I2: [A.y] the y pass of xs into slot s of ring A, per term;
//           [B.x] the adjoint x pass of rp into bx, per term;
//       barrier.
//     The stages of one interval read nothing another of them writes, so a
//     thread runs its pieces of each back to back and every warp has work
//     of several kinds between two barriers.
//   * The est slab of a plane, (ty + 4ry) x (tx + 4rx) and 16-byte-aligned in
//     x, is one TMA copy issued by one thread after the first barrier and
//     waited for (mbarrier) just before the next step's x pass: it lands
//     under the second interval and the first pieces of the next. The
//     tensor map's zero fill is the zero boundary on all three axes. Carries
//     that a tensor map cannot take (gx % 4 != 0, unaligned) go by cp.async
//     of 4 bytes a thread, out-of-grid elements zeroed once.
//   * data (for the ratio) and est (for the product) are requested into
//     registers a whole step before they are used.
//   * Register tiles: the x passes give a thread four outputs of a row from
//     whole 16-byte pieces of its source (sixteen FMAs a load); A.y four rows
//     by two columns (eight a load); the adjoint y pass four rows of one
//     tile column, whose z pass then needs no shared memory at all: a thread
//     keeps its 2rz older planes of that column in registers from step to
//     step (the ring B of the first port, 2rz + 1 planes of ty x tx a term,
//     is gone). Ring A (2rz + 2 planes of the footprint a term, the last
//     being written while the z pass reads the others) stays in shared
//     memory: at 141 KB it is what bounds the tile.
//   * The geometry is the compiler's: the number of terms, the three PSF
//     lengths and the tile are macros (RL_ITER_TERMS, _NKZ, _NKY, _NKX, _TY,
//     _TX) and kernels/build.py compiles this file for each geometry that is
//     run, so every tap loop unrolls and every stride is an immediate.
//     Without the macros the file gives only shrimpy_rl_iter_smem.
//   * Each stage's pieces are dealt round-robin to the 512 threads, each
//     stage starting where the one before it in the interval stopped, so no
//     thread has more than one piece more than another.
//
// NVIDIA H100 80GB HBM3, 700 W, carry (136, 2908, 1620), PSF (9, 21, 21):
// PERF.md has the times (chip_smoke.py phase 3, profile_step.py --tiles).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>

#include "async_copy.cuh"
#include "stencil.cuh"

namespace {

// -DRL_ITER_PROFILE: thread 0 of every block adds up the clocks it spends in
// each stage of a plane step and writes the sums to partials[kStages * block
// ..]: 0 B, 1 A.z, 2 waiting for the slab, 3 A.x, 4 the first barrier, 5 the
// slab's request, 6 A.y, 7 B.x, 8 waiting for cp.async, 9 the second
// barrier. A build for profile_step.py --stages.
constexpr int kStages = 10;
#ifdef RL_ITER_PROFILE
#define RL_ITER_TICK(k)                   \
  do {                                    \
    if (tid == 0) {                       \
      const long long now = clock64();    \
      prof[k] += now - t_last;            \
      t_last = now;                       \
    }                                     \
  } while (0)
#else
#define RL_ITER_TICK(k)
#endif

constexpr int kThreads = 512;
constexpr int kGuardRows = 4;  // zero rows before a plane that a y window walks down
constexpr int kTopRows = 3;    // and after xs, which A.y's last row group may reach

// The x radius a block walks: an odd rx gets one zero tap more at each end
// of both x lists (which adds exact zeros and costs no step: the windows are
// as long), so that 2 rx is a multiple of 4. Then slab column 0 (grid column
// x0 - 2 rx) starts a 16-byte piece of the grid, as a TMA box must (a box
// that starts 8 bytes into one stops the card with an illegal instruction),
// and the four outputs of every x window read whole 16-byte pieces of the
// slab and of the ratio plane, whose column 0 is grid column x0 - rx.
__host__ __device__ constexpr int x_radius(int nkx) { return nkx / 2 + (nkx / 2) % 2; }

// A block's shapes and shared memory, in floats (the host's sum,
// ops/rl_fused_iter.py::iter_smem_bytes, is the same).
struct Layout {
  int rxa, sr, sw, mr, xw;  // 2 rx; slab sr x sw, footprint mr x xw
  int xs_plane, ring_slot, bx_plane;
  int slab, xs, ring, rp, bx, bar, total;  // offsets; taps at 0
};

__host__ __device__ constexpr Layout layout_of(int n_terms, int nkz, int nky, int nkx, int ty,
                                               int tx) {
  const int ry = nky / 2;
  Layout l{};
  l.rxa = 2 * x_radius(nkx);
  l.sr = ty + 4 * ry;
  l.sw = tx + 2 * l.rxa;
  l.mr = ty + 2 * ry;
  l.xw = tx + l.rxa;
  l.xs_plane = round32((kGuardRows + l.sr + kTopRows) * l.xw);
  l.ring_slot = round32(l.mr * l.xw);
  l.bx_plane = round32((kGuardRows + l.mr) * tx);
  l.slab = round32(2 * n_terms * term_tap_floats(nkz, nky, nkx));
  l.xs = l.slab + round32(l.sr * l.sw);
  l.ring = l.xs + n_terms * l.xs_plane;
  l.rp = l.ring + n_terms * (nkz + 1) * l.ring_slot;
  l.bx = l.rp + l.ring_slot;
  l.bar = l.bx + n_terms * l.bx_plane;
  l.total = l.bar + 4;
  return l;
}

#ifdef RL_ITER_NKZ
// The geometry this build is for.
constexpr int kT = RL_ITER_TERMS, kNkz = RL_ITER_NKZ, kNky = RL_ITER_NKY, kNkx = RL_ITER_NKX,
              kTy = RL_ITER_TY, kTx = RL_ITER_TX;
constexpr Layout kL = layout_of(kT, kNkz, kNky, kNkx, kTy, kTx);
// Its shapes and offsets as scalars, which device code reads as immediates.
constexpr int kRxa = kL.rxa, kSr = kL.sr, kSw = kL.sw, kMr = kL.mr, kXw = kL.xw;
constexpr int kXsPlane = kL.xs_plane, kRingSlot = kL.ring_slot, kBxPlane = kL.bx_plane;
constexpr int kSlabAt = kL.slab, kXsAt = kL.xs, kRingAt = kL.ring, kRpAt = kL.rp, kBxAt = kL.bx,
              kBarAt = kL.bar, kTotal = kL.total;
constexpr int kRz = kNkz / 2, kRy = kNky / 2, kRx = x_radius(kNkx);
constexpr int kSlots = kNkz + 1;  // ring A
constexpr int kTermTaps = term_tap_floats(kNkz, kNky, kNkx);
constexpr int kKyAt = round4(kNkz), kKxAt = kKyAt + window_taps(kNky);
constexpr int kN4y = round4(kNky + 3), kN4x = round4(2 * kRx + 4);
constexpr int kKeep = kNkz - 1;  // older planes of the adjoint z pass in registers

// Pieces of each stage: B 4 rows x 1 column of the tile (one a thread at
// most); A.z and A.x 4 columns of a row; A.y 4 rows x 2 columns; B.x 4
// columns of a row.
constexpr int kNB = (kTy / 4) * kTx;
constexpr int kXP = kXw / 4;
constexpr int kNZ = kMr * kXP;
constexpr int kNX = kSr * kXP;
constexpr int kYC = kXw / 2, kNY = ((kMr + 3) / 4) * kYC;
constexpr int kBXP = kTx / 4, kNBX = kMr * kBXP;
constexpr int kZRounds = (kNZ + kThreads - 1) / kThreads;
// cp.async: 16-byte chunks of the slab a thread moves.
constexpr int kSlab4 = kSr * kSw / 4;
constexpr int kChunks = (kSlab4 + kThreads - 1) / kThreads;

// What a block takes (ops/rl_fused_iter.py::iter_layout checks the same).
static_assert(kTy % 4 == 0 && kTx % 4 == 0 && kNB <= kThreads && kSr <= 256 &&
                  kSw <= 256 && kChunks <= 8 && kT * kKeep <= 16 &&
                  kTotal * 4 <= 232448,
              "the geometry does not fit a block");

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// The x pass: four outputs from the kN4 / 4 whole 16-byte pieces at src,
// walked from the last (the window of stencil.cuh::window_fma).
template <int kN4>
__device__ __forceinline__ float4 x_window(const float4* src, const float* tp) {
  const float4* tp4 = reinterpret_cast<const float4*>(tp);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < kN4 / 4; ++g) {
    const float4 v = src[kN4 / 4 - 1 - g];
    const float vd[4] = {v.w, v.z, v.y, v.x};
    window_fma(tp4[g], tp4[g + 1], vd, acc);
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The y pass: four outputs, rows r0 .. r0 + 3, of kCols neighbouring columns,
// walking down a plane of row stride `stride` from p, the row r0 + 3 + 2ry.
template <int kN4, int kCols>
__device__ __forceinline__ void y_window(const float* p, int stride, const float* tp,
                                         float (&acc)[kCols][4]) {
  const float4* tp4 = reinterpret_cast<const float4*>(tp);
#pragma unroll
  for (int g = 0; g < kN4 / 4; ++g) {
    float v[kCols][4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float* row = p - (4 * g + d) * stride;
      if constexpr (kCols == 2) {
        const float2 w = *reinterpret_cast<const float2*>(row);
        v[0][d] = w.x;
        v[1][d] = w.y;
      } else {
        v[0][d] = row[0];
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) window_fma(tp4[g], tp4[g + 1], v[c], acc[c]);
  }
}

// kVec: gx % 4 == 0 and est is 16-byte aligned, so the slab comes by TMA.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
rl_iter_kernel(const float* __restrict__ est, const float* __restrict__ data,
               float* __restrict__ out, const float* __restrict__ taps_g,
               float* __restrict__ partials, const __grid_constant__ CUtensorMap est_map, int gz,
               int gy, int gx, float eps) {
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* taps = smem;  // [2][kT][kTermTaps]: the convolution's, then the adjoint's
  const float* taps_adj = taps + kT * kTermTaps;
  float* slab = smem + kSlabAt;  // sr x sw: the est slab in flight
  float* xs = smem + kXsAt;      // [kT] guard rows, sr x xw, top rows: A.x
  float* ring = smem + kRingAt;  // [kT][kSlots] mr x xw: A.y of the planes the z pass reads
  float* rp = smem + kRpAt;      // mr x xw: the ratio
  float* bx = smem + kBxAt;      // [kT] guard rows, mr x tx: B.x
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + kBarAt);

  const int tid = threadIdx.x;
#ifdef RL_ITER_PROFILE
  __shared__ long long prof[kStages];
  if (tid == 0)
    for (int k = 0; k < kStages; ++k) prof[k] = 0;
  long long t_last = clock64();
#endif
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const long long plane = (long long)gy * gx;
  const int sx0 = x0 - kRxa, sy0 = y0 - 2 * kRy;  // grid origin of the slab
  const int fx0 = x0 - kRx, fy0 = y0 - kRy;        // and of the footprint

  // The taps, each x list one place on where the kernel walks one x radius
  // more (the window is as long: it drops one of its trailing zeros).
  constexpr int kShift = kRx - kNkx / 2;
  for (int i = tid; i < 2 * kT * kTermTaps; i += kThreads) {
    const int at = i % kTermTaps;
    taps[i] = at < kKxAt ? taps_g[i] : at - kKxAt < kShift ? 0.f : taps_g[i - kShift];
  }
  // Guard and top rows, ring A (planes before 0), bx: zero.
  for (int i = tid; i < kBarAt - kXsAt; i += kThreads) smem[kXsAt + i] = 0.f;
  // cp.async copies only the slab's elements in the grid: the others are
  // zeroed once. goff[j]: offset in a plane of chunk tid + j * kThreads; bit
  // e of nibble j of cmask: its element e lies in the grid.
  int goff[kVec ? 1 : kChunks];
  unsigned cmask = 0;
  if (!kVec) {
    for (int i = tid; i < kSr * kSw; i += kThreads) slab[i] = 0.f;
#pragma unroll
    for (int j = 0; j < (kVec ? 1 : kChunks); ++j) {
      const int cid = tid + j * kThreads;
      goff[j] = 0;
      if (cid >= kSlab4) continue;
      const int row = cid / (kSw / 4), y = sy0 + row, x = sx0 + 4 * (cid - row * (kSw / 4));
      if (y < 0 || y >= gy) continue;
      goff[j] = y * gx + x;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e >= 0 && x + e < gx) cmask |= 1u << (4 * j + e);
    }
  }
  auto request_slab = [&](int p) {
    if (kVec) {
      if (tid == 0) {
        mbar_expect(bar, 4u * (unsigned)(kSr * kSw));
        tma_load_3d(slab, &est_map, sx0, sy0, p, bar);
      }
    } else {
      const float* src = est + (long long)p * plane;
#pragma unroll
      for (int j = 0; j < (kVec ? 1 : kChunks); ++j) {
        const unsigned m = (cmask >> (4 * j)) & 15u;
        if (m == 0u) continue;
        float* d = slab + 4 * (tid + j * kThreads);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (m >> e & 1u) copy_async4(d + e, src + goff[j] + e);
      }
      copies_commit();
    }
  };

  // B: this thread's piece, tile rows 4 b_rg .. + 3 of column b_c; bit j of
  // b_mask says that row j lies in the grid. It keeps, per term, its values
  // of the kKeep adjoint y-pass planes before the newest.
  const bool b_on = tid < kNB;
  const int b_rg = tid / kTx, b_c = tid - b_rg * kTx;
  unsigned b_mask = 0;
  int b_off = 0;
  if (b_on && x0 + b_c < gx && y0 + 4 * b_rg < gy) {
    b_off = (y0 + 4 * b_rg) * gx + x0 + b_c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (y0 + 4 * b_rg + j < gy) b_mask |= 1u << j;
  }
  float kept[kT][kKeep > 0 ? kKeep : 1][4] = {};
  float ev[4] = {0.f, 0.f, 0.f, 0.f};  // est of the plane B writes next
  // A.z: pieces z_first + k * kThreads; their offsets in a plane and grid masks.
  const int z_first = (tid + kThreads - kNB) % kThreads;
  int z_off[kZRounds];
  unsigned z_mask[kZRounds];
  float dz[kZRounds][4];  // data of the plane A.z works on next
#pragma unroll
  for (int k = 0; k < kZRounds; ++k) {
    const int z = z_first + k * kThreads, r = z / kXP, y = fy0 + r;
    const int x = fx0 + 4 * (z - r * kXP);
    z_off[k] = 0;
    z_mask[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) dz[k][j] = 0.f;
    if (z >= kNZ || y < 0 || y >= gy) continue;
    z_off[k] = y * gx + x;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j >= 0 && x + j < gx) z_mask[k] |= 1u << j;
  }
  // The other stages' pieces start where the one before them in the interval
  // stopped.
  const int x_first = (tid + 2 * kThreads - (kNB + kNZ) % kThreads) % kThreads;
  const int bx_first = (tid + kThreads - (kT * kNY) % kThreads) % kThreads;

  if (kVec && tid == 0) mbar_init(bar, 1);
  if (kVec) fence_async_smem();
  __syncthreads();  // the zeros, the taps and the mbarrier before the first copy
  request_slab(0);
  if (!kVec) copies_wait();
  __syncthreads();
  RL_ITER_TICK(9);

  for (int s = 0; s < gz + 2 * kRz + 2; ++s) {
    const int q = s - 1 - kRz, o = q - 1 - kRz;
    const bool live = s < gz, q_live = q >= 0 && q < gz;

    // I1, B: the adjoint y pass of plane o + rz (bx), its z pass, out[o].
    auto stage_b = [&]() {
      if (b_on && o + kRz >= 0) {
        float total[4];
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const float* kt = taps_adj + t * kTermTaps;
          float fresh[1][4] = {{0.f, 0.f, 0.f, 0.f}};
          y_window<kN4y, 1>(
              bx + t * kBxPlane + (kGuardRows + 4 * b_rg + 2 * kRy + 3) * kTx + b_c, kTx,
              kt + kKyAt, fresh);
          float acc[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = fmaf(kt[0], fresh[0][j], 0.f);
#pragma unroll
          for (int k = 0; k < kKeep; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = fmaf(kt[k + 1], kept[t][k][j], acc[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j) total[j] = t == 0 ? acc[j] : total[j] + acc[j];
#pragma unroll
          for (int k = kKeep - 1; k > 0; --k)
#pragma unroll
            for (int j = 0; j < 4; ++j) kept[t][k][j] = kept[t][k - 1][j];
          if (kKeep > 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) kept[t][0][j] = fresh[0][j];
          }
        }
        if (o >= 0) {
          float* dst = out + (long long)o * plane + b_off;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (b_mask >> j & 1u) dst[j * gx] = ev[j] * total[j];
        }
      }
      if (o + 1 >= 0 && o + 1 < gz) {  // est of the next plane B writes, a step ahead
        const float* src = est + (long long)(o + 1) * plane + b_off;
#pragma unroll
        for (int j = 0; j < 4; ++j) ev[j] = (b_mask >> j & 1u) ? src[j * gx] : 0.f;
      }
      RL_ITER_TICK(0);
    };
    // I1, A.z: conv(est) on plane q from ring A (plane q + rz - i in the slot
    // i before that of plane s - 1), then the ratio, 0 outside the grid.
    auto stage_z = [&]() {
      const int newest = (s + kSlots - 1) % kSlots;
      const long long next = (long long)(q + 1) * plane;
      const bool next_live = q + 1 >= 0 && q + 1 < gz;
#pragma unroll
      for (int k = 0; k < kZRounds; ++k) {
        const int z = z_first + k * kThreads;
        if (z >= kNZ) break;
        const int r = z / kXP, c4 = z - r * kXP, at = r * kXw + 4 * c4;
        float4 res = zero4();
        if (q_live) {
          float total[4];
#pragma unroll
          for (int t = 0; t < kT; ++t) {
            const float* kz = taps + t * kTermTaps;
            const float* rt = ring + t * kSlots * kRingSlot + at;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            int slot = newest;
#pragma unroll
            for (int i = 0; i < kNkz; ++i) {
              const float4 v = *reinterpret_cast<const float4*>(rt + slot * kRingSlot);
              acc[0] = fmaf(kz[i], v.x, acc[0]);
              acc[1] = fmaf(kz[i], v.y, acc[1]);
              acc[2] = fmaf(kz[i], v.z, acc[2]);
              acc[3] = fmaf(kz[i], v.w, acc[3]);
              slot = slot == 0 ? kSlots - 1 : slot - 1;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) total[j] = t == 0 ? acc[j] : total[j] + acc[j];
          }
          float rv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rv[j] = (z_mask[k] >> j & 1u) ? dz[k][j] / fmaxf(total[j], eps) : 0.f;
          res = make_float4(rv[0], rv[1], rv[2], rv[3]);
        }
        *reinterpret_cast<float4*>(rp + at) = res;
        if (next_live) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dz[k][j] = (z_mask[k] >> j & 1u) ? data[next + z_off[k] + j] : 0.f;
        }
      }
      RL_ITER_TICK(1);
    };
    // I1, A.x: the slab of plane s, once it has landed, into xs.
    auto stage_x = [&]() {
      if (live) {
        if (kVec) mbar_wait(bar, (unsigned)s & 1u);
        RL_ITER_TICK(2);
        for (int x = x_first; x < kT * kNX; x += kThreads) {
          const int t = x / kNX, rest = x - t * kNX, r = rest / kXP, c4 = rest - r * kXP;
          const float4 v = x_window<kN4x>(reinterpret_cast<const float4*>(slab + r * kSw) + c4,
                                          taps + t * kTermTaps + kKxAt);
          *reinterpret_cast<float4*>(xs + t * kXsPlane + (kGuardRows + r) * kXw + 4 * c4) = v;
        }
      }
      RL_ITER_TICK(3);
    };
    stage_b();
    stage_z();
    stage_x();
    __syncthreads();
    RL_ITER_TICK(4);
    if (s + 1 < gz) request_slab(s + 1);
    RL_ITER_TICK(5);

    // I2, A.y: xs into ring A's slot of plane s (zeros past the grid).
    {
      const int slot = s % kSlots;
      for (int y = tid; y < kT * kNY; y += kThreads) {
        const int t = y / kNY, rest = y - t * kNY, rg = rest / kYC, c = 2 * (rest - rg * kYC);
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (live)
          y_window<kN4y, 2>(xs + t * kXsPlane + (kGuardRows + 4 * rg + 2 * kRy + 3) * kXw + c,
                            kXw, taps + t * kTermTaps + kKyAt, acc);
        float* dst = ring + (t * kSlots + slot) * kRingSlot + 4 * rg * kXw + c;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * rg + j < kMr)
            *reinterpret_cast<float2*>(dst + j * kXw) = make_float2(acc[0][j], acc[1][j]);
      }
    }
    RL_ITER_TICK(6);

    // I2, B.x: the adjoint x pass of the ratio into bx.
    for (int b = bx_first; b < kT * kNBX; b += kThreads) {
      const int t = b / kNBX, rest = b - t * kNBX, r = rest / kBXP, c4 = rest - r * kBXP;
      const float4 v = x_window<kN4x>(reinterpret_cast<const float4*>(rp + r * kXw) + c4,
                                      taps_adj + t * kTermTaps + kKxAt);
      *reinterpret_cast<float4*>(bx + t * kBxPlane + (kGuardRows + r) * kTx + 4 * c4) = v;
    }
    RL_ITER_TICK(7);
    if (!kVec) copies_wait();
    RL_ITER_TICK(8);
    __syncthreads();
    RL_ITER_TICK(9);
  }
#ifdef RL_ITER_PROFILE
  if (tid == 0)
    for (int k = 0; k < kStages; ++k)
      partials[kStages * (blockIdx.y * gridDim.x + blockIdx.x) + k] = (float)prof[k];
#endif
}

template <bool kVec>
int launch(const float* est, const float* data, float* out, const float* taps, float* partials,
           int gz, int gy, int gx, float eps, cudaStream_t stream) {
  const auto kernel = rl_iter_kernel<kVec>;
  const size_t smem = (size_t)kTotal * sizeof(float);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  CUtensorMap map = {};
  if (kVec) err = slab_map(&map, est, gz, gy, gx, kSr, kSw);
  if (err != 0) return err;
  dim3 grid((unsigned)((gx + kTx - 1) / kTx), (unsigned)((gy + kTy - 1) / kTy));
  kernel<<<grid, kThreads, smem, stream>>>(est, data, out, taps, partials, map, gz, gy, gx, eps);
  return (int)cudaGetLastError();
}
#endif  // RL_ITER_NKZ

}  // namespace

// Bytes of dynamic shared memory a block of the kernel takes with this
// geometry and tile (ops/rl_fused_iter.py::iter_smem_bytes is the same sum).
extern "C" int shrimpy_rl_iter_smem(int n_terms, int nkz, int nky, int nkx, int ty, int tx) {
  return layout_of(n_terms, nkz, nky, nkx, ty, tx).total * (int)sizeof(float);
}

#ifdef RL_ITER_NKZ
// taps: float32 [2][n_terms][round4(nkz) + window(nky) + window(nkx)], the
// convolution's then the adjoint's, each list padded as the kernel reads it
// (ops/rl_fused_iter.py::pack_taps). The geometry (n_terms .. tx) must be the
// one this library was compiled for. vec: gx % 4 == 0 and est 16-byte
// aligned. partials: the profile build's clocks, else unused (may be null).
extern "C" int shrimpy_rl_iter(const void* est, const void* data, void* out, const void* taps,
                               void* partials, int n_terms, int nkz, int nky, int nkx,
                               long long gz, long long gy, long long gx, int ty, int tx, int vec,
                               float eps, void* stream) {
  if (n_terms != kT || nkz != kNkz || nky != kNky || nkx != kNkx || ty != kTy || tx != kTx)
    return (int)cudaErrorInvalidValue;
  // A plane is indexed in 32 bits, and the grid's y extent is a launch's.
  if (gz < 1 || gy < 1 || gx < 1 || gz > INT_MAX || gy * gx > INT_MAX ||
      (gy + kTy - 1) / kTy > 65535)
    return (int)cudaErrorInvalidValue;
  return (vec ? launch<true> : launch<false>)(
      (const float*)est, (const float*)data, (float*)out, (const float*)taps, (float*)partials,
      (int)gz, (int)gy, (int)gx, eps, (cudaStream_t)stream);
}
#endif
