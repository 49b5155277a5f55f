// One Richardson-Lucy half-step in one launch: the zero-boundary separable
// 3-D convolution over T rank-1 terms and the RL epilogue, every per-axis
// intermediate in shared memory or registers.
//
//   out = epilogue(sum_t X_t Y_t Z_t in),  (A v)[n] = sum_i k[i] * v[n + r - i]
//
// on the exact (gz, gy, gx) G grid, zero outside it, float32 FMA. Modes:
//   plain:       out = conv
//   ratio:       out = aux / max(conv, eps)
//   mult:        out = aux * conv                      (out may be aux)
//   ratio_accel: as ratio, of y = max(in + alpha*dx, 0) formed as the tile is
//                loaded (in float32, dx bf16, alpha a device scalar)
//   mult_accel:  x_new = y * conv over x (= aux = out), dx = bf16(x_new - x)
//                over dx, g = bf16(x_new - y) over g, and one pair of partial
//                sums of g*g_prev and g*g a block (the wrapper adds them with
//                torch.sum: no float atomics, the same bits every run)
//
// Replaces the TPU kernel shrimpy_tpu/ops/rl_fused.py::_rl_fused_pass, which
// is one launch a half-step too; the first port (csrc/rl_fused.cu, kept for
// the geometries past this kernel's shared memory) took three launches a term
// and moved ~7 carry volumes a term where the function has to move 3.
//
// Bound on the card: bytes. The launch reads `in` and aux once and writes out
// once (three carries; the accelerated modes add the bf16 state), against
// ~60 FMAs a voxel. What the design does about it:
//   * A block owns a (ty, tx) column of the (y, x) plane with its y and x
//     halos and marches through z. A ring of 2 rz + 1 input planes of
//     (ty + 2ry) x (tx + 2rx) voxels stays in shared memory, and it is the
//     input's, so several terms share it. Per output plane and term: the z
//     pass over the ring, the y pass, the x pass into registers, where the
//     terms add up; then the epilogue. Two barriers a plane and term.
//   * The axes keep the order z, y, x and every output sums its taps in
//     ascending order from zero, so the result has the bits of the plain
//     version (ops/rl_fused.py::half_step_plain) on every tile.
//   * Halos are re-read on two axes only, (ty + 2ry)(tx + 2rx) / (ty tx) of a
//     carry, and neighbouring blocks that run together share them through L2.
//   * Loads run a plane ahead: the ring has one slot more than the z pass
//     reads. Where gx % 4 == 0 and the carries are 16-byte aligned, thread 0
//     asks the TMA engine for the whole slab of plane q + rz + 1 (one tensor-map
//     copy, reported to an mbarrier) before the passes of plane q, and the
//     block waits for it after the y pass. The map's fill outside the tensor is
//     zero, which is the zero boundary on all three axes: no bounds test, no
//     zeroing. Threads spend no instruction on the copy; with cp.async
//     (16 bytes a thread) the passes that followed the copies' issue ran at
//     half their speed. Other carries fall back to cp.async of 4 bytes with a
//     bounds mask a thread. The bf16 dx of ratio_accel goes beside the slab by
//     cp.async in either case: its rows of gx * 2 bytes are no multiple of 16,
//     which a tensor map needs; each thread then turns its own chunks into
//     y = max(x + alpha*dx, 0). aux (and the bf16 state of mult_accel) is
//     requested into registers a whole plane step before the epilogue reads it.
//   * The y pass gives a thread four rows by two columns from one walk down the
//     z pass's plane, the x pass four outputs of a row from whole 16-byte
//     pieces of the y pass's plane (which is laid out for that): eight and
//     sixteen FMAs a shared-memory load. A warp's epilogue reads aux and
//     writes out as whole rows of the tile.
//   * The x pass of a plane runs beside the z pass of the next, between the
//     same two barriers, and half the warps take them in the other order: the
//     z pass has no reuse to offer (one output plane a step, each ring value
//     used once, one 16-byte load for four FMAs) and is bound by shared-memory
//     bandwidth, the x pass by FMA issue.
//   * The geometry is the compiler's, not the launch's: the number of terms,
//     the three PSF lengths and the tile are macros (RL_HALF_TERMS, _NKZ, _NKY,
//     _NKX, _TY, _TX), and kernels/build.py compiles this file once for each
//     geometry that is run (seconds, at the first half-step with it, cached
//     beside the other kernels). So every PSF gets tap loops that unroll and
//     strides that are immediates, which a kernel that reads its geometry at
//     run time lacks (6.5 ms against 5.1 at the geometry below). Without the
//     macros the file gives only shrimpy_rl_half_smem.
//   * The z pass's share of a slab is the same for every warp (what is left of
//     the 16-byte chunks after the rounds that fill the block is cut into
//     single floats: a barrier waits for the slowest warp), and a thread keeps
//     its share of the planes before the newest in registers from step to step
//     (its share of a slab never changes, and a plane is read by nkz steps), as
//     many planes as ~54 registers hold: six of (9, 21, 21)'s eight, which
//     takes two thirds of the z pass's shared-memory reads away.
//
//   * Circular (RL_HALF_WRAP=1, mode plain only: conv3_circular, the TPU kernel
//     shrimpy_tpu/ops/conv3_pallas.py::_conv3_pallas_jit, which bakes every
//     term into one call too): v[m] = v[m mod n] on every axis, any radius.
//     The z wrap is the plane's index taken mod gz, so a block whose slab lies
//     in the grid in y and x (the rows and columns its outputs read) still
//     takes it by one TMA copy; a block whose slab crosses a seam, and every
//     block of a carry that is not 16-byte aligned or whose rows are no
//     multiple of 4, loads by cp.async at a true modulo of row and column (16
//     bytes a copy where gx % 4 == 0: a chunk then never straddles the x seam;
//     else 4). Only the loads differ from the zero boundary's build: the sums
//     and their order are the same, so the result has the bits of the
//     two-launch route (convzy.cu's circular march, then conv_x<true> of
//     rl_fused.cu), ops/conv3_cuda.py::conv3_circular_route.
//
// NVIDIA H100 80GB HBM3, 700 W, carry (136, 2908, 1620), PSF (9, 21, 21),
// mode ratio (profile_step.py --tiles): tile (32, 64) 4.6 ms, (64, 32) 5.4,
// (48, 32) 6.1, (24, 64) 6.1, (40, 32) 6.7, (16, 64) 7.2, (16, 32) 11.4,
// (8, 32) 21.7; the three launches of csrc/rl_fused.cu 11.2. PSF (9, 15, 15)
// on (32, 64) 4.4; (15, 21, 21) and (9, 31, 31), which fit (16, 64), 9.2 and
// 8.5. One block an SM (223 KB of shared memory, 16 warps):
// what binds it now is issue and latency in the y pass (11 of 16 warps have
// a piece of it) and the x pass (PERF.md has the stages' clocks,
// profile_step.py --stages).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "async_copy.cuh"
#include "stencil.cuh"

namespace {

// -DRL_HALF_PROFILE: thread 0 of every block adds up the clocks it spends in
// each stage of a plane step (kept in shared memory) and writes the ten sums
// to partials[10 * block ..]: 0 requesting the epilogue's operands, 1 the z
// pass, 2 its barrier, 3 the y pass, 4 waiting for the copies, 5 the second
// barrier, 6 the x pass and epilogue, 7 the set-up before the march, 8 the top
// of a step and the cp.async copies, 9 the TMA copy's issue. Thread 0 takes
// the z pass before the x pass. A build for profile_step.py --stages;
// mult_accel's sums are not written in it.
#ifdef RL_HALF_PROFILE
#define RL_HALF_TICK(k)                   \
  do {                                    \
    if (tid == 0) {                       \
      const long long now = clock64();    \
      prof[k] += now - t_last;            \
      t_last = now;                       \
    }                                     \
  } while (0)
#else
#define RL_HALF_TICK(k)
#endif

constexpr int kGuardRows = 4;  // rows of zeros before the z pass's plane
// A block: its threads (one block an SM) and the most 16-byte chunks of a slab
// a thread moves.
constexpr int kThreads = 512, kMaxChunks = 3;

enum Mode { kPlain = 0, kRatio = 1, kMult = 2, kRatioAccel = 3, kMultAccel = 4 };

// The slab of one input plane: rows y0 - ry .. y0 + ty + ry, columns from
// x0 - round4(rx) (so that a 16-byte chunk of the slab is one of the grid's)
// to x0 + tx + rx, rounded up to whole chunks.
struct Slab {
  int rxa, sw, sr, s, bs, shift;
};

__host__ __device__ constexpr Slab slab_of(int nky, int nkx, int ty, int tx) {
  const int ry = nky / 2, rx = nkx / 2;
  Slab g{};
  g.rxa = round4(rx);
  g.sw = round4(g.rxa + tx + rx);
  g.sr = ty + 2 * ry;
  g.s = round32(g.sr * g.sw);  // a slot of the ring starts at a multiple of 128 bytes
  // The y pass's output yb: column m of a row is slab column m + shift, placed
  // so that the round4(nkx + 3) sources of the x pass's four outputs at tile
  // columns c0 .. c0 + 3 are the whole 16-byte pieces m = c0 .. c0 + n4x - 1.
  const int n4x = round4(nkx + 3);
  g.bs = tx + n4x - 4;
  g.shift = (g.rxa - rx) - (n4x - (nkx + 3));
  return g;
}

// Floats of shared memory a block takes: the packed taps, the ring of 2 rz + 2
// slabs (the last one in flight), the z-pass plane (a slab after its guard
// rows), the y-pass plane of ty rows, half a slab for the bf16 dx in flight
// (ratio_accel), and the mbarrier of the bulk copies.
__host__ __device__ inline size_t half_smem_floats(int n_terms, int nkz, int nky, int nkx, int ty,
                                                   int tx) {
  const Slab g = slab_of(nky, nkx, ty, tx);
  return (size_t)round32(n_terms * term_tap_floats(nkz, nky, nkx)) + (size_t)(nkz + 2) * g.s +
         (size_t)kGuardRows * g.sw + (size_t)ty * g.bs + (size_t)g.s / 2 + 4;
}

#ifdef RL_HALF_NKZ
#ifndef RL_HALF_WRAP
#define RL_HALF_WRAP 0
#endif
// The geometry this build is for, and its boundary (zero, or circular).
struct Geo {
  static constexpr int n_terms = RL_HALF_TERMS, nkz = RL_HALF_NKZ, nky = RL_HALF_NKY,
                       nkx = RL_HALF_NKX, ty = RL_HALF_TY, tx = RL_HALF_TX;
  static constexpr bool wrap = RL_HALF_WRAP != 0;
};
constexpr Slab kSlab = slab_of(Geo::nky, Geo::nkx, Geo::ty, Geo::tx);
constexpr int kSlabFloats = kSlab.sr * kSlab.sw;
// 16-byte chunks of a slab a thread copies: chunk tid of every round of
// kThreads chunks.
constexpr int kChunks = (kSlab.s / 4 + kThreads - 1) / kThreads;

// A thread's share of a slab in the z pass: a chunk of each round that fills
// the block, and of what is left a float of each round of kThreads floats
// (the last of these rounds may not reach every thread).
constexpr int kChunkRounds = kSlabFloats / (4 * kThreads);
constexpr int kTailAt = 4 * kChunkRounds * kThreads;
constexpr int kTailRounds = (kSlabFloats - kTailAt + kThreads - 1) / kThreads;
struct Share {
  float4 c[kChunkRounds > 0 ? kChunkRounds : 1];
  float t[kTailRounds > 0 ? kTailRounds : 1];
};
// Planes before the newest whose share a thread keeps in registers for the z
// pass: what kKeepRegisters hold, the newest plane is always read from the
// ring. Half-step ms on an H100 at 700 W, PSF (9, 21, 21) on tile (32, 64)
// (9 registers a plane), by their number, 0 to 8: 5.11, 5.14, 4.93, 4.80,
// 4.71, 4.63, 4.58, 4.58, 4.60.
constexpr int kKeepRegisters = 54;
constexpr int kKeepFit = kKeepRegisters / (4 * kChunkRounds + kTailRounds);
constexpr int kKeep = kKeepFit < Geo::nkz - 1 ? kKeepFit : Geo::nkz - 1;
static_assert(kChunks <= kMaxChunks && kTailRounds <= 4, "the slab is past a block's share");

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ __nv_bfloat16 bf16_at(const uint2 d, int j) {
  const unsigned w = j < 2 ? d.x : d.y;
  return __ushort_as_bfloat16((unsigned short)((j & 1) ? (w >> 16) : (w & 0xffffu)));
}

__device__ __forceinline__ uint2 bf16_pack(const __nv_bfloat16 (&b)[4]) {
  uint2 d;
  d.x = (unsigned)__bfloat16_as_ushort(b[0]) | ((unsigned)__bfloat16_as_ushort(b[1]) << 16);
  d.y = (unsigned)__bfloat16_as_ushort(b[2]) | ((unsigned)__bfloat16_as_ushort(b[3]) << 16);
  return d;
}

// Four consecutive floats at p; `mask` bit j says element j exists (not 0).
// kVec: p is 16-byte aligned and the four exist together.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, unsigned mask) {
  if constexpr (kVec) return *reinterpret_cast<const float4*>(p);
  float4 v = zero4();
  if (mask & 1u) v.x = p[0];
  if (mask & 2u) v.y = p[1];
  if (mask & 4u) v.z = p[2];
  if (mask & 8u) v.w = p[3];
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float4 v, unsigned mask) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (mask & 1u) p[0] = v.x;
  if (mask & 2u) p[1] = v.y;
  if (mask & 4u) p[2] = v.z;
  if (mask & 8u) p[3] = v.w;
}

template <bool kVec>
__device__ __forceinline__ uint2 load4_bf16(const __nv_bfloat16* p, unsigned mask) {
  if constexpr (kVec) {
    return *reinterpret_cast<const uint2*>(p);
  } else {
    __nv_bfloat16 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = (mask >> j & 1u) ? p[j] : __ushort_as_bfloat16(0);
    return bf16_pack(b);
  }
}

template <bool kVec>
__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, const __nv_bfloat16 (&b)[4],
                                            unsigned mask) {
  if constexpr (kVec) {
    *reinterpret_cast<uint2*>(p) = bf16_pack(b);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mask >> j & 1u) p[j] = b[j];
  }
}

// Two columns of four rows of a plane with row stride sw, walking down: the
// rows at p, p - sw, p - 2 sw, p - 3 sw; p moves four rows down.
__device__ __forceinline__ void load_rows(float2 (&v)[4], const float*& p, int sw) {
#pragma unroll
  for (int d = 0; d < 4; ++d) v[d] = *reinterpret_cast<const float2*>(p - d * sw);
  p -= 4 * sw;
}

__device__ __forceinline__ void window_fma2(const float4 a, const float4 b, const float2 (&v)[4],
                                            float (&acc0)[4], float (&acc1)[4]) {
  const float v0[4] = {v[0].x, v[1].x, v[2].x, v[3].x};
  const float v1[4] = {v[0].y, v[1].y, v[2].y, v[3].y};
  window_fma(a, b, v0, acc0);
  window_fma(a, b, v1, acc1);
}

// kThreads threads, one block an SM, on the geometry of `Geo`. kVec: gx % 4 ==
// 0 and every carry pointer is 16-byte aligned, so a chunk lies in the grid
// whole or not at all and moves as one. kMultAccel: the mult_accel epilogue
// (the other four modes are told apart at run time). The instantiations keep
// the code of a plane step small: it is fetched anew every step.
template <bool kVec, bool kMultAccel>
__global__ void __launch_bounds__(kThreads, 1)
rl_half_kernel(const float* __restrict__ in, const float* aux, float* out, __nv_bfloat16* dx,
               __nv_bfloat16* g, const float* __restrict__ alpha_p, float* __restrict__ partials,
               const float* __restrict__ taps_g, const __grid_constant__ CUtensorMap in_map,
               int gz, int gy, int gx, int mode, float eps) {
  constexpr int n_terms = Geo::n_terms, nkz = Geo::nkz, nky = Geo::nky, nkx = Geo::nkx,
                ty = Geo::ty, tx = Geo::tx;
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int rz = nkz / 2, ry = nky / 2;
  constexpr Slab sl = kSlab;
  constexpr int s4 = sl.s >> 2, sw4 = sl.sw >> 2;
  constexpr int slots = nkz + 1;  // the ring: planes q - rz .. q + rz and the one in flight
  constexpr int term_taps = round4(nkz) + window_taps(nky) + window_taps(nkx);
  constexpr int ky_at = round4(nkz), kx_at = ky_at + window_taps(nky);
  constexpr int n4y = round4(nky + 3), n4x = round4(nkx + 3);
  float* taps = smem;                                     // [n_terms][kz | ky window | kx window]
  float4* ring = reinterpret_cast<float4*>(taps + round32(n_terms * term_taps));  // [slots][s]
  // The z pass's plane, sr x sw, after kGuardRows rows of zeros: the y pass's
  // window may start up to three rows below row 0, where it meets zero taps.
  float4* za = ring + (size_t)slots * s4 + kGuardRows * sw4;
  float* yb = reinterpret_cast<float*>(za + s4);          // the y pass's plane, ty x bs
  // ratio_accel only: the bf16 dx of the slab in flight, sr x sw.
  uint2* dxs = reinterpret_cast<uint2*>(yb + ty * sl.bs);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(dxs + s4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef RL_HALF_PROFILE
  __shared__ long long prof[10];
  if (tid == 0)
    for (int k = 0; k < 10; ++k) prof[k] = 0;
  long long t_last = clock64();
#endif
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;
  const long long plane = (long long)gy * gx;
  // The circular build runs mode plain alone: a constant mode lets the
  // compiler drop the epilogue's operands (registers the march needs).
  if (Geo::wrap) mode = kPlain;
  const bool accel_in = !kMultAccel && mode == kRatioAccel;
  const float alpha = (kMultAccel || accel_in) ? *alpha_p : 0.f;
  // The slab by one TMA copy: every block of the zero boundary's build; of
  // the circular one, the blocks whose outputs read rows and columns of the
  // grid alone (the columns of the slab past them meet zero taps).
  const bool tma = kVec && (!Geo::wrap || (y0 - ry >= 0 && y0 + ty + ry <= gy &&
                                          x0 - nkx / 2 >= 0 && x0 + tx + nkx / 2 <= gx));

  // The chunks of every input plane that are this thread's in the z pass, in
  // the cp.async copies and in ratio_accel's extrapolation: chunk tid + j *
  // kThreads of the slab, at goff[j] in the plane; bit e of nibble j of cmask
  // says that element e lies in the grid. Without the TMA copy a chunk outside
  // the grid, zero in every plane, is zeroed once, in every slot, and never
  // copied.
  // Circular: every element lies in the grid (its offsets are formed where
  // a seam block copies, not kept: see the copies below).
  int goff[kChunks];
  unsigned cmask = 0;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int cid = tid + j * kThreads;
    goff[j] = 0;
    if (cid < s4) {
      const int row = cid / sw4, cc = cid - row * sw4;
      const int y = y0 - ry + row, x = x0 - sl.rxa + 4 * cc;
      goff[j] = y * gx + x;
      if (Geo::wrap) {
        cmask |= 15u << (4 * j);
      } else if (y >= 0 && y < gy) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x + e >= 0 && x + e < gx) cmask |= 1u << (4 * j + e);
      }
      if (!kVec && ((cmask >> (4 * j)) & 15u) == 0u)
        for (int sidx = 0; sidx < slots; ++sidx) ring[(size_t)sidx * s4 + cid] = zero4();
    }
  }
  for (int i = tid; i < n_terms * term_taps; i += kThreads) taps[i] = taps_g[i];
  // kVec: the TMA engine copies the slab of every plane instead, the zeros
  // outside the grid (planes outside [0, gz) too) included.
  const unsigned box_bytes = 4u * (unsigned)(sl.sr * sl.sw);
  unsigned parity = 0;
  if (kVec && tid == 0) {
    mbar_init(bar, 1);
  }

  // The y pass gives a thread four rows by two columns of yb from one walk
  // down the z pass's plane: rows y_r .. y_r + 3, slab columns y_c, y_c + 1,
  // which are yb's columns y_m, y_m + 1 (written where they lie in yb).
  const int sw2 = sl.sw >> 1;
  const int y_rg = tid / sw2, y_c = (tid - y_rg * sw2) << 1, y_r = y_rg << 2;
  const bool y_on = y_r < ty;
  const int y_m = y_c - sl.shift;
  const bool y_w0 = y_m >= 0 && y_m < sl.bs, y_w1 = y_m + 1 >= 0 && y_m + 1 < sl.bs;
  // The x pass gives it four outputs of one row, tile columns 4 x_c4 .. + 3,
  // from the n4x / 4 pieces of yb that start at piece x_c4 of that row: at
  // xoff in yb and eoff in a plane of the grid; bit e of emask says that
  // output e lies in the grid.
  const int tx4 = tx >> 2;
  const int x_row = tid / tx4, x_c4 = tid - x_row * tx4;
  const int xoff = x_row * sl.bs + (x_c4 << 2);
  const int eoff = (y0 + x_row) * gx + x0 + (x_c4 << 2);
  unsigned emask = 0;
  if (x_row < ty && y0 + x_row < gy) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (x0 + (x_c4 << 2) + e < gx) emask |= 1u << e;
  }
  // Columns of yb that the y pass never writes meet only zero taps, as do the
  // guard rows.
  for (int i = tid; i < ty * sl.bs; i += kThreads) yb[i] = 0.f;
  for (int i = tid; i < kGuardRows * sw4; i += kThreads) za[i - kGuardRows * sw4] = zero4();
  float s_num = 0.f, s_den = 0.f;
  RL_HALF_TICK(7);

  // The x pass of a plane and term runs one section late, beside the z pass of
  // the next: both need only the barrier before them, the z pass is bound by
  // shared-memory bandwidth and the x pass by FMA issue, so half of each
  // scheduler's warps take the x pass first and half the z pass, and the two
  // overlap. pend_q, pend_t: the plane and term whose x pass is pending; av,
  // dv, gv: the epilogue's operands of that plane, requested a section ahead;
  // total: the terms' sum so far.
  const bool x_first = (warp >> 2) & 1;
  int pend_q = -1, pend_t = 0;
  float4 av = zero4();
  uint2 dv = make_uint2(0u, 0u), gv = make_uint2(0u, 0u);
  float total[4] = {0.f, 0.f, 0.f, 0.f};

  auto request = [&](int q) {
    if (emask == 0u) return;
    const long long e0 = (long long)q * plane + eoff;
    if (kMultAccel || mode != kPlain) av = load4<kVec>(aux + e0, emask);
    if (kMultAccel) {
      dv = load4_bf16<kVec>(dx + e0, emask);
      gv = load4_bf16<kVec>(g + e0, emask);
    }
  };

  // z: za = sum_i kz[i] * plane (q + rz - i), plane q + rz in slot `newest`.
  // A thread sums its Share of the slab, the same for every warp (chunk by
  // chunk, some warps would take a chunk more than others, and a barrier waits
  // for the slowest). It keeps its share of the kKeep planes before the newest
  // in registers from one plane step to the next (a plane is read by nkz
  // steps) and reads those from there, the others from the ring. `shift`: the
  // step's last term, after which the kept planes move on by one.
  Share kept[kKeep > 0 ? kKeep : 1];
  bool primed = false;
  auto z_pass = [&](const float* kt, int newest, bool shift) {
    auto load = [&](int slot) {
      const float4* pl = ring + (size_t)slot * s4;
      Share v;
#pragma unroll
      for (int j = 0; j < kChunkRounds; ++j) v.c[j] = pl[tid + j * kThreads];
#pragma unroll
      for (int j = 0; j < kTailRounds; ++j) {
        const int at = kTailAt + j * kThreads + tid;
        v.t[j] = at < kSlabFloats ? reinterpret_cast<const float*>(pl)[at] : 0.f;
      }
      return v;
    };
    auto back = [&](int slot, int n) {  // the slot of the plane n before `slot`'s
      slot -= n;
      return slot < 0 ? slot + slots : slot;
    };
    Share acc;
#pragma unroll
    for (int j = 0; j < kChunkRounds; ++j) acc.c[j] = zero4();
#pragma unroll
    for (int j = 0; j < kTailRounds; ++j) acc.t[j] = 0.f;
    auto add = [&](float tap, const Share& v) {
#pragma unroll
      for (int j = 0; j < kChunkRounds; ++j) {
        acc.c[j].x = fmaf(tap, v.c[j].x, acc.c[j].x);
        acc.c[j].y = fmaf(tap, v.c[j].y, acc.c[j].y);
        acc.c[j].z = fmaf(tap, v.c[j].z, acc.c[j].z);
        acc.c[j].w = fmaf(tap, v.c[j].w, acc.c[j].w);
      }
#pragma unroll
      for (int j = 0; j < kTailRounds; ++j) acc.t[j] = fmaf(tap, v.t[j], acc.t[j]);
    };
    if (kKeep > 0 && !primed) {
#pragma unroll
      for (int k = 0; k < kKeep; ++k) kept[k] = load(back(newest, k + 1));
      primed = true;
    }
    const Share fresh = load(newest);
    add(kt[0], fresh);
#pragma unroll
    for (int k = 0; k < kKeep; ++k) add(kt[k + 1], kept[k]);
    if (kKeep > 0 && shift) {
#pragma unroll
      for (int k = kKeep - 1; k > 0; --k) kept[k] = kept[k - 1];
      kept[0] = fresh;
    }
    int slot = back(newest, kKeep + 1);
    for (int i = kKeep + 1; i < nkz; ++i) {
      add(kt[i], load(slot));
      slot = slot == 0 ? slots - 1 : slot - 1;
    }
#pragma unroll
    for (int j = 0; j < kChunkRounds; ++j) za[tid + j * kThreads] = acc.c[j];
#pragma unroll
    for (int j = 0; j < kTailRounds; ++j) {
      const int at = kTailAt + j * kThreads + tid;
      if (at < kSlabFloats) reinterpret_cast<float*>(za)[at] = acc.t[j];
    }
  };

  // x of the pending plane and term, from yb into registers, where the terms
  // add up; after the last term the epilogue.
  auto x_pass = [&]() {
    if (pend_q < 0 || emask == 0u) return;
    const float* kt = taps + pend_t * term_taps;
    const float4* yr = reinterpret_cast<const float4*>(yb + xoff);
    const float4* tp4 = reinterpret_cast<const float4*>(kt + kx_at);
    const int ng = n4x >> 2;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float4 ta = tp4[0], tb = tp4[1];
    float4 v = yr[ng - 1];
    for (int gi = 1; gi < ng; ++gi) {
      const float4 vn = yr[ng - 1 - gi];
      const float4 tn = tp4[gi + 1];
      const float vd[4] = {v.w, v.z, v.y, v.x};
      window_fma(ta, tb, vd, acc);
      v = vn;
      ta = tb;
      tb = tn;
    }
    {
      const float vd[4] = {v.w, v.z, v.y, v.x};
      window_fma(ta, tb, vd, acc);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) total[j] = pend_t == 0 ? acc[j] : total[j] + acc[j];
    if (pend_t != n_terms - 1) return;
    const long long e0 = (long long)pend_q * plane + eoff;
    const float a4[4] = {av.x, av.y, av.z, av.w};
    float o[4];
    if (kMultAccel) {
      __nv_bfloat16 nd[4], ng4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xo = a4[j];
        const float yv = extrapolate(xo, bf16_at(dv, j), alpha);
        const float xn = __fmul_rn(yv, total[j]);
        ng4[j] = __float2bfloat16_rn(__fsub_rn(xn, yv));
        nd[j] = __float2bfloat16_rn(__fsub_rn(xn, xo));
        o[j] = xn;
        if (emask >> j & 1u) {
          const float gf = __bfloat162float(ng4[j]);
          s_num = fmaf(gf, __bfloat162float(bf16_at(gv, j)), s_num);
          s_den = fmaf(gf, gf, s_den);
        }
      }
      store4_bf16<kVec>(dx + e0, nd, emask);
      store4_bf16<kVec>(g + e0, ng4, emask);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = total[j];
        o[j] = (mode == kRatio || mode == kRatioAccel) ? a4[j] / fmaxf(c, eps)
               : mode == kMult                         ? a4[j] * c
                                                       : c;
      }
    }
    store4<kVec>(out + e0, make_float4(o[0], o[1], o[2], o[3]), emask);
  };

  // Plane p sits in slot (p + rz) mod slots. Step q copies plane q + rz + 1
  // into the slot that plane q - rz - 1 left and computes output plane q; the
  // steps q < 0 only fill the ring (planes outside [0, gz) are zero).
  int newest = slots - 1;  // slot of plane q + rz; the first step's plane -rz goes to slot 0
  if (kVec) fence_async_smem();
  __syncthreads();  // the zeros and the mbarrier are there before the first copy
  for (int q = -nkz; q < gz; ++q) {
    const int incoming = newest + 1 == slots ? 0 : newest + 1;
    const int p_in = Geo::wrap ? wrap_index(q + rz + 1, gz) : q + rz + 1;
    const bool live = p_in >= 0 && p_in < gz;
    {
      const long long base = (long long)p_in * plane;
      float4* dst = ring + (size_t)incoming * s4;
      if (Geo::wrap && !tma) {
        // A seam block: the chunk's row and columns at a true modulo, formed
        // here (kept in registers through the march, they cost the other
        // blocks spills).
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int cid = tid + j * kThreads;
          if (cid >= s4) continue;
          const int row = cid / sw4, x = x0 - sl.rxa + 4 * (cid - row * sw4);
          const float* src = in + base + (long long)wrap_index(y0 - ry + row, gy) * gx;
          if (kVec) {
            copy16z(dst + cid, src + wrap_index(x, gx), true);
          } else {
            float* d = reinterpret_cast<float*>(dst + cid);
#pragma unroll
            for (int e = 0; e < 4; ++e) copy_async4(d + e, src + wrap_index(x + e, gx));
          }
        }
      } else if (!kVec || (accel_in && live)) {
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int cid = tid + j * kThreads;
          const unsigned m = (cmask >> (4 * j)) & 15u;
          if (cid >= s4 || m == 0u) continue;
          if (kVec) {
            copy_async8(dxs + cid, dx + base + goff[j]);
          } else if (!live) {
            dst[cid] = zero4();
          } else {
            float* d = reinterpret_cast<float*>(dst + cid);
            __nv_bfloat16 b[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              b[e] = __ushort_as_bfloat16(0);
              if (m >> e & 1u) {
                copy_async4(d + e, in + base + goff[j] + e);
                if (accel_in) b[e] = dx[base + goff[j] + e];
              } else {
                d[e] = 0.f;
              }
            }
            if (accel_in) dxs[cid] = bf16_pack(b);
          }
        }
      }
      RL_HALF_TICK(8);
      if (tma && tid == 0) {
        mbar_expect(bar, box_bytes);
        tma_load_3d(dst, &in_map, x0 - sl.rxa, y0 - ry, p_in, bar);
      }
      copies_commit();
      RL_HALF_TICK(9);
    }
    for (int t = 0; t < n_terms; ++t) {
      const float* kt = taps + t * term_taps;
      if (q >= 0) {
        if (x_first) {
          x_pass();
          RL_HALF_TICK(6);
          z_pass(kt, newest, t == n_terms - 1);
          RL_HALF_TICK(1);
        } else {
          z_pass(kt, newest, t == n_terms - 1);
          RL_HALF_TICK(1);
          x_pass();
          RL_HALF_TICK(6);
        }
        // The pending x pass was the last to read the operands of its plane:
        // request this plane's, a section before its x pass reads them.
        if (t == 0) request(q);
        RL_HALF_TICK(0);
      }
      __syncthreads();
      RL_HALF_TICK(2);
      if (q >= 0 && y_on) {
        // y: yb[r][c - shift] = sum_i ky[i] * za[r + 2ry - i][c]. The window
        // walks down from row y_r + 2ry + 3, four rows a group, the next
        // group's rows requested before the FMAs of this one. Group k meets
        // the taps tp4[k], tp4[k + 1]; the rows of the last group may lie in
        // the guard rows below row 0 (zero taps).
        const float* zp = reinterpret_cast<const float*>(za) + (y_r + nky + 2) * sl.sw + y_c;
        const float4* tp4 = reinterpret_cast<const float4*>(kt + ky_at);
        const int ng = n4y >> 2;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        float2 va[4], vb[4];
        load_rows(va, zp, sl.sw);
        int k = 0;
        for (; k + 2 < ng; k += 2) {
          load_rows(vb, zp, sl.sw);
          const float4 t1 = tp4[k + 1];
          window_fma2(tp4[k], t1, va, a0, a1);
          load_rows(va, zp, sl.sw);
          window_fma2(t1, tp4[k + 2], vb, a0, a1);
        }
        if (k + 1 < ng) {
          load_rows(vb, zp, sl.sw);
          const float4 t1 = tp4[k + 1];
          window_fma2(tp4[k], t1, va, a0, a1);
          window_fma2(t1, tp4[k + 2], vb, a0, a1);
        } else {
          window_fma2(tp4[k], tp4[k + 1], va, a0, a1);
        }
        float* yo = yb + y_r * sl.bs + y_m;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (y_w0) yo[j * sl.bs] = a0[j];
          if (y_w1) yo[j * sl.bs + 1] = a1[j];
        }
      }
      RL_HALF_TICK(3);
      if (t == n_terms - 1) {
        // The plane in flight has had the z and y passes to arrive. With
        // ratio_accel the thread turns its chunks of it from x into
        // y = max(x + alpha*dx, 0) (outside the grid x = dx = 0 gives 0). The
        // barrier publishes the plane to the next step's z pass.
        copies_wait();
        if (tma) {
          mbar_wait(bar, parity);
          parity ^= 1u;
        }
        if (accel_in && live) {
          float4* dst = ring + (size_t)incoming * s4;
#pragma unroll
          for (int j = 0; j < kChunks; ++j) {
            const int cid = tid + j * kThreads;
            if (cid >= s4 || ((cmask >> (4 * j)) & 15u) == 0u) continue;
            float4 v = dst[cid];
            const uint2 d = dxs[cid];
            v.x = extrapolate(v.x, bf16_at(d, 0), alpha);
            v.y = extrapolate(v.y, bf16_at(d, 1), alpha);
            v.z = extrapolate(v.z, bf16_at(d, 2), alpha);
            v.w = extrapolate(v.w, bf16_at(d, 3), alpha);
            dst[cid] = v;
          }
        }
      }
      RL_HALF_TICK(4);
      // ratio_accel wrote the plane that arrived; the engine writes that slot
      // again nkz steps on.
      if (kVec && accel_in) fence_async_smem();
      __syncthreads();
      RL_HALF_TICK(5);
      if (q >= 0) {
        pend_q = q;
        pend_t = t;
      }
    }
    newest = incoming;
  }
  x_pass();
#ifdef RL_HALF_PROFILE
  if (tid == 0)
    for (int k = 0; k < 10; ++k)
      partials[10 * (blockIdx.y * gridDim.x + blockIdx.x) + k] = (float)prof[k];
  return;
#endif

  if (kMultAccel) {
    // One pair a block, in a fixed order: warp shuffles, then warp 0 in order.
    for (int off = 16; off > 0; off >>= 1) {
      s_num += __shfl_down_sync(0xffffffffu, s_num, off);
      s_den += __shfl_down_sync(0xffffffffu, s_den, off);
    }
    __syncthreads();  // every y pass has read za: it now holds the warps' sums
    float* red = reinterpret_cast<float*>(za);
    if (lane == 0) {
      red[warp] = s_num;
      red[kThreads / 32 + warp] = s_den;
    }
    __syncthreads();
    if (tid == 0) {
      float t_num = 0.f, t_den = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        t_num += red[w];
        t_den += red[kThreads / 32 + w];
      }
      const int b = blockIdx.y * gridDim.x + blockIdx.x, nb = gridDim.x * gridDim.y;
      partials[b] = t_num;
      partials[nb + b] = t_den;
    }
  }
}

// What a block's threads can take of the tile: a TMA box of at most 256 rows
// and columns, one 4-row x 2-column piece of the y pass and one 4-output piece
// of the x pass a thread (ops/rl_fused.py::half_layout checks the same).
static_assert(Geo::ty % 4 == 0 && Geo::tx % 4 == 0 && kSlab.sr <= 256 && kSlab.sw <= 256 &&
                  (Geo::ty / 4) * (kSlab.sw / 2) <= kThreads &&
                  Geo::ty * (Geo::tx / 4) <= kThreads,
              "the tile does not fit a block");

template <bool kVec, bool kMultAccel>
int launch(const float* in, const float* aux, float* out, __nv_bfloat16* dx, __nv_bfloat16* g,
           const float* alpha, float* partials, const float* taps, int gz, int gy, int gx,
           int mode, float eps, cudaStream_t stream) {
  const auto kernel = rl_half_kernel<kVec, kMultAccel>;
  const size_t smem = half_smem_floats(Geo::n_terms, Geo::nkz, Geo::nky, Geo::nkx, Geo::ty,
                                       Geo::tx) * sizeof(float);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  CUtensorMap in_map = {};
  if (kVec) err = slab_map(&in_map, in, gz, gy, gx, kSlab.sr, kSlab.sw);
  if (err != 0) return err;
  dim3 grid((unsigned)((gx + Geo::tx - 1) / Geo::tx), (unsigned)((gy + Geo::ty - 1) / Geo::ty));
  kernel<<<grid, kThreads, smem, stream>>>(in, aux, out, dx, g, alpha, partials, taps, in_map, gz,
                                           gy, gx, mode, eps);
  return (int)cudaGetLastError();
}
#endif  // RL_HALF_NKZ

}  // namespace

// Bytes of dynamic shared memory a block of the kernel takes with this
// geometry and tile (ops/rl_fused.py::half_smem_bytes is the same sum).
extern "C" int shrimpy_rl_half_smem(int n_terms, int nkz, int nky, int nkx, int ty, int tx) {
  return (int)(half_smem_floats(n_terms, nkz, nky, nkx, ty, tx) * sizeof(float));
}

#ifdef RL_HALF_NKZ
// taps: float32 [n_terms][round4(nkz) + window(nky) + window(nkx)], each list
// padded as the kernel reads it (ops/rl_fused.py::Stencil.packed). The geometry
// (n_terms .. tx) must be the one this library was compiled for; a circular
// build (RL_HALF_WRAP=1) takes mode plain alone. mode: 0
// plain, 1 ratio, 2 mult, 3 ratio_accel (dx, alpha), 4 mult_accel (aux = out =
// x; dx, g, alpha, partials of 2 x blocks floats). vec: gx % 4 == 0 and every
// carry pointer 16-byte aligned. A block has 512 threads.
extern "C" int shrimpy_rl_half(const void* in, const void* aux, void* out, void* dx, void* g,
                               const void* alpha, void* partials, const void* taps, int n_terms,
                               int nkz, int nky, int nkx, long long gz, long long gy, long long gx,
                               int ty, int tx, int mode, int vec, float eps, void* stream) {
  if (n_terms != Geo::n_terms || nkz != Geo::nkz || nky != Geo::nky || nkx != Geo::nkx ||
      ty != Geo::ty || tx != Geo::tx || (Geo::wrap && mode != kPlain))
    return (int)cudaErrorInvalidValue;
  // A plane is indexed in 32 bits, and the grid's y extent is a launch's.
  if (gz < 1 || gy < 1 || gx < 1 || gz > INT_MAX || gy * gx > INT_MAX ||
      (gy + ty - 1) / ty > 65535)
    return (int)cudaErrorInvalidValue;
  const auto run = mode == kMultAccel ? (vec ? launch<true, true> : launch<false, true>)
                                      : (vec ? launch<true, false> : launch<false, false>);
  return run((const float*)in, (const float*)aux, (float*)out, (__nv_bfloat16*)dx,
             (__nv_bfloat16*)g, (const float*)alpha, (float*)partials, (const float*)taps,
             (int)gz, (int)gy, (int)gx, mode, eps, (cudaStream_t)stream);
}
#endif
