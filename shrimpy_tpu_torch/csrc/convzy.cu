// z+y convolution of one separable term, one launch that marches through z:
//
//   out = Y Z v,   (A v)[n] = sum_i k[i] * v[n + r - i]
//
// on the exact (gz, gy, gx) G grid, float32 FMA, with v zero outside the grid
// (CONVZY_WRAP 0, the zero boundary of linear_pallas) or circular, v[m] =
// v[m mod n] (CONVZY_WRAP 1, zy_pallas and conv3_circular; any radius, also
// r >= n). The x axis and the RL epilogue follow in conv_x_kernel
// (csrc/rl_fused.cu), launched by ops/conv3_cuda.py::conv3_half_step_cuda.
//
// Replaces two TPU kernels of shrimpy_tpu/ops/conv3_pallas.py, both z taps on
// the VPU and a banded-y MXU dot: _convzy_linear_jit (over the permanently
// zero-padded carry of lp_layout, whose 8/128-row pads keep DMA starts
// tile-aligned) and _convzy_pallas_jit (over a carry wrap-padded by the radii
// on every call). Neither layout is ported: the carry stays on the exact G
// grid, and a block fills or wraps its own edges.
//
// Bound on the card: bytes, one carry read and one written (1.530 ms at the
// production carry (136, 2908, 1620) on an H100 at 3.35 TB/s), against 9 + 21
// FMAs a voxel with the PSF (9, 21, 21). What the design does about it (the
// march of csrc/rl_half.cu, for z and y only):
//   * A block owns a (ty, tx) column of the (y, x) plane and marches through
//     z. It needs no x halo: the step convolves z and y only, so neighbouring
//     x tiles share no input. A ring of 2 rz + 1 + kDepth input slabs of
//     (ty + 2 ry) x tx floats stays in shared memory, the last kDepth in
//     flight: each input plane is read from device memory once per column
//     of blocks (the y halo once more, through L2, by the blocks above and
//     below).
//   * The slab of plane q + rz + kDepth is requested before the passes of
//     plane q, so kDepth planes are in flight while a block computes: with
//     one, a block waits out the latency of each copy (at the production
//     carry on an NVIDIA H100 80GB HBM3 at 700 W, profile_step.py --tiles,
//     the times in this header: 3.09 ms with one plane in flight, 2.61
//     with two, 2.46 with three, no gain past it). Where gx % 4 == 0 and
//     the carry is 16-byte aligned, thread 0 asks the TMA engine for the
//     slab (one tensor-map copy reported to the slot's mbarrier), and the
//     map's zero fill outside the tensor is the zero boundary on both axes.
//     Circular: the z wrap is the plane's index taken mod gz, so the copy is
//     the same; a block whose slab reaches past the top or bottom of the grid
//     in y, a grid smaller than the slab, and carries that are not 16-byte
//     aligned load by cp.async (16 bytes a thread where the rows allow, else
//     4) with the row at a true modulo (wrapped) or zero-filled: only those
//     blocks pay for it.
//   * z pass: a thread sums its share of the slab, the same for every warp,
//     over the 2 rz + 1 planes, and keeps its share of the planes before the
//     newest in registers from step to step (a plane is read by nkz steps), so
//     a step reads only the newest plane from shared memory where the
//     registers hold the rest (they do at the production geometry: 48 of
//     64 registers; with 36, 2.50 ms).
//   * y pass: a thread makes four rows of one column from one walk down the z
//     pass's plane (a register window: 4 + 2 ry loads for 4 (2 ry + 1) FMAs)
//     and writes them; a warp writes whole rows of the tile.
//   * The y pass of plane q - 1 runs beside the z pass of plane q, before the
//     one barrier of a step: the z pass's plane is double-buffered. Half the
//     warps take the y pass first, so that the z pass's shared-memory reads
//     and the y pass's FMAs overlap (2.46 ms, against 2.78 with every warp
//     taking the z pass first and 2.71 the y pass first).
//   * Every output sums its z taps, then its y taps, in ascending order from
//     zero with one fmaf each, so the result has the bits of the plain
//     versions (ops/conv3_cuda.py::convzy_linear_plain, convzy_circular_plain)
//     on every tile and boundary.
//   * The geometry is the compiler's: the two tap lengths, the tile and the
//     boundary are macros (CONVZY_NKZ, _NKY, _TY, _TX, _WRAP), and
//     kernels/build.py compiles this file once for each geometry that is run.
//     Without the macros the file gives only shrimpy_convzy_smem. Radii whose
//     ring fits no tile run as two single-axis passes of conv_axis_kernel
//     (csrc/rl_fused.cu, ops/conv3_cuda.py::convzy_route).
// What is left: 2.46 ms at 1.6x the bound (tile (64, 32), 151,904 bytes, one
// block of 16 warps an SM). A circular block also reads the 2 rz planes its z
// wrap brings in, where the zero boundary's are the map's zero fill: 2.69 ms.
// In a -DCONVZY_PROFILE build thread 0 spends a plane step in its z pass
// (with the other warps' y passes beside it), then its y pass, the copy's
// issue, its wait and the barrier, in that order of size (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>

#include "async_copy.cuh"
#include "stencil.cuh"

namespace {

constexpr int kThreads = 512;  // a block: one an SM
constexpr int kGuardRows = 4;  // rows of zeros before the z pass's plane
constexpr int kDepth = 3;      // planes in flight ahead of the newest the z pass reads

// -DCONVZY_PROFILE: thread 0 of every block adds up the clocks it spends in
// each stage of a plane step and writes the sums to clocks[kStages * block ..]:
// 0 the set-up before the march, 1 the copy's issue, 2 the z pass, 3 the y
// pass, 4 waiting for the copy, 5 the barrier. Thread 0 takes the z pass
// first. A build for profile_step.py --stages.
#ifdef CONVZY_PROFILE
constexpr int kStages = 6;
#define CONVZY_TICK(k)                  \
  do {                                  \
    if (tid == 0) {                     \
      const long long now = clock64();  \
      prof[k] += now - t_last;          \
      t_last = now;                     \
    }                                   \
  } while (0)
#else
#define CONVZY_TICK(k)
#endif

// Floats of one input slab: the tile's rows with their y halos, tx columns.
__host__ __device__ constexpr int slab_floats(int nky, int ty, int tx) {
  return (ty + 2 * (nky / 2)) * tx;
}

// Floats of shared memory a block takes: the taps (kz padded to a multiple of
// 4, then the ky window), the ring of nkz + kDepth slabs, two z-pass planes
// after their guard rows, each region a multiple of 128 bytes, and an
// mbarrier a slot.
__host__ __device__ inline size_t convzy_smem_floats(int nkz, int nky, int ty, int tx) {
  const int s = slab_floats(nky, ty, tx);
  return (size_t)round32(round4(nkz) + window_taps(nky)) + (size_t)(nkz + kDepth) * round32(s) +
         2 * (size_t)round32(kGuardRows * tx + s) + round4(2 * (nkz + kDepth));
}

#ifdef CONVZY_NKZ
// The geometry this build is for.
struct Geo {
  static constexpr int nkz = CONVZY_NKZ, nky = CONVZY_NKY, ty = CONVZY_TY, tx = CONVZY_TX;
  static constexpr bool wrap = CONVZY_WRAP != 0;
};
constexpr int kSlab = slab_floats(Geo::nky, Geo::ty, Geo::tx);
constexpr int kSlot = round32(kSlab);                        // floats of a ring slot
constexpr int kZa = round32(kGuardRows * Geo::tx + kSlab);   // floats of a z-pass plane

// A thread's share of a slab in the z pass: a float4 of each round that fills
// the block, and of what is left a float of each round of kThreads floats.
constexpr int kChunkRounds = kSlab / (4 * kThreads);
constexpr int kTailAt = 4 * kChunkRounds * kThreads;
constexpr int kTailRounds = (kSlab - kTailAt + kThreads - 1) / kThreads;
struct Share {
  float4 c[kChunkRounds > 0 ? kChunkRounds : 1];
  float t[kTailRounds > 0 ? kTailRounds : 1];
};
// Planes before the newest whose share a thread keeps in registers: what
// kKeepRegisters hold, at most all of them.
constexpr int kKeepRegisters = 64;
constexpr int kKeepFit = kKeepRegisters / (4 * kChunkRounds + kTailRounds);
constexpr int kKeep = kKeepFit < Geo::nkz - 1 ? kKeepFit : Geo::nkz - 1;

// What a block's threads can take of the tile: a TMA box of at most 256 rows
// and columns, one 4-row piece of the y pass a thread
// (ops/conv3_cuda.py::convzy_layout checks the same).
static_assert(Geo::ty % 4 == 0 && Geo::tx % 4 == 0 && Geo::ty + 2 * (Geo::nky / 2) <= 256 &&
                  Geo::tx <= 256 && (Geo::ty / 4) * Geo::tx <= kThreads && kTailRounds <= 4,
              "the tile does not fit a block");

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// kVec: gx % 4 == 0 and the carry is 16-byte aligned (the slab by TMA, or by
// 16-byte cp.async in the blocks that wrap in y).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
convzy_kernel(const float* __restrict__ in, float* __restrict__ out,
              const float* __restrict__ taps_g, const __grid_constant__ CUtensorMap in_map,
              int gz, int gy, int gx, float* __restrict__ clocks) {
  constexpr int nkz = Geo::nkz, nky = Geo::nky, ty = Geo::ty, tx = Geo::tx;
  constexpr int rz = nkz / 2, ry = nky / 2;
  constexpr int slots = nkz + kDepth;  // the ring: planes q - rz .. q + rz and those in flight
  constexpr int ky_at = round4(nkz), n_taps = ky_at + window_taps(nky);
  constexpr int s4 = kSlot / 4;
  extern __shared__ __align__(128) float4 smem4[];
  float* taps = reinterpret_cast<float*>(smem4);                          // kz | ky window
  float4* ring = reinterpret_cast<float4*>(taps + round32(n_taps));       // [slots][kSlot]
  float* za_buf = reinterpret_cast<float*>(ring + (size_t)slots * s4);    // [2][kZa]
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(za_buf + 2 * kZa);  // [slots]

  const int tid = threadIdx.x, warp = tid >> 5;
#ifdef CONVZY_PROFILE
  __shared__ long long prof[kStages];
  if (tid == 0)
    for (int k = 0; k < kStages; ++k) prof[k] = 0;
  long long t_last = clock64();
#endif
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;
  const long long plane = (long long)gy * gx;
  // The slab by one TMA copy where it lies in the grid in y or the boundary
  // is zero there; else by cp.async, row by row at a true modulo.
  const bool tma = kVec && (!Geo::wrap || (y0 - ry >= 0 && y0 + ty + ry <= gy));

  for (int i = tid; i < n_taps; i += kThreads) taps[i] = taps_g[i];
  for (int i = tid; i < kGuardRows * tx; i += kThreads) za_buf[i] = za_buf[kZa + i] = 0.f;
  if (tma && tid < slots) mbar_init(bar + tid, 1);

  // The y pass: rows 4 y_rg .. 4 y_rg + 3 of the tile, column y_c; bit j of
  // ymask says that output j lies in the grid.
  const int y_rg = tid / tx, y_c = tid - y_rg * tx;
  unsigned ymask = 0;
  if (y_rg < ty / 4 && x0 + y_c < gx) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (y0 + 4 * y_rg + j < gy) ymask |= 1u << j;
  }
  const long long yoff = (long long)(y0 + 4 * y_rg) * gx + x0 + y_c;

  // Plane p (p >= -rz) sits in slot (p + rz) mod slots, filled for the
  // ((p + rz) / slots)-th time: the parity its mbarrier completes.
  auto slot_of = [](int p) { return (p + rz) % slots; };
  // Plane p into its slot: its index wrapped (circular) or the slab zero
  // outside [0, gz) (zero boundary).
  auto issue = [&](int p) {
    float4* dst = ring + (size_t)slot_of(p) * s4;
    const bool live = Geo::wrap || (p >= 0 && p < gz);
    const int pz = Geo::wrap ? wrap_index(p, gz) : p;
    if (tma) {
      if (tid == 0) {
        mbar_expect(bar + slot_of(p), 4u * (unsigned)kSlab);
        tma_load_3d(dst, &in_map, x0, y0 - ry, pz, bar + slot_of(p));
      }
      return;
    }
    const float* src = in + (live ? (long long)pz * plane : 0);
    if (kVec) {
      constexpr int row4 = tx / 4;
      for (int c = tid; c < kSlab / 4; c += kThreads) {
        const int row = c / row4, x = x0 + 4 * (c - row * row4);
        int y = y0 - ry + row;
        bool ok = live && x < gx;
        if (Geo::wrap)
          y = wrap_index(y, gy);
        else
          ok = ok && y >= 0 && y < gy;
        copy16z(dst + c, ok ? src + (long long)y * gx + x : in, ok);
      }
    } else {
      float* d = reinterpret_cast<float*>(dst);
      for (int e = tid; e < kSlab; e += kThreads) {
        const int row = e / tx, x = x0 + (e - row * tx);
        int y = y0 - ry + row;
        bool ok = live && x < gx;
        if (Geo::wrap)
          y = wrap_index(y, gy);
        else
          ok = ok && y >= 0 && y < gy;
        copy4z(d + e, ok ? src + (long long)y * gx + x : in, ok);
      }
    }
  };

  // z: za = sum_i kz[i] * plane (q + rz - i), plane q + rz in slot `newest`,
  // over this thread's Share of the slab. It keeps its share of the kKeep
  // planes before the newest in registers from step to step.
  Share kept[kKeep > 0 ? kKeep : 1];
  bool primed = false;
  auto z_pass = [&](float* za, int newest) {
    auto load = [&](int slot) {
      const float4* pl = ring + (size_t)slot * s4;
      Share v;
#pragma unroll
      for (int j = 0; j < kChunkRounds; ++j) v.c[j] = pl[tid + j * kThreads];
#pragma unroll
      for (int j = 0; j < kTailRounds; ++j) {
        const int at = kTailAt + j * kThreads + tid;
        v.t[j] = at < kSlab ? reinterpret_cast<const float*>(pl)[at] : 0.f;
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
    add(taps[0], fresh);
#pragma unroll
    for (int k = 0; k < kKeep; ++k) add(taps[k + 1], kept[k]);
    if (kKeep > 0) {
#pragma unroll
      for (int k = kKeep - 1; k > 0; --k) kept[k] = kept[k - 1];
      kept[0] = fresh;
    }
    int slot = back(newest, kKeep + 1);
#pragma unroll
    for (int i = kKeep + 1; i < nkz; ++i) {
      add(taps[i], load(slot));
      slot = slot == 0 ? slots - 1 : slot - 1;
    }
    float4* za4 = reinterpret_cast<float4*>(za);
#pragma unroll
    for (int j = 0; j < kChunkRounds; ++j) za4[tid + j * kThreads] = acc.c[j];
#pragma unroll
    for (int j = 0; j < kTailRounds; ++j) {
      const int at = kTailAt + j * kThreads + tid;
      if (at < kSlab) za[at] = acc.t[j];
    }
  };

  // y: out row y0 + a = sum_j ky[j] * za row a + 2 ry - j. The window walks
  // down from row 4 y_rg + nky + 2, four rows a group; group k meets the
  // padded taps tp4[k], tp4[k + 1] (csrc/stencil.cuh::window_fma), and the
  // rows of the last group may lie in the guard rows below row 0 (zero taps).
  auto y_pass = [&](const float* za, int qq) {
    if (ymask == 0u) return;
    const float* zp = za + (4 * y_rg + nky + 2) * tx + y_c;
    const float4* tp4 = reinterpret_cast<const float4*>(taps + ky_at);
    constexpr int ng = round4(nky + 3) / 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < ng; ++k) {
      float v[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) v[d] = zp[-(4 * k + d) * tx];
      window_fma(tp4[k], tp4[k + 1], v, acc);
    }
    float* o = out + (long long)qq * plane + yoff;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ymask >> j & 1u) o[(long long)j * gx] = acc[j];
  };

  // Step q requests plane q + rz + kDepth, makes the z pass of output plane q
  // (planes q - rz .. q + rz, the newest in slot_of(q + rz)) into
  // za_buf[q & 1] and the y pass of plane q - 1 from the other, and waits for
  // plane q + rz + 1, the newest of the next step. The steps q < 0 only fill
  // the ring, the last only makes a y pass. Every step commits one group of
  // cp.async copies, so plane q + rz + 1's is complete when at most kDepth - 1
  // are in flight.
  const int last = gz - 1 + rz;  // the last plane a z pass reads
  const bool y_first = (warp >> 2) & 1;
  if (tma) fence_async_smem();
  __syncthreads();  // the taps, the guard rows and the mbarriers are there
  for (int p = -rz; p < -rz + kDepth - 1; ++p) {
    if (p <= last) issue(p);
    copies_commit();
  }
  CONVZY_TICK(0);
  for (int q = -nkz; q <= gz; ++q) {
    if (q + rz + kDepth <= last) issue(q + rz + kDepth);
    copies_commit();
    CONVZY_TICK(1);
    float* za_z = za_buf + (q & 1) * kZa + kGuardRows * tx;
    const float* za_y = za_buf + ((q - 1) & 1) * kZa + kGuardRows * tx;
    if (y_first && q >= 1) y_pass(za_y, q - 1);
    if (q >= 0 && q < gz) z_pass(za_z, slot_of(q + rz));
    CONVZY_TICK(2);
    if (!y_first && q >= 1) y_pass(za_y, q - 1);
    CONVZY_TICK(3);
    if (q + 1 < gz) {
      copies_wait_but<kDepth - 1>();
      const int p = q + rz + 1;
      if (tma) mbar_wait(bar + slot_of(p), (unsigned)((p + rz) / slots) & 1u);
    }
    CONVZY_TICK(4);
    __syncthreads();
    CONVZY_TICK(5);
  }
#ifdef CONVZY_PROFILE
  if (tid == 0)
    for (int k = 0; k < kStages; ++k)
      clocks[kStages * (blockIdx.y * gridDim.x + blockIdx.x) + k] = (float)prof[k];
#endif
}

template <bool kVec>
int launch(const float* in, float* out, const float* taps, int gz, int gy, int gx, float* clocks,
           cudaStream_t stream) {
  const auto kernel = convzy_kernel<kVec>;
  const size_t smem = convzy_smem_floats(Geo::nkz, Geo::nky, Geo::ty, Geo::tx) * sizeof(float);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  CUtensorMap in_map = {};
  if (kVec) err = slab_map(&in_map, in, gz, gy, gx, Geo::ty + 2 * (Geo::nky / 2), Geo::tx);
  if (err != 0) return err;
  dim3 grid((unsigned)((gx + Geo::tx - 1) / Geo::tx), (unsigned)((gy + Geo::ty - 1) / Geo::ty));
  kernel<<<grid, kThreads, smem, stream>>>(in, out, taps, in_map, gz, gy, gx, clocks);
  return (int)cudaGetLastError();
}
#endif  // CONVZY_NKZ

}  // namespace

// Bytes of dynamic shared memory a block takes with these tap lengths and
// tile (ops/conv3_cuda.py::convzy_smem_bytes is the same sum).
extern "C" int shrimpy_convzy_smem(int nkz, int nky, int ty, int tx) {
  return (int)(convzy_smem_floats(nkz, nky, ty, tx) * sizeof(float));
}

#ifdef CONVZY_NKZ
// taps: float32 kz padded with zeros to a multiple of 4, then the ky window
// (3 zeros, ky, zeros: csrc/stencil.cuh::window_taps), as the first part of
// a row of ops/rl_fused.py::Stencil.packed. The geometry (nkz .. wrap) must be
// the one this library was compiled for. vec: gx % 4 == 0 and `in` 16-byte
// aligned. clocks: kStages floats a block in a CONVZY_PROFILE build, else
// unused. A block has 512 threads.
extern "C" int shrimpy_convzy(const void* in, void* out, const void* taps, int nkz, int nky,
                              long long gz, long long gy, long long gx, int ty, int tx, int wrap,
                              int vec, void* clocks, void* stream) {
  if (nkz != Geo::nkz || nky != Geo::nky || ty != Geo::ty || tx != Geo::tx ||
      (wrap != 0) != Geo::wrap)
    return (int)cudaErrorInvalidValue;
  // A plane is indexed in 32 bits, and the grid's y extent is a launch's.
  if (gz < 1 || gy < 1 || gx < 1 || gz > INT_MAX || gy * gx > INT_MAX ||
      (gy + ty - 1) / ty > 65535)
    return (int)cudaErrorInvalidValue;
  const auto run = vec ? launch<true> : launch<false>;
  return run((const float*)in, (float*)out, (const float*)taps, (int)gz, (int)gy, (int)gx,
             (float*)clocks, (cudaStream_t)stream);
}
#endif
