// Shear-affine (oblique-plane) deskew with in-kernel z-averaging.
//
// Replaces the TPU kernel shrimpy_tpu/ops/deskew_pallas.py::_kernel
// (launched by _deskew_pallas_jit). Semantics: shrimpy_tpu/ops/deskew.py
// (_deskew_xla + _average_z_groups; scipy order-1 'grid-constant' oracle).
//
//   out[g, y, x] = sum_{z in group g}
//       wt0[z] * (w00[z,y] * raw[s0[z,y], t0[z], x] + w01[z,y] * raw[s1[z,y], t0[z], x])
//     + wt1[z] * (w00[z,y] * raw[s0[z,y], t1[z], x] + w01[z,y] * raw[s1[z,y], t1[z], x])
//
// raw is (ns, nt, nx) float32, C-contiguous; out is (n_groups, ny, nx).
// The host plan (ops/deskew_cuda.py::plan_tables, float64 then cast)
// supplies the clamped indices and the masked weights: taps outside
// [0, ns-1] / tilt planes outside [0, nt-1] carry weight 0 (the
// keep_overhang rim), and the 1/group-size scale of the z-average is
// folded into wt0/wt1, so averaging is plain accumulation in a register.
//
// Bound on the card: bytes. The raw stack is read once and the output
// written once: at the production size (raw 1201 x 256 x 1600 -> out
// 128 x 2888 x 1600) 1.97 GB + 2.37 GB = 4.33 GB, 1.294 ms at 3.35 TB/s;
// 1.250 ms counting only the 284,664 of 307,456 raw rows that the tables
// read with a nonzero weight (keep_overhang false crops the rest).
// Both tilt planes of every z are read: at 30 degrees float64 sin gives
// t = z / sin = 2z plus an ulp, so wt1 is a weight of ~1e-14, not 0, on 127
// of the 128 output z (a plane is skipped only where its weight is exactly
// 0, which keeps the bits of the JAX package's tables). Each raw row feeds
// ~2.6 output rows (1 / px_to_scan_ratio) in each of two positions.
//
// Design (the TPU kernel's union band, staged for Hopper):
//   * s is affine in y, so for one z the scan rows a tile of ty output rows
//     needs are one contiguous run, s0(z, y0) .. s1(z, y0 + ty - 1), at most
//     `rows` of them (ops/deskew_cuda.py::band_rows from the tables), and the
//     tilt planes t0 and t1 = t0 + 1 are neighbours in raw. The TMA engine
//     brings that band into shared memory, one (1, planes, tx) box over raw
//     viewed as (ns, nt, nx) a scan row, only the rows this (z, tile) spans:
//     each raw row comes from device memory about once (the rows two y
//     tiles share, through L2), and a tile in the keep_overhang rim, whose
//     rows all clamp to one, reads one. The tile's four tables come beside
//     it by cp.async and thread 0 writes a header (first row, plane offset,
//     tilt weights), so the compute reads no table from device memory. At
//     BASELINE.md config 1 one box of `rows` rows a band took 8.98 ms, a
//     box a row 7.89, and the tables staged so 5.41.
//   * A persistent grid: a block walks output tiles (ty rows x tx columns of
//     one group) blockIdx.x, + gridDim.x, ..., each for every z of its group,
//     and keeps the next (z, tile) in flight in a ring of kSlots slots, an
//     mbarrier a slot, while it computes the current one. A 1-D grid of
//     tiles in 64 bits takes any output extent.
//   * A thread owns a float4 column of the tile and every pass-th row
//     (pass = kThreads / (tx / 4)), kRowsThread float4 sums in registers
//     across the z of the group; it reads the band as float4 from shared
//     memory (a warp reads 512 contiguous bytes of a row) and writes its
//     outputs as float4 once the group's last z is in. Offsets are 64-bit
//     at a tile's base and 32-bit inside the band.
//   * Where nx % 4 != 0 or raw is not 16-byte aligned (a TMA map needs both),
//     the same kernel stages the band by cp.async of 4 bytes a float,
//     zero-filling columns past raw, and writes floats.
//   * Bits: every output sums its z in ascending order from zero, plane t0
//     then t1, each as acc += wt * (w00 * a + w01 * b), as the kernel
//     before this design did, and reads the clamped row or plane (weight
//     0, in range) that it read: the bits of the kernel before
//     (chip_smoke.py --parent-deskew) wherever raw is finite, and a
//     non-finite value on a weight-0 rim row gives the same NaN.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md row 1): 1.649 ms
// at the production size against 3.574 for the kernel before (a block of
// 128 threads walking 16 output rows of one float of x each, four 4-byte
// gathers through L1/L2 an output) in the same run, 76 % of the bound from
// the raw rows the tables read; 5.500 ms against 26.564 at BASELINE.md
// config 1 (raw 300 x 2048 x 2048, keep_overhang, average_n_slices 3),
// 66 % of its bound.
// Tile (64, 256) and two slots were the best of profile_step.py --deskew's
// sweep at both sizes within 3 %; three or four slots (one block an SM)
// and loading the next band's table entries a step ahead (164 registers,
// one block an SM) were slower.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>

#include "async_copy.cuh"
#include "stencil.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 2;        // band slots: the one computed and kSlots - 1 in flight
constexpr int kRowsThread = 16;  // float4 sums a thread keeps: rows of the tile it owns
constexpr int kBox = 256;        // the most a TMA box spans on an axis: tx

// Float4 of a band row in shared memory: planes x tx floats, to a multiple of
// 128 bytes (where a TMA copy may start).
__host__ __device__ inline int row_float4(int planes, int tx) { return (planes * tx / 4 + 7) & ~7; }
// Float4 of a slot: the band's rows, then the tile's tables (s0, s1, w00 and
// w01 of its ty rows, to a multiple of 128 bytes), then a 128-byte header
// (the band's first row, plane t1's offset, wt0, wt1).
__host__ __device__ inline int slot_float4(int rows, int planes, int tx, int ty) {
  return rows * row_float4(planes, tx) + ((4 * ty + 31) & ~31) / 4 + 8;
}

struct Tables {
  const int *t0, *t1;
  const float *wt0, *wt1;
  const int *s0, *s1;
  const float *w00, *w01;
};

// A launch's shapes: raw (ns, nt, nx), nz raw-rate output z in groups of
// a_avg, ny rows; tiles of ty x tx, n_yt x n_xt of them a group, a band of
// `rows` scan rows x `planes` tilt planes (min(nt, 2)).
struct Plan {
  long long n_tiles;
  int ns, nt, nx, nz, ny, a_avg;
  int ty, tx, rows, planes, n_yt, n_xt;
};

// One (tile, z) of a block's walk: tile blockIdx.x + k gridDim.x, z from its
// group's first to z_end.
struct Cursor {
  long long tile;
  int z, z_end, y0, x0;
  __device__ void at(long long t, const Plan& p) {
    tile = t;
    if (t >= p.n_tiles) return;
    const long long rest = t / p.n_xt;
    x0 = (int)(t - rest * p.n_xt) * p.tx;
    const long long g = rest / p.n_yt;
    y0 = (int)(rest - g * p.n_yt) * p.ty;
    z = (int)g * p.a_avg;
    z_end = min(z + p.a_avg, p.nz);
  }
  __device__ bool live(const Plan& p) const { return tile < p.n_tiles; }
  __device__ void next(const Plan& p) {
    if (++z == z_end) at(tile + gridDim.x, p);
  }
};

__device__ __forceinline__ void lerp4(float4& acc, float v, float u0, float u1, const float4 a,
                                      const float4 b) {
  acc.x += v * (u0 * a.x + u1 * b.x);
  acc.y += v * (u0 * a.y + u1 * b.y);
  acc.z += v * (u0 * a.z + u1 * b.z);
  acc.w += v * (u0 * a.w + u1 * b.w);
}

// kVec: nx % 4 == 0 and raw 16-byte aligned: the band by TMA, float4 writes.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
deskew_kernel(const float* __restrict__ raw, float* __restrict__ out, const Tables tab,
              const __grid_constant__ CUtensorMap raw_map, const Plan p) {
  extern __shared__ __align__(128) float4 smem4[];
  const int cols4 = p.tx / 4, row4 = row_float4(p.planes, p.tx);
  const int slot4 = slot_float4(p.rows, p.planes, p.tx, p.ty);
  const int tab_at = p.rows * row4 * 4, hdr_at = tab_at + ((4 * p.ty + 31) & ~31);  // floats
  float4* ring = smem4;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(ring + kSlots * slot4);
  const int tid = threadIdx.x;
  const int pass = kThreads / cols4;  // rows a pass of the block covers
  const int col = tid % cols4, row_t = tid / cols4;

  if (kVec && tid < kSlots) mbar_init(bar + tid, 1);
  if (kVec) fence_async_smem();
  __syncthreads();

  // Item (z, tile) into `slot`: the span of scan rows from s0(z, y0) to
  // s1(z, last row), tilt planes from t0(z), columns from x0, a row a copy
  // (a tile in the keep_overhang rim, whose rows all clamp to one, reads
  // one); the tile's tables by cp.async; thread 0 writes the header.
  auto issue = [&](const Cursor& c, int slot) {
    const long long zrow = (long long)c.z * p.ny;
    float* d = reinterpret_cast<float*>(ring + slot * slot4);
    for (int e = tid; e < 4 * p.ty; e += kThreads) {
      const int a = e / p.ty, y = min(c.y0 + e - a * p.ty, p.ny - 1);
      const void* src = a == 0 ? (const void*)(tab.s0 + zrow + y)
                      : a == 1 ? (const void*)(tab.s1 + zrow + y)
                      : a == 2 ? (const void*)(tab.w00 + zrow + y)
                               : (const void*)(tab.w01 + zrow + y);
      copy_async4(d + tab_at + e, src);
    }
    if (!kVec || tid == 0) {
      const int s_lo = tab.s0[zrow + c.y0], t_lo = tab.t0[c.z];
      const int span = tab.s1[zrow + min(c.y0 + p.ty, p.ny) - 1] - s_lo + 1;
      if (tid == 0) {
        int* hdr = reinterpret_cast<int*>(d + hdr_at);
        hdr[0] = s_lo;
        hdr[1] = (tab.t1[c.z] - t_lo) * cols4;
        hdr[2] = __float_as_int(tab.wt0[c.z]);
        hdr[3] = __float_as_int(tab.wt1[c.z]);
      }
      if (kVec) {
        mbar_expect(bar + slot, 4u * (unsigned)(span * p.planes * p.tx));
        for (int r = 0; r < span; ++r)
          tma_load_3d(d + 4 * r * row4, &raw_map, c.x0, t_lo, s_lo + r, bar + slot);
        return;
      }
      const int per_row = p.planes * p.tx;
      for (int e = tid; e < span * per_row; e += kThreads) {
        const int rr = e / per_row, pl = (e - rr * per_row) / p.tx;
        const int x = e - rr * per_row - pl * p.tx, t = t_lo + pl;
        const bool ok = t < p.nt && c.x0 + x < p.nx;
        copy4z(d + rr * 4 * row4 + pl * p.tx + x,
               ok ? raw + ((long long)(s_lo + rr) * p.nt + t) * p.nx + c.x0 + x : raw, ok);
      }
    }
  };

  float4 acc[kRowsThread];
  // One z of the tile at `c` from its slot: the group's first z starts the
  // sums from zero, its last writes them.
  auto compute = [&](const Cursor& c, const float4* band) {
    const float* tb = reinterpret_cast<const float*>(band) + tab_at;
    const int* hdr = reinterpret_cast<const int*>(band) + hdr_at;
    const int s_lo = hdr[0], d1 = hdr[1];
    const float v0 = __int_as_float(hdr[2]), v1 = __int_as_float(hdr[3]);
    const bool first = c.z % p.a_avg == 0, last = c.z + 1 == c.z_end;
    const int x = c.x0 + 4 * col;
    float* o = out + ((long long)(c.z / p.a_avg) * p.ny + c.y0) * p.nx + x;
#pragma unroll
    for (int k = 0; k < kRowsThread; ++k) {
      const int row = row_t + k * pass;
      if (row_t >= pass || row >= p.ty || c.y0 + row >= p.ny) break;
      const float u0 = tb[2 * p.ty + row], u1 = tb[3 * p.ty + row];
      const float4* r0 = band + (__float_as_int(tb[row]) - s_lo) * row4 + col;
      const float4* r1 = band + (__float_as_int(tb[p.ty + row]) - s_lo) * row4 + col;
      float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : acc[k];
      if (v0 != 0.f) lerp4(a, v0, u0, u1, r0[0], r1[0]);
      if (v1 != 0.f) lerp4(a, v1, u0, u1, r0[d1], r1[d1]);
      acc[k] = a;
      if (last && x < p.nx) {
        float* dst = o + (long long)row * p.nx;
        if (kVec) {
          *reinterpret_cast<float4*>(dst) = a;
        } else {
          const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (x + j < p.nx) dst[j] = v[j];
        }
      }
    }
  };

  // Step i requests item i + kSlots - 1 into the slot item i - 1 used,
  // computes item i and waits for item i + 1. Every step commits one group
  // of cp.async copies (empty on the TMA path), so item i + 1's is complete
  // when at most kSlots - 2 are in flight; slot s is filled for the
  // (i / kSlots)-th time by item i: the parity its mbarrier completes.
  Cursor ahead, cur;
  ahead.at(blockIdx.x, p);
  cur = ahead;
  auto issue_ahead = [&](int slot) {
    if (!ahead.live(p)) return;
    issue(ahead, slot);
    ahead.next(p);
  };
  for (int j = 0; j < kSlots - 1; ++j) {
    issue_ahead(j);
    copies_commit();
  }
  copies_wait_but<kSlots - 2>();
  if (kVec && cur.live(p)) mbar_wait(bar, 0u);
  __syncthreads();
  for (int i = 0; cur.live(p); ++i) {
    issue_ahead((i + kSlots - 1) % kSlots);
    copies_commit();
    compute(cur, ring + (i % kSlots) * slot4);
    cur.next(p);
    if (cur.live(p)) {
      copies_wait_but<kSlots - 2>();
      if (kVec) mbar_wait(bar + (i + 1) % kSlots, (unsigned)((i + 1) / kSlots) & 1u);
    }
    __syncthreads();
  }
}

size_t smem_bytes(int rows, int planes, int tx, int ty) {
  return (size_t)kSlots * (16 * (size_t)slot_float4(rows, planes, tx, ty) + 8);
}

template <bool kVec>
int launch(const float* raw, float* out, const Tables& tab, const Plan& p, cudaStream_t stream) {
  const auto kernel = deskew_kernel<kVec>;
  const size_t smem = smem_bytes(p.rows, p.planes, p.tx, p.ty);
  int err = set_smem((const void*)kernel, smem);
  if (err != 0) return err;
  CUtensorMap map = {};
  if (kVec) err = box_map(&map, raw, p.ns, p.nt, p.nx, 1, p.planes, p.tx);
  if (err != 0) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&device)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != 0)
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                smem)) != 0)
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = min(p.n_tiles, (long long)sms * per_sm);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(raw, out, tab, map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block takes for a band of rows x planes x
// tx floats and a tile of ty rows (ops/deskew_cuda.py::deskew_smem_bytes is
// the same sum).
extern "C" int shrimpy_deskew_smem(int rows, int planes, int tx, int ty) {
  if (ty < 1 || ty > 1 << 20) return -1;
  return (int)smem_bytes(rows, planes, tx, ty);
}

// ty, tx: the output tile (tx a multiple of 4, at most 256; a thread keeps at
// most kRowsThread rows of it); rows: the most scan rows the band of a
// (z, tile) spans (ops/deskew_cuda.py::band_rows). vec: nx % 4
// == 0 and raw 16-byte aligned. Extents are indexed in 32 bits inside a
// plane of the tables and a band, in 64 bits at a tile's base.
extern "C" int shrimpy_deskew(
    const void* raw, void* out,
    const void* t0, const void* t1, const void* wt0, const void* wt1,
    const void* s0, const void* s1, const void* w00, const void* w01,
    long long ns, long long nt, long long nx, long long nz, long long ny,
    long long n_groups, int a_avg, int ty, int tx, int rows, int vec, void* stream) {
  const long long lim = INT_MAX;
  if (ns < 1 || nt < 1 || nx < 1 || nz < 1 || ny < 1 || a_avg < 1 || ns > lim || nt > lim ||
      nx > lim || nz > lim || ny > lim || n_groups != (nz + a_avg - 1) / a_avg)
    return (int)cudaErrorInvalidValue;
  const int cols4 = tx / 4;
  if (tx < 4 || tx % 4 != 0 || tx > kBox || rows < 1 || ty < 1 ||
      (ty + kThreads / cols4 - 1) / (kThreads / cols4) > kRowsThread || (vec && nx % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const Tables tab = {(const int*)t0,  (const int*)t1,  (const float*)wt0, (const float*)wt1,
                      (const int*)s0,  (const int*)s1,  (const float*)w00, (const float*)w01};
  Plan p;
  p.ns = (int)ns, p.nt = (int)nt, p.nx = (int)nx, p.nz = (int)nz, p.ny = (int)ny;
  p.a_avg = a_avg, p.ty = ty, p.tx = tx, p.rows = rows, p.planes = nt < 2 ? 1 : 2;
  p.n_yt = (int)((ny + ty - 1) / ty), p.n_xt = (int)((nx + tx - 1) / tx);
  p.n_tiles = n_groups * p.n_yt * p.n_xt;
  const auto run = vec ? launch<true> : launch<false>;
  return run((const float*)raw, (float*)out, tab, p, (cudaStream_t)stream);
}

extern "C" const char* shrimpy_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
