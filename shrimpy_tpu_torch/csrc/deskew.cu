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
// Bound on the card: memory. At the production size (raw 1201x256x1600
// -> out 128x2888x1600) the kernel must read at least the 1.97 GB raw
// stack and write the 2.37 GB output: 4.3 GB, ~1.3 ms at 3.35 TB/s.
// Each (z, y) reads two contiguous raw x-rows per tilt plane, and
// neighbouring threads read neighbouring x, so loads coalesce; a raw row
// feeds ~2.6 neighbouring output rows (1/px_to_scan_ratio), which blocks
// of consecutive y launched together find in L2. The TPU kernel's
// union-band DMA and banded MXU interpolation matrix are not ported: on
// Hopper a direct row gather through L2 is the natural form.
// A tilt plane whose weight is exactly 0 for a z (every odd plane at
// 30 degrees, where t = 2z) is not read at all; the only difference from
// multiplying it by 0 is that a non-finite raw value there stays out.
//
// Offsets are 64-bit: BASELINE config 1, (300, 2048, 2048), has 1.26e9
// raw elements, and with keep_overhang its output nears 2^31 elements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 128;
// Output rows per block: a block per (x-tile, y, group) made 4.8 M
// short blocks at the production size; 16 rows per block measured
// 5.2 -> 3.6 ms there on an H100 SXM 80 GB at 700 W (PERF.md).
constexpr int kRowsPerBlock = 16;

__global__ void deskew_kernel(
    const float* __restrict__ raw, float* __restrict__ out,
    const int* __restrict__ t0, const int* __restrict__ t1,
    const float* __restrict__ wt0, const float* __restrict__ wt1,
    const int* __restrict__ s0, const int* __restrict__ s1,
    const float* __restrict__ w00, const float* __restrict__ w01,
    long long nt, long long nx, long long nz, long long ny, int a_avg) {
  const long long x = (long long)blockIdx.x * kThreadsX + threadIdx.x;
  const long long g = blockIdx.z;
  if (x >= nx) return;
  const long long z_begin = g * a_avg;
  const long long z_end = min(z_begin + a_avg, nz);
  const long long y_begin = (long long)blockIdx.y * kRowsPerBlock;
  const long long y_end = min(y_begin + kRowsPerBlock, ny);
  for (long long y = y_begin; y < y_end; ++y) {
    float acc = 0.f;
    for (long long z = z_begin; z < z_end; ++z) {
      const long long zy = z * ny + y;
      const long long r0 = (long long)s0[zy] * nt;
      const long long r1 = (long long)s1[zy] * nt;
      const float u0 = w00[zy];
      const float u1 = w01[zy];
      const float v0 = wt0[z];
      const float v1 = wt1[z];
      if (v0 != 0.f) {
        const long long p = t0[z];
        acc += v0 * (u0 * raw[(r0 + p) * nx + x] + u1 * raw[(r1 + p) * nx + x]);
      }
      if (v1 != 0.f) {
        const long long p = t1[z];
        acc += v1 * (u0 * raw[(r0 + p) * nx + x] + u1 * raw[(r1 + p) * nx + x]);
      }
    }
    out[(g * ny + y) * nx + x] = acc;
  }
}

}  // namespace

extern "C" int shrimpy_deskew(
    const void* raw, void* out,
    const void* t0, const void* t1, const void* wt0, const void* wt1,
    const void* s0, const void* s1, const void* w00, const void* w01,
    long long ns, long long nt, long long nx, long long nz, long long ny,
    long long n_groups, int a_avg, void* stream) {
  (void)ns;  // indices are clamped host-side to [0, ns-1]
  dim3 block(kThreadsX);
  dim3 grid((unsigned)((nx + kThreadsX - 1) / kThreadsX),
            (unsigned)((ny + kRowsPerBlock - 1) / kRowsPerBlock),
            (unsigned)n_groups);
  deskew_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)raw, (float*)out, (const int*)t0, (const int*)t1,
      (const float*)wt0, (const float*)wt1, (const int*)s0, (const int*)s1,
      (const float*)w00, (const float*)w01, nt, nx, nz, ny, a_avg);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimpy_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
