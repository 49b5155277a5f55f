// z+y convolution of one separable term, in one launch:
//
//   out = Y Z v,   (A v)[n] = sum_i k[i] * v[n + r - i]
//
// on the exact (gz, gy, gx) G grid, float32 FMA, with v zero outside the
// grid (shrimpy_convzy_linear) or circular, v[m] = v[m mod n]
// (shrimpy_convzy_circular; any radius, also r >= n). The x axis and the
// RL epilogue follow in conv_x_kernel (csrc/rl_fused.cu), launched by
// ops/conv3_cuda.py::conv3_half_step_cuda.
//
// Replaces two TPU kernels of shrimpy_tpu/ops/conv3_pallas.py, both z
// taps on the VPU and a banded-y MXU dot:
//   * _convzy_linear_jit (backend linear_pallas) over a permanently
//     zero-padded carry whose 8/128-row pads keep DMA starts
//     tile-aligned (lp_layout, lp_pad, lp_y_stencil);
//   * _convzy_pallas_jit (backend zy_pallas, and the z+y part of
//     conv3_circular_pallas's semantics) over a carry wrap-padded by the
//     radii on every call (jnp.pad mode="wrap").
// Neither layout is ported: a block masks (kWrap false) or wraps (kWrap
// true) its own slab rows, so the port keeps the carry on the exact G
// grid like the fused backend. A wrapped row is loaded from m mod n with
// a true modulo, so taps that reach around an axis more than once add up
// as in deconv.py::_circulant; only edge blocks pay the modulo.
//
// One block per (kBz, kTy, kTx) output tile, kTx x kRowsY threads:
//   1. stage the (kBz + 2rz) x (kTy + 2ry) x kTx input slab in shared
//      memory with cp.async, x contiguous (a warp copies one 128-byte row
//      segment), zero outside the grid or wrapped, and the taps beside it;
//   2. z taps in place: each thread owns (y, x) columns of the slab,
//      makes a column's kBz outputs in registers tap by tap, then writes
//      them over the column's first kBz planes;
//   3. y taps from the z result, kTy / kRowsY consecutive rows per
//      thread in registers, tap by tap; written out.
// Both passes sum the taps in the order i = 0, 1, ... with one FMA each,
// as the plain versions do (ops/conv3_cuda.py::convzy_linear_plain,
// convzy_circular_plain), so the kernel equals them bit for bit.
// Bound on the card: shared-memory loads and latency, not DRAM. A block
// reads (kBz + 2rz)(kTy + 2ry) / (kBz kTy) = 2.6 input volumes per output
// volume at rz = 4, ry = 10 through L2 (neighbouring blocks share the
// halos) and writes one; each FMA loads one value from shared memory. A
// sweep at the production carry on an H100 SXM at 700 W (PERF.md):
// one load at a time and a global load of a tap per FMA took 15.3 ms;
// cp.async staging 13.7 ms; register tiles with the taps in shared
// memory 7.1 ms, this tile; staging rows walked without an integer
// division per element 6.1 ms (circular 8.3 -> 7.3 ms, both bit-equal
// before and after). The slab is 172 KB at those radii (one block
// of 512 threads per SM); radii whose kTy = 64 slab does not fit run a
// kTy = 32 tile, and the wrapper raises on radii whose kTy = 32 slab
// exceeds 227 KB (at rz = 4 that caps ry at 40).

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;      // x extent of a tile: one warp along x
constexpr int kRowsY = 16;   // thread rows of a block
constexpr int kBz = 8;       // output z planes per block
constexpr size_t kMaxSmem = 232448;  // H100 opt-in shared memory per block

// One 4-byte asynchronous global -> shared copy (cp.async, sm_80+): the
// thread issues it and goes on, so a warp keeps its whole share of the
// slab in flight instead of one load at a time. src-size 0 zero-fills
// the element (outside the grid) without reading memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

size_t smem_bytes(int kty, int nkz, int nky) {
  return ((size_t)(kBz + 2 * (nkz / 2)) * (kty + 2 * (nky / 2)) * kTx + nkz + nky) *
         sizeof(float);
}

// m mod n in [0, n) for any m (a true modulo, never one subtraction).
__device__ __forceinline__ int wrap_index(int m, int n) {
  return (m >= 0 && m < n) ? m : ((m % n) + n) % n;
}

template <int kTy, bool kWrap>  // output y rows per block; circular boundary
__global__ void convzy_kernel(const float* __restrict__ in,
                              float* __restrict__ out,
                              const float* __restrict__ kz, int nkz,
                              const float* __restrict__ ky, int nky,
                              int gz, int gy, int gx) {
  constexpr int kRowsOut = kTy / kRowsY;  // output y rows per thread
  static_assert(kTy % kRowsY == 0, "a thread makes whole rows");
  // [(kBz + 2rz) * (kTy + 2ry) * kTx] slab, then the kz and ky taps
  extern __shared__ float slab[];
  const int rz = nkz / 2, ry = nky / 2;
  const int sz = kBz + 2 * rz, sy = kTy + 2 * ry;
  float* taps = slab + sz * sy * kTx;  // kz, then ky at taps + nkz
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy, z0 = blockIdx.z * kBz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = x0 + tx;
  const long long plane = (long long)gy * gx;

  const int flat = ty * kTx + tx;
  if (flat < nkz) taps[flat] = kz[flat];
  if (flat < nky) taps[nkz + flat] = ky[flat];
  // Slab row j = dz * sy + dy, walked without a division: kRowsY < sy,
  // so a step of kRowsY rows crosses at most one plane.
  int dz = 0, dy = ty;
  for (int j = ty; j < sz * sy; j += kRowsY) {
    int zz = z0 - rz + dz, yy = y0 - ry + dy;
    bool valid = x < gx;
    if (kWrap) {
      zz = wrap_index(zz, gz);
      yy = wrap_index(yy, gy);
    } else {
      valid = valid && zz >= 0 && zz < gz && yy >= 0 && yy < gy;
    }
    copy_async(&slab[j * kTx + tx], valid ? in + zz * plane + (long long)yy * gx + x : in,
               valid);
    dy += kRowsY;
    if (dy >= sy) {
      dy -= sy;
      ++dz;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // z taps: out[z0 + o] = sum_i kz[i] * in[z0 + o + rz - i], slab plane
  // o + 2rz - i. In place: the column's planes have all been read.
  const int zstride = sy * kTx;
  for (int dy = ty; dy < sy; dy += kRowsY) {
    float* col = slab + dy * kTx + tx;
    float acc[kBz];
#pragma unroll
    for (int o = 0; o < kBz; ++o) acc[o] = 0.f;
    for (int i = 0; i < nkz; ++i) {
      const float k = taps[i];
      const float* c = col + (2 * rz - i) * zstride;
#pragma unroll
      for (int o = 0; o < kBz; ++o) acc[o] = fmaf(k, c[o * zstride], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kBz; ++o) col[o * zstride] = acc[o];
  }
  __syncthreads();

  // y taps: out row y0 + a = sum_j ky[j] * z-row a + 2ry - j of the slab.
  if (x >= gx) return;
  const int nz_out = min(kBz, gz - z0);
  const int a0 = ty * kRowsOut;
  for (int o = 0; o < nz_out; ++o) {
    const float* plane_o = slab + o * zstride + tx;
    float acc[kRowsOut];
#pragma unroll
    for (int r = 0; r < kRowsOut; ++r) acc[r] = 0.f;
    for (int j = 0; j < nky; ++j) {
      const float k = taps[nkz + j];
      const float* c = plane_o + (a0 + 2 * ry - j) * kTx;
#pragma unroll
      for (int r = 0; r < kRowsOut; ++r) acc[r] = fmaf(k, c[r * kTx], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsOut; ++r) {
      if (y0 + a0 + r < gy) {
        out[(z0 + o) * plane + (long long)(y0 + a0 + r) * gx + x] = acc[r];
      }
    }
  }
}

template <int kTy, bool kWrap>
int launch(const void* in, void* out, const void* kz, int nkz, const void* ky, int nky,
           long long gz, long long gy, long long gx, cudaStream_t stream) {
  const size_t smem = smem_bytes(kTy, nkz, nky);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)convzy_kernel<kTy, kWrap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  dim3 block(kTx, kRowsY);
  dim3 grid((unsigned)((gx + kTx - 1) / kTx), (unsigned)((gy + kTy - 1) / kTy),
            (unsigned)((gz + kBz - 1) / kBz));
  convzy_kernel<kTy, kWrap><<<grid, block, smem, stream>>>(
      (const float*)in, (float*)out, (const float*)kz, nkz, (const float*)ky, nky,
      (int)gz, (int)gy, (int)gx);
  return (int)cudaGetLastError();
}

// The kTy = 64 tile where its slab fits a block's shared memory, else
// kTy = 32 (the wrapper has checked that that one fits).
template <bool kWrap>
int dispatch(const void* in, void* out, const void* kz, int nkz, const void* ky, int nky,
             long long gz, long long gy, long long gx, void* stream) {
  if (smem_bytes(64, nkz, nky) <= kMaxSmem) {
    return launch<64, kWrap>(in, out, kz, nkz, ky, nky, gz, gy, gx, (cudaStream_t)stream);
  }
  return launch<32, kWrap>(in, out, kz, nkz, ky, nky, gz, gy, gx, (cudaStream_t)stream);
}

}  // namespace

extern "C" int shrimpy_convzy_linear(const void* in, void* out, const void* kz,
                                     int nkz, const void* ky, int nky,
                                     long long gz, long long gy, long long gx,
                                     void* stream) {
  return dispatch<false>(in, out, kz, nkz, ky, nky, gz, gy, gx, stream);
}

extern "C" int shrimpy_convzy_circular(const void* in, void* out, const void* kz,
                                       int nkz, const void* ky, int nky,
                                       long long gz, long long gy, long long gx,
                                       void* stream) {
  return dispatch<true>(in, out, kz, nkz, ky, nky, gz, gy, gx, stream);
}
