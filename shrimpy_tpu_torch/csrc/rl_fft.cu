// The fft2z Richardson-Lucy iteration between its band launches: cuFFT plans
// that read and write the loop's own buffers, and the iteration's two
// elementwise passes.
//
// No TPU kernel: the JAX package leaves the transforms and the update of
// shrimpy_tpu/ops/deconv.py::_rl_fft2z_jit (:340) to XLA. Eager torch.fft on
// the card makes cuFFT write a temporary that rfft2(out=) then copies into
// `out` (a device-to-device copy a chunk), clones the complex input of every
// irfft2 (cuFFT's C2R overwrites it) and writes a fresh output, and the
// update is two passes (clamp_min_, then div). Here cuFFT reads and writes
// the loop's buffers directly and each update is one pass.
//
// Plans: batched 2-D R2C and C2R (D2Z and Z2D in float64) of `batch` (gy, gx)
// planes in the contiguous layout of torch.fft.rfft2 (complex rows of
// gx / 2 + 1), unscaled both ways. Auto-allocation is off: every execution
// is handed its work area by the caller, from PyTorch's caching allocator.
// A C2R destroys its input.
//
// Kernels, bound on the card by bytes: each reads two arrays and writes one,
// at a chunk of (8, 2916, 1920) float32 537 MB, 0.161 ms at 3.35 TB/s.
//   rl_ratio_kernel: x[i] = data[i] / max(x[i], eps), a NaN in x kept as
//     torch.clamp_min keeps it, IEEE division (no fast math): the bits of
//     torch.div(data, x.clamp_min_(eps), out=x).
//   rl_scale_kernel: v[i] *= x[i], the bits of v.mul_(x).
// Design: 16-byte vectors (float4, double2) where every pointer is 16-byte
// aligned, the tail and any other case by element; one vector a thread,
// grid-stride past kMaxBlocks blocks. (On an H100 at the chunk, a grid of
// one resident wave, 1056 blocks, took 0.187 ms; one vector a thread
// 0.1765; unrolling the loop 2 or 4 times moved neither.)

#include <cuda_runtime.h>
#include <cufft.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
// A cuFFT status is returned as this plus the cufftResult.
constexpr int kCufftError = 200000;

// cufftSetStream, cufftSetWorkArea and the execution are one critical
// section: two host threads sharing a plan must not swap its stream or
// work area between them.
std::mutex g_exec;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// torch.clamp_min on the card: a NaN passes, else the max.
__device__ __forceinline__ float clamp_min_keep_nan(float x, float eps) {
  return isnan(x) ? x : fmaxf(x, eps);
}
__device__ __forceinline__ double clamp_min_keep_nan(double x, double eps) {
  return isnan(x) ? x : fmax(x, eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rl_ratio_kernel(T* __restrict__ x, const T* __restrict__ data, long long n, T eps, int vec) {
  using V = typename Vec16<T>::type;
  constexpr int W = Vec16<T>::n;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / W;
    V* xv = reinterpret_cast<V*>(x);
    const V* dv = reinterpret_cast<const V*>(data);
    for (long long j = first; j < nv; j += stride) {
      V a = xv[j];
      const V d = __ldg(dv + j);
      T* pa = reinterpret_cast<T*>(&a);
      const T* pd = reinterpret_cast<const T*>(&d);
#pragma unroll
      for (int k = 0; k < W; ++k) pa[k] = pd[k] / clamp_min_keep_nan(pa[k], eps);
      xv[j] = a;
    }
    done = nv * W;
  }
  for (long long j = done + first; j < n; j += stride)
    x[j] = __ldg(data + j) / clamp_min_keep_nan(x[j], eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rl_scale_kernel(T* __restrict__ v, const T* __restrict__ x, long long n, int vec) {
  using V = typename Vec16<T>::type;
  constexpr int W = Vec16<T>::n;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / W;
    V* vv = reinterpret_cast<V*>(v);
    const V* xv = reinterpret_cast<const V*>(x);
    for (long long j = first; j < nv; j += stride) {
      V a = vv[j];
      const V b = __ldg(xv + j);
      T* pa = reinterpret_cast<T*>(&a);
      const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int k = 0; k < W; ++k) pa[k] = pa[k] * pb[k];
      vv[j] = a;
    }
    done = nv * W;
  }
  for (long long j = done + first; j < n; j += stride) v[j] = v[j] * __ldg(x + j);
}

// Blocks of a grid-stride launch over `units` threads' work.
int grid_blocks(long long units) {
  const long long want = (units + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want < 1 ? 1 : want) : kMaxBlocks);
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<std::uintptr_t>(a) | reinterpret_cast<std::uintptr_t>(b)) & 15) == 0;
}

template <typename T>
int launch_ratio(void* x, const void* data, long long n, double eps, cudaStream_t st) {
  const int vec = aligned16(x, data);
  const long long units = vec ? (n + Vec16<T>::n - 1) / Vec16<T>::n : n;
  rl_ratio_kernel<T><<<grid_blocks(units), kThreads, 0, st>>>(
      static_cast<T*>(x), static_cast<const T*>(data), n, (T)eps, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale(void* v, const void* x, long long n, cudaStream_t st) {
  const int vec = aligned16(v, x);
  const long long units = vec ? (n + Vec16<T>::n - 1) / Vec16<T>::n : n;
  rl_scale_kernel<T><<<grid_blocks(units), kThreads, 0, st>>>(
      static_cast<T*>(v), static_cast<const T*>(x), n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0: R2C (D2Z with dbl), 1: C2R (Z2D). Makes a plan of `batch`
// contiguous (gy, gx) transforms with auto-allocation off on the current
// device; writes its handle and the bytes of work area each execution needs.
extern "C" int shrimpy_fft_plan(int kind, int dbl, long long batch, long long gy, long long gx,
                                int* handle, long long* work_bytes) {
  if (batch < 1 || gy < 1 || gx < 1 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  cufftHandle plan;
  cufftResult r = cufftCreate(&plan);
  if (r != CUFFT_SUCCESS) return kCufftError + (int)r;
  long long n[2] = {gy, gx};
  size_t work = 0;
  const cufftType type = kind == 0 ? (dbl ? CUFFT_D2Z : CUFFT_R2C) : (dbl ? CUFFT_Z2D : CUFFT_C2R);
  r = cufftSetAutoAllocation(plan, 0);
  if (r == CUFFT_SUCCESS)
    r = cufftMakePlanMany64(plan, 2, n, nullptr, 1, 0, nullptr, 1, 0, type, batch, &work);
  if (r != CUFFT_SUCCESS) {
    cufftDestroy(plan);
    return kCufftError + (int)r;
  }
  *handle = (int)plan;
  *work_bytes = (long long)work;
  return (int)cudaGetLastError();
}

// Runs a plan of shrimpy_fft_plan from `in` to `out` on `stream` with the
// work area `work` (null where the plan needs none). Returns 0, a CUDA error
// or kCufftError plus the cufftResult.
extern "C" int shrimpy_fft_exec(int handle, int kind, int dbl, void* in, void* out, void* work,
                                void* stream) {
  std::lock_guard<std::mutex> lock(g_exec);
  const cufftHandle plan = (cufftHandle)handle;
  cufftResult r = cufftSetStream(plan, static_cast<cudaStream_t>(stream));
  if (r == CUFFT_SUCCESS && work != nullptr) r = cufftSetWorkArea(plan, work);
  if (r == CUFFT_SUCCESS) {
    if (kind == 0)
      r = dbl ? cufftExecD2Z(plan, static_cast<cufftDoubleReal*>(in),
                             static_cast<cufftDoubleComplex*>(out))
              : cufftExecR2C(plan, static_cast<cufftReal*>(in), static_cast<cufftComplex*>(out));
    else
      r = dbl ? cufftExecZ2D(plan, static_cast<cufftDoubleComplex*>(in),
                             static_cast<cufftDoubleReal*>(out))
              : cufftExecC2R(plan, static_cast<cufftComplex*>(in), static_cast<cufftReal*>(out));
  }
  if (r != CUFFT_SUCCESS) return kCufftError + (int)r;
  return (int)cudaGetLastError();
}

// x[i] = data[i] / max(x[i], eps) over n elements, float32 (dbl 0) or
// float64 (dbl 1).
extern "C" int shrimpy_rl_ratio(void* x, const void* data, long long n, double eps, int dbl,
                                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? launch_ratio<double>(x, data, n, eps, st) : launch_ratio<float>(x, data, n, eps, st);
}

// v[i] *= x[i] over n elements, float32 (dbl 0) or float64 (dbl 1).
extern "C" int shrimpy_rl_scale(void* v, const void* x, long long n, int dbl, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? launch_scale<double>(v, x, n, st) : launch_scale<float>(v, x, n, st);
}
