// The asynchronous global -> shared copies the kernels share (rl_half.cu,
// rl_iter.cu, convzy.cu, deskew.cu): cp.async of 4, 8 or 16 bytes a thread,
// and the TMA engine's copy of a whole box, reported to an mbarrier, with the
// tensor map it reads.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

// cp.async: the thread issues the copy and goes on; a group is waited for
// before the barrier that publishes it.
__device__ __forceinline__ void copy_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// cp.async of 16 or 4 bytes that zero-fills its destination when !valid
// (src-size 0: nothing is read).
__device__ __forceinline__ void copy16z(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy4z(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait_but() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The TMA engine's copy of a box of a 3-D tensor, global -> shared: one thread
// issues it and goes on; the engine computes the addresses, writes zeros for
// what lies outside the tensor, and reports the bytes to an mbarrier that the
// block waits on.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int cx, int cy,
                                            int cz, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)), "r"(cx), "r"(cy), "r"(cz)
      : "memory");
}
// Orders this thread's accesses to shared memory before the engine's later ones.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tensor map of an (n2, n1, n0) float32 tensor, n0 contiguous, for boxes
// of (b2, b1, b0) floats. cuTensorMapEncodeTiled lives in libcuda; it is
// looked up once at run time, so the library does not link against libcuda.
// A refusal by libcuda comes back as kEncodeError + its CUresult
// (kernels/build.py::check tells it from a runtime error).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
constexpr int kEncodeError = 100000;

inline int box_map(CUtensorMap* map, const float* in, long long n2, long long n1, long long n0,
                   int b2, int b1, int b0) {
  static std::once_flag once;
  static EncodeTiled encode = nullptr;
  static int lookup = 0;
  std::call_once(once, [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess)
      lookup = (int)err;
    else if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      lookup = (int)cudaErrorNotSupported;
    else
      encode = reinterpret_cast<EncodeTiled>(fn);
  });
  if (encode == nullptr) return lookup;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 4, (cuuint64_t)n1 * n0 * 4};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(in), dims,
                              strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

// The map of a (gz, gy, gx) carry for boxes of one plane's (rows, cols) slab.
inline int slab_map(CUtensorMap* map, const float* in, int gz, int gy, int gx, int rows,
                    int cols) {
  return box_map(map, in, gz, gy, gx, 1, rows, cols);
}

}  // namespace
