// The asynchronous copies from global into shared memory (cp.async) that
// the port's kernels stage their operands with: the tensor-core kernels
// through mma_common.cuh, the discriminators' grouped conv directly.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fvt_async {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
// the same copy, or 16 bytes of zeros where `valid` is false (gmem is not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
// waits until at most N of the thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

}  // namespace fvt_async
