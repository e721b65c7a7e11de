// The dynamic shared-memory opt-in of the port's kernels, made once per
// process, kernel and device instead of on every launch.
//
// A kernel that takes more than 48 KB of dynamic shared memory needs
// cudaFuncAttributeMaxDynamicSharedMemorySize raised first.  The call costs
// host time on every launch of a served model's small kernels, and the
// attribute only lets a launch ask for that much: each launch still states
// what it uses, which alone sets its occupancy.  So every kernel is allowed
// the block's whole limit once.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

namespace fvt_smem {

constexpr int kMaxSmem = 232448;  // dynamic shared memory an H100 block may use

// Lets `kernel` launch with up to kMaxSmem bytes of dynamic shared memory on
// the current device; a no-op after the first success for that pair.
inline cudaError_t allow_max_smem(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev}) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.insert({kernel, dev});
  return err;
}

}  // namespace fvt_smem
