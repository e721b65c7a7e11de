// The dynamic shared-memory opt-in of the port's kernels, made once per
// process, kernel and device instead of on every launch, and the size of a
// persistent grid.
//
// A kernel that takes more than 48 KB of dynamic shared memory needs
// cudaFuncAttributeMaxDynamicSharedMemorySize raised first.  The call costs
// host time on every launch of a served model's small kernels, and the
// attribute only lets a launch ask for that much: each launch still states
// what it uses, which alone sets its occupancy.  So every kernel is allowed
// the block's whole limit once.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
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

// Blocks of the persistent grid of `kernel` on the current device: as many
// as fit at once, cached per device, kernel and shape (the occupancy query
// costs host time).
inline cudaError_t grid_blocks(const void* kernel, int threads, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = known[key] = sms * per_sm;
  return cudaSuccess;
}

}  // namespace fvt_smem
