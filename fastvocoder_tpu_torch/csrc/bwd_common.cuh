// Building blocks shared by the two backward kernels of the port: the MRF
// stage's (fused_mrf_bwd.cu) and the residual-stack chain's
// (fused_resstack_bwd.cu), besides the tensor-core passes of
// mma_common.cuh.
//
//   * `wgrad_reduce_kernel`: the second stage of a weight gradient.  A CUDA
//     grid does not run in order, so `fvt_mma::wgrad_body` splits the B T
//     rows of dW = sum in^T dy over S blocks per group of dW, each block
//     writes its partial sums to scratch, and this launch adds the S
//     partials in a fixed order.  No atomics: dW is the same from run to
//     run.
//   * `divide_kernel`, `sum_kernel`: the elementwise passes around an MRF
//     stage's branches (g / n_branches in, the branches' dx summed out).

#pragma once

#include <cuda_runtime.h>

namespace fvt_bwd {

constexpr int kThreads = 256;
constexpr int kMaxZ = 4;
constexpr int kTargetBlocks = 528;  // blocks a wgrad launch aims at: 4 per SM
constexpr int kMaxSplits = 1024;

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Up to kMaxZ weight gradients of one launch.  For conv z:
//   dW[k][ci][co] = sum_{b, r} in_z(b, r + (k - half) dil)[ci] dy[b][r][co]
//   db[co]        = sum_{b, r} dy[b][r][co]
// with in_z = leaky(a, slope) inside [0, T), zero outside or, with
// `reflect`, the mirrored row.  part holds S partial sums of K C C + C
// floats each (dW, then db).
struct WgradArgs {
  const float* a[kMaxZ];
  const float* dy[kMaxZ];
  float* part[kMaxZ];
  float* dw[kMaxZ];
  float* db[kMaxZ];  // or null
  int K[kMaxZ];
  int dil[kMaxZ];
  int reflect[kMaxZ];
  float slope[kMaxZ];
};

// dw, db = the S partials of each conv added in order.
template <int C>
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(WgradArgs w, int S) {
  const int z = blockIdx.y;
  const int nw = w.K[z] * C * C;
  const int total = nw + C;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    float s = 0.0f;
    for (int p = 0; p < S; ++p) s += w.part[z][static_cast<size_t>(p) * total + i];
    if (i < nw) {
      w.dw[z][i] = s;
    } else if (w.db[z] != nullptr) {
      w.db[z][i - nw] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// elementwise passes
// ---------------------------------------------------------------------------

// y = x / f over n floats (n % 4 == 0)
__global__ void __launch_bounds__(kThreads)
divide_kernel(const float* __restrict__ x, float f, size_t n, float* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    reinterpret_cast<float4*>(y)[i] = make_float4(v.x / f, v.y / f, v.z / f, v.w / f);
  }
}

struct SumArgs {
  const float* src[kMaxZ];
};

// y = src[0] + src[1] + ... (nz buffers of n floats, n % 4 == 0)
__global__ void __launch_bounds__(kThreads)
sum_kernel(SumArgs a, int nz, size_t n, float* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    float4 s = __ldg(reinterpret_cast<const float4*>(a.src[0]) + i);
    for (int z = 1; z < nz; ++z) s = add4(s, __ldg(reinterpret_cast<const float4*>(a.src[z]) + i));
    reinterpret_cast<float4*>(y)[i] = s;
  }
}

inline unsigned elementwise_blocks(size_t n) {
  const size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1056 ? (blocks < 1 ? 1 : blocks) : 1056);
}

}  // namespace fvt_bwd
