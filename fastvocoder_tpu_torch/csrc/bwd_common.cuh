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
//     In the bf16 forms of both backward kernels it rounds every dW and db
//     to bf16 once, to nearest even, where its sum ends (`out_bf16`).
//   * `divide_kernel`, `sum_kernel`: the elementwise passes around an MRF
//     stage's branches (g / n_branches in, the branches' dx summed out);
//     the bf16 form reads g and writes dx in bf16 there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// floats each (dW, then db).  bf16[z] (the bf16 forms' passes only):
// kBf16In where a holds bf16, kBf16Dy where dy does; out_bf16: dw and db
// are bf16.
enum : int { kBf16In = 1, kBf16Dy = 2 };
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
  int bf16[kMaxZ] = {};
  int out_bf16 = 0;
};

// dw, db = the S partials of each conv added in order (rounded to bf16 once
// with out_bf16).
template <int C>
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(WgradArgs w, int S) {
  const int z = blockIdx.y;
  const int nw = w.K[z] * C * C;
  const int total = nw + C;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    float s = 0.0f;
    for (int p = 0; p < S; ++p) s += w.part[z][static_cast<size_t>(p) * total + i];
    float* out = i < nw ? w.dw[z] : w.db[z];
    const int at = i < nw ? i : i - nw;
    if (out == nullptr) continue;
    if (w.out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(s);
    } else {
      out[at] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// elementwise passes
// ---------------------------------------------------------------------------

// y = x / f over n floats (n % 4 == 0); x holds bf16 where x16
__global__ void __launch_bounds__(kThreads)
divide_kernel(const float* __restrict__ x, float f, size_t n, float* __restrict__ y, int x16) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    float4 v;
    if (x16) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(x) + i);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v = make_float4(a.x, a.y, b.x, b.y);
    } else {
      v = __ldg(reinterpret_cast<const float4*>(x) + i);
    }
    reinterpret_cast<float4*>(y)[i] = make_float4(v.x / f, v.y / f, v.z / f, v.w / f);
  }
}

struct SumArgs {
  const float* src[kMaxZ];
};

// y = src[0] + src[1] + ... (nz buffers of n floats, n % 4 == 0); y is
// bf16, rounded once, where y16
__global__ void __launch_bounds__(kThreads)
sum_kernel(SumArgs a, int nz, size_t n, float* __restrict__ y, int y16) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    float4 s = __ldg(reinterpret_cast<const float4*>(a.src[0]) + i);
    for (int z = 1; z < nz; ++z) s = add4(s, __ldg(reinterpret_cast<const float4*>(a.src[z]) + i));
    if (y16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
      reinterpret_cast<uint2*>(y)[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      reinterpret_cast<float4*>(y)[i] = s;
    }
  }
}

inline unsigned elementwise_blocks(size_t n) {
  const size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1056 ? (blocks < 1 ? 1 : blocks) : 1056);
}

}  // namespace fvt_bwd
