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
//   * `widen_body`, `narrow_body`: the conversions of the bf16 forms of
//     both backward kernels.  A bf16 form widens its bf16 x, g, weights and
//     biases into float32 scratch (exact), runs the float32 form's passes
//     on them, and rounds dx and every dW and db to bf16 once, to nearest
//     even.  Each library names its own conversion kernels
//     (`FVT_BWD_WIDEN_KERNEL`, `FVT_BWD_NARROW_KERNEL`), so that a profile
//     files them under their kernel.

#pragma once

#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// the bf16 forms' conversions
// ---------------------------------------------------------------------------

constexpr int kMaxConvert = 32;  // buffers of one conversion launch: blockIdx.y

// buffer z: n[z] elements from src[z] to dst[z]
struct ConvertArgs {
  const void* src[kMaxConvert];
  void* dst[kMaxConvert];
  long long n[kMaxConvert];
};

// bf16 -> float32, exact
__device__ __forceinline__ void widen_body(const ConvertArgs& a) {
  const int z = blockIdx.y;
  const __nv_bfloat16* __restrict__ src = static_cast<const __nv_bfloat16*>(a.src[z]);
  float* __restrict__ dst = static_cast<float*>(a.dst[z]);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < a.n[z];
       i += stride) {
    dst[i] = __bfloat162float(src[i]);
  }
}

// float32 -> bf16, rounded to nearest even
__device__ __forceinline__ void narrow_body(const ConvertArgs& a) {
  const int z = blockIdx.y;
  const float* __restrict__ src = static_cast<const float*>(a.src[z]);
  __nv_bfloat16* __restrict__ dst = static_cast<__nv_bfloat16*>(a.dst[z]);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < a.n[z];
       i += stride) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

#define FVT_BWD_WIDEN_KERNEL(name)                                                 \
  __global__ void __launch_bounds__(fvt_bwd::kThreads) name(fvt_bwd::ConvertArgs a) { \
    fvt_bwd::widen_body(a);                                                        \
  }

#define FVT_BWD_NARROW_KERNEL(name)                                                \
  __global__ void __launch_bounds__(fvt_bwd::kThreads) name(fvt_bwd::ConvertArgs a) { \
    fvt_bwd::narrow_body(a);                                                       \
  }

typedef void (*ConvertKernel)(ConvertArgs);

// `kernel` (a FVT_BWD_WIDEN_KERNEL or FVT_BWD_NARROW_KERNEL) over `count`
// buffers, kMaxConvert a launch
inline cudaError_t launch_convert(ConvertKernel kernel, const void* const* src,
                                  void* const* dst, const long long* n, int count,
                                  cudaStream_t stream) {
  for (int first = 0; first < count; first += kMaxConvert) {
    ConvertArgs a;
    const int m = count - first < kMaxConvert ? count - first : kMaxConvert;
    long long most = 1;
    for (int i = 0; i < m; ++i) {
      a.src[i] = src[first + i];
      a.dst[i] = dst[first + i];
      a.n[i] = n[first + i];
      most = most > a.n[i] ? most : a.n[i];
    }
    const long long blocks = (most + kThreads - 1) / kThreads;
    kernel<<<dim3(static_cast<unsigned>(blocks < 1024 ? blocks : 1024), m), kThreads, 0,
             stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace fvt_bwd
