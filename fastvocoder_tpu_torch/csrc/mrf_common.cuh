// Building blocks shared by the MRF-stage kernel (fused_mrf.cu) and the
// HiFiGAN-tail kernel (fused_tail.cu).
//
// A HiFiGAN MRF stage is the mean over branches (ResBlock1, kernel sizes
// 3 / 7 / 11) of a chain of pairs, each
//
//     h' = h + conv2_K2(leaky(conv1_K1,d(leaky(h)) + b1)) + b2
//
// with leaky slope 0.1 and zero "same" padding on every conv's own input,
// over x (B, T, C) float32, channels last.  Both kernels run a stage as one
// launch per pair position, all branches of that position at once, one
// branch per blockIdx.z (`launch_pairs`), each writing the branch's h' to
// scratch; a last, memory-bound launch folds the branches' mean (and, in
// the tail, the output head).  In a pair launch a block owns R output rows
// of one sequence:
//   * it stages leaky(h) over the rows the pair needs (R + 2 (m1 + m2)
//     rows, m1 = (K1-1)/2 d, m2 = (K2-1)/2), writing zeros for rows outside
//     [0, T): that is each conv's zero padding;
//   * it computes u = leaky(conv1 + b1) over R + 2 m2 rows, zeroed outside
//     [0, T), in shared memory;
//   * it computes conv2 + b2 over its R rows in registers and adds the
//     residual h, read back from device memory.
// R is chosen so that every thread holds at most kRowsPerThread rows of
// both convs: one pass, no loop over rows.
//
// The contraction runs on the CUDA cores in float32: each thread owns 4
// output channels of kRowsPerThread rows, so one 16-byte weight load feeds
// kRowsPerThread * 4 FMAs and one broadcast 16-byte shared load feeds 16.
// Weights are laid out (tap, c_in, c_out) and stream from L2.

#pragma once

#include <cuda_runtime.h>

namespace fvt_mrf {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kMaxBranches = 4;
constexpr int kMaxPairs = 8;
constexpr float kSlope = 0.1f;  // leaky-relu slope of HiFiGAN's resblocks
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// rows of one pass of all threads at width C (8192 / C)
__host__ __device__ constexpr int pass_rows(int C) {
  return kThreads / (C / 4) * kRowsPerThread;
}

__host__ __device__ inline int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

__device__ __forceinline__ float4 leaky4(float4 v, float slope) {
  return make_float4(leaky(v.x, slope), leaky(v.y, slope), leaky(v.z, slope),
                     leaky(v.w, slope));
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc[j] += sum_{ci < cin} smem[off[j] + ci] * W[ci, col .. col+3], with W
// (cin, COUT) row-major in device memory.
template <int COUT>
__device__ __forceinline__ void rows_times_weight(float4 (&acc)[kRowsPerThread],
                                                  const float* smem,
                                                  const int (&off)[kRowsPerThread],
                                                  const float* __restrict__ W, int cin,
                                                  int col) {
#pragma unroll 2
  for (int ci = 0; ci < cin; ci += 4) {
    const float* wp = W + static_cast<size_t>(ci) * COUT + col;
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + COUT));
    const float4 w2 = __ldg(reinterpret_cast<const float4*>(wp + 2 * COUT));
    const float4 w3 = __ldg(reinterpret_cast<const float4*>(wp + 3 * COUT));
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(smem + off[j] + ci);
      fma4(acc[j], a.x, w0);
      fma4(acc[j], a.y, w1);
      fma4(acc[j], a.z, w2);
      fma4(acc[j], a.w, w3);
    }
  }
}

// One pair position of up to kMaxBranches branches.
struct PairArgs {
  const float* src[kMaxBranches];  // (B, T, C): the pair's input h
  float* dst[kMaxBranches];        // (B, T, C): h', for launches that store it
  const float* w1[kMaxBranches];   // (K1, C, C)
  const float* b1[kMaxBranches];   // (C,)
  const float* w2[kMaxBranches];   // (K2, C, C)
  const float* b2[kMaxBranches];   // (C,)
  int k1[kMaxBranches];
  int dil[kMaxBranches];
  int k2[kMaxBranches];
};

__host__ __device__ inline int margin1(const PairArgs& a, int br) {
  return (a.k1[br] - 1) / 2 * a.dil[br];
}
__host__ __device__ inline int margin2(const PairArgs& a, int br) {
  return (a.k2[br] - 1) / 2;
}

// Pair `br` of `a` on the rows o_lo .. o_lo + no - 1 of sequence `b`
// (no + 2 m2 <= pass_rows(C)).  Leaves in t[j] the value
//     conv2(u) + b2 at row o_lo + rgroup + j * groups,
// zero where that row lies outside [0, T).  hs holds no + 2 (m1 + m2) rows,
// us no + 2 m2 rows.
template <int C>
__device__ __forceinline__ void pair_rows(const PairArgs& a, int br, int b, int T, int o_lo,
                                          int no, float* hs, float* us,
                                          float4 (&t)[kRowsPerThread]) {
  constexpr int C4 = C / 4;
  constexpr int kGroups = kThreads / C4;
  const int col = (threadIdx.x % C4) * 4;
  const int rgroup = threadIdx.x / C4;
  const int K1 = a.k1[br], d = a.dil[br], K2 = a.k2[br];
  const int m1 = margin1(a, br), m2 = margin2(a, br);
  const int u_lo = o_lo - m2, nu = no + 2 * m2;
  const int g_lo = u_lo - m1, nh = nu + 2 * m1;

  // stage leaky(h) with zeros outside [0, T)
  {
    const float* src = a.src[br] + static_cast<size_t>(b) * T * C;
    for (int i = threadIdx.x; i < nh * C4; i += kThreads) {
      const int g = g_lo + i / C4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T) {
        v = leaky4(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * C) +
                         i % C4),
                   kSlope);
      }
      reinterpret_cast<float4*>(hs)[i] = v;
    }
  }
  __syncthreads();

  // u = leaky(b1 + sum_k W1[k]^T leaky(h)[r + (k - half) d]), zero outside [0, T)
  {
    float4 acc[kRowsPerThread];
    int off[kRowsPerThread];
    const float4 bias = __ldg(reinterpret_cast<const float4*>(a.b1[br] + col));
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = bias;
    for (int k = 0; k < K1; ++k) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        // u row i reads h rows i + k d (h starts m1 = half d rows earlier)
        off[j] = (min(rgroup + j * kGroups, nu - 1) + k * d) * C;
      }
      rows_times_weight<C>(acc, hs, off, a.w1[br] + static_cast<size_t>(k) * C * C, C, col);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int i = rgroup + j * kGroups;
      if (i < nu) {
        const int g = u_lo + i;
        const float4 v = (g >= 0 && g < T) ? leaky4(acc[j], kSlope)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(us + i * C + col) = v;
      }
    }
  }
  __syncthreads();

  // t = b2 + sum_k W2[k]^T u[r + k - m2], zero outside [0, T)
  {
    int off[kRowsPerThread];
    const float4 bias = __ldg(reinterpret_cast<const float4*>(a.b2[br] + col));
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) t[j] = bias;
    for (int k = 0; k < K2; ++k) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        off[j] = (min(rgroup + j * kGroups, no - 1) + k) * C;
      }
      rows_times_weight<C>(t, us, off, a.w2[br] + static_cast<size_t>(k) * C * C, C, col);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int g = o_lo + rgroup + j * kGroups;
      if (g < 0 || g >= T) t[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// h' = h + t for one pair position of every branch (blockIdx.z = branch);
// block x owns rows [x R, x R + R) of sequence blockIdx.y.  The body of each
// library's pair kernel (`FVT_PAIR_KERNEL`), which names it after its
// library, so that a profile tells the MRF's launches from the tail's.
template <int C>
__device__ __forceinline__ void pair_body(const PairArgs& a, int T, int R, int u_off,
                                          float* smem) {
  constexpr int C4 = C / 4;
  constexpr int kGroups = kThreads / C4;
  const int br = blockIdx.z, b = blockIdx.y;
  const int q0 = blockIdx.x * R;
  float4 t[kRowsPerThread];
  pair_rows<C>(a, br, b, T, q0, R, smem, smem + u_off, t);
  const int col = (threadIdx.x % C4) * 4;
  const size_t base = static_cast<size_t>(b) * T * C;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int i = threadIdx.x / C4 + j * kGroups;
    const int g = q0 + i;
    if (i < R && g < T) {
      const size_t at = base + static_cast<size_t>(g) * C + col;
      const float4 h = __ldg(reinterpret_cast<const float4*>(a.src[br] + at));
      *reinterpret_cast<float4*>(a.dst[br] + at) = add4(h, t[j]);
    }
  }
}

typedef void (*PairKernel)(PairArgs, int, int, int);

#define FVT_PAIR_KERNEL(name)                                                   \
  template <int C>                                                              \
  __global__ void __launch_bounds__(fvt_mrf::kThreads, 2)                       \
  name(fvt_mrf::PairArgs a, int T, int R, int u_off) {                          \
    extern __shared__ __align__(16) float smem[];                               \
    fvt_mrf::pair_body<C>(a, T, R, u_off, smem);                                \
  }

// Block size and launch geometry of one stage, from its pairs' margins.
struct StagePlan {
  int R;          // output rows of a block
  int u_off;      // floats from the start of shared memory to the u buffer
  int smem;       // bytes of dynamic shared memory (staging + u)
};

// R <= 0 when the margins leave no room in one pass.
inline StagePlan plan_stage(int C, const PairArgs* steps, int n_steps, int nb) {
  int max_m2 = 0, max_m = 0;
  for (int p = 0; p < n_steps; ++p) {
    for (int br = 0; br < nb; ++br) {
      const int m1 = margin1(steps[p], br), m2 = margin2(steps[p], br);
      max_m2 = max_m2 > m2 ? max_m2 : m2;
      max_m = max_m > m1 + m2 ? max_m : m1 + m2;
    }
  }
  StagePlan plan;
  plan.R = pass_rows(C) - 2 * max_m2;
  const int staged = plan.R + 2 * max_m;
  plan.u_off = staged * C;
  plan.smem = static_cast<int>(sizeof(float)) * (staged + pass_rows(C)) * C;
  return plan;
}

// Fills steps[p] from the C entry points' table: per (branch, pair),
// branch-major, ints (K1, dilation, K2) and device pointers (w1 (K1, C, C),
// b1 (C,), w2 (K2, C, C), b2 (C,)).  Kernel sizes must be odd.
inline cudaError_t load_steps(PairArgs* steps, int nb, int np, const int* ints,
                              const float* const* weights) {
  if (nb < 1 || nb > kMaxBranches || np < 1 || np > kMaxPairs) return cudaErrorInvalidValue;
  for (int br = 0; br < nb; ++br) {
    for (int p = 0; p < np; ++p) {
      const int* v = ints + 3 * (br * np + p);
      const float* const* w = weights + 4 * (br * np + p);
      if (v[0] < 1 || v[0] % 2 == 0 || v[1] < 1 || v[2] < 1 || v[2] % 2 == 0) {
        return cudaErrorInvalidValue;
      }
      steps[p].k1[br] = v[0];
      steps[p].dil[br] = v[1];
      steps[p].k2[br] = v[2];
      steps[p].w1[br] = w[0];
      steps[p].b1[br] = w[1];
      steps[p].w2[br] = w[2];
      steps[p].b2[br] = w[3];
    }
  }
  return cudaSuccess;
}

// Runs the np pair positions of every branch on x (B, T, C), one launch of
// `kernel` (a FVT_PAIR_KERNEL at C) each, writing h' to scratch (2 nb B T C
// floats: two sets of nb buffers used in turn).  The branches' outputs end
// in set (np - 1) % 2: buffer br at scratch + ((np - 1) % 2 * nb + br) B T C.
template <int C, PairKernel kernel>
cudaError_t launch_pairs(PairArgs* steps, int nb, int np, const float* x, float* scratch,
                         int B, int T, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T * C;
  for (int p = 0; p < np; ++p) {
    for (int br = 0; br < nb; ++br) {
      steps[p].src[br] = p == 0 ? x : scratch + (((p - 1) % 2) * nb + br) * n;
      steps[p].dst[br] = scratch + ((p % 2) * nb + br) * n;
    }
  }
  const StagePlan plan = plan_stage(C, steps, np, nb);
  if (plan.R < 1 || plan.smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + plan.R - 1) / plan.R, B, nb);
  for (int p = 0; p < np; ++p) {
    kernel<<<grid, kThreads, plan.smem, stream>>>(steps[p], T, plan.R, plan.u_off);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The mean of the nb branch outputs at element i: (((b0 + b1) + b2) ...) / nb,
// the plain version's order.
__device__ __forceinline__ float4 branch_mean4(const float* out, size_t n, int nb, size_t i) {
  float4 s = __ldg(reinterpret_cast<const float4*>(out) + i);
  for (int br = 1; br < nb; ++br) {
    s = add4(s, __ldg(reinterpret_cast<const float4*>(out + br * n) + i));
  }
  const float f = static_cast<float>(nb);
  return make_float4(s.x / f, s.y / f, s.z / f, s.w / f);
}

}  // namespace fvt_mrf
