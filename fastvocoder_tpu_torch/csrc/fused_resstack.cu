// One MelGAN-family upsample stage: a chain of ResidualStacks in one launch.
//
// Replaces: fastvocoder_tpu/ops/fused_resstack.py::_chain_kernel (driven by
// `_run_interior_fwd`), forward only.
//
// Each stack s (dilation d, odd kernel K, margin m = (K-1)/2 * d) maps
//
//     t = leaky(h); t = reflect_pad(t, m); t = conv_K,d(t) + bd
//     h' = conv_1x1(leaky(t)) + b1 + conv_1x1_skip(h) + bs
//
// over x (B, T, C) float32, channels last.  The TPU kernel computed only the
// valid interior and left the sequence edges to XLA, because reflect padding
// does not commute through the fused chain.  Here every stack mirrors its
// own input at the sequence edges inside the kernel, so one launch covers
// any T the module path accepts.
//
// Bound on an H100: operations.  A row costs 2 * n * (K + 2) * C^2 FLOP
// (30 C^2 for 3 stacks at K = 3), about 18 GFLOP for the 9,360-row stage
// at C = 256, against 19 MB of input and output.  This first version runs
// the contraction on the CUDA cores in float32:
//   * a block owns kRowsPerBlock output rows and stages them with a halo of
//     M = sum of margins rows each side in shared memory, so the chain's
//     intermediates never touch device memory (at C = 256: 3 buffers of
//     58 rows, 174 KiB, dynamic shared memory);
//   * stack s is computed over the rows that later stacks still need (the
//     tile widened by their margins, clipped to [0, T)); a tap that falls
//     outside [0, T) reads the mirrored row, which by construction lies in
//     the staged range;
//   * each thread owns 4 output channels of kRowsPerThread rows, so one
//     16-byte weight load feeds kRowsPerThread * 4 FMAs and one broadcast
//     16-byte shared load feeds 16.  Weights stream from L2.
// Tensor cores (wgmma) and TMA staging are left for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kMaxStacks = 4;
constexpr float kSlope = 0.2f;  // leaky-relu slope of MelGAN's stacks

struct ChainArgs {
  const float* wd[kMaxStacks];  // (K, C, C): tap, c_in, c_out
  const float* bd[kMaxStacks];  // (C,)
  const float* w1[kMaxStacks];  // (C, C): c_in, c_out
  const float* b1[kMaxStacks];
  const float* ws[kMaxStacks];  // skip (C, C)
  const float* bs[kMaxStacks];
  int dil[kMaxStacks];
  int n;
  int K;
  int M;  // sum of the stacks' margins
};

// numpy / torch "reflect" extension of [0, T) to any index
__device__ __forceinline__ int reflect_index(int i, int T) {
  if (T == 1) return 0;
  const int p = 2 * (T - 1);
  i %= p;
  if (i < 0) i += p;
  return i >= T ? p - i : i;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.0f ? v : v * kSlope; }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// acc[j] += sum_ci smem[off[j] + ci] * W[ci, col .. col+3]
__device__ __forceinline__ void rows_times_weight(
    float4 (&acc)[kRowsPerThread], const float* smem, const int (&off)[kRowsPerThread],
    const float* __restrict__ W, int C, int col) {
#pragma unroll 2
  for (int ci = 0; ci < C; ci += 4) {
    const float* wp = W + static_cast<size_t>(ci) * C + col;
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + C));
    const float4 w2 = __ldg(reinterpret_cast<const float4*>(wp + 2 * C));
    const float4 w3 = __ldg(reinterpret_cast<const float4*>(wp + 3 * C));
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

__global__ void __launch_bounds__(kThreads, 1)
fused_resstacks_kernel(const float* __restrict__ x, float* __restrict__ y, int T, int C,
                       ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int rows_cap = kRowsPerBlock + 2 * a.M;
  // three row buffers, each indexed by (global row - g_lo):
  //   h: the stack's input; l: leaky(h), then the stack's output; u: the
  //   dilated conv's activated output
  int h = 0, l = rows_cap * C;
  const int u = 2 * rows_cap * C;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int q1 = min(T, q0 + kRowsPerBlock);
  const int g_lo = max(0, q0 - a.M);
  const int g_hi = min(T, q1 + a.M);
  const int C4 = C / 4;
  const int col = (threadIdx.x % C4) * 4;
  const int rgroup = threadIdx.x / C4;
  const int ngroups = kThreads / C4;
  const int pass_rows = ngroups * kRowsPerThread;

  {
    const float4* src = reinterpret_cast<const float4*>(x + (static_cast<size_t>(b) * T + g_lo) * C);
    float4* dst = reinterpret_cast<float4*>(smem + h);
    for (int i = threadIdx.x; i < (g_hi - g_lo) * C4; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();

  int reach = a.M;  // rows of h valid on each side of the tile: [q0-reach, q1+reach)
  for (int s = 0; s < a.n; ++s) {
    const int d = a.dil[s];
    const int half = (a.K - 1) / 2;
    const int in_lo = max(0, q0 - reach), in_hi = min(T, q1 + reach);
    reach -= half * d;
    const int lo = max(0, q0 - reach), hi = min(T, q1 + reach);

    for (int i = threadIdx.x; i < (in_hi - in_lo) * C; i += kThreads) {
      const int k = (in_lo - g_lo) * C + i;
      smem[l + k] = leaky(smem[h + k]);
    }
    __syncthreads();

    // u = leaky(bd + sum_k Wd[k]^T leaky(h)[reflect(r + (k - half) * d)])
    for (int base = lo; base < hi; base += pass_rows) {
      float4 acc[kRowsPerThread];
      int off[kRowsPerThread];
      const float4 bias = __ldg(reinterpret_cast<const float4*>(a.bd[s] + col));
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[j] = bias;
      for (int k = 0; k < a.K; ++k) {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = min(base + rgroup + j * ngroups, hi - 1);
          off[j] = l + (reflect_index(r + (k - half) * d, T) - g_lo) * C;
        }
        rows_times_weight(acc, smem, off, a.wd[s] + static_cast<size_t>(k) * C * C, C, col);
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = base + rgroup + j * ngroups;
        if (r < hi) {
          float4 v = acc[j];
          v.x = leaky(v.x);
          v.y = leaky(v.y);
          v.z = leaky(v.z);
          v.w = leaky(v.w);
          *reinterpret_cast<float4*>(smem + u + (r - g_lo) * C + col) = v;
        }
      }
    }
    __syncthreads();

    // stack output = b1 + bs + W1^T u[r] + Ws^T h[r], written over l
    for (int base = lo; base < hi; base += pass_rows) {
      float4 acc[kRowsPerThread];
      int off[kRowsPerThread];
      const float4 c1 = __ldg(reinterpret_cast<const float4*>(a.b1[s] + col));
      const float4 cs = __ldg(reinterpret_cast<const float4*>(a.bs[s] + col));
      const float4 bias = make_float4(c1.x + cs.x, c1.y + cs.y, c1.z + cs.z, c1.w + cs.w);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        acc[j] = bias;
        off[j] = u + (min(base + rgroup + j * ngroups, hi - 1) - g_lo) * C;
      }
      rows_times_weight(acc, smem, off, a.w1[s], C, col);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) off[j] += h - u;
      rows_times_weight(acc, smem, off, a.ws[s], C, col);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = base + rgroup + j * ngroups;
        if (r < hi) *reinterpret_cast<float4*>(smem + l + (r - g_lo) * C + col) = acc[j];
      }
    }
    __syncthreads();
    const int t = h;
    h = l;
    l = t;
  }

  {
    const float4* src = reinterpret_cast<const float4*>(smem + h + (q0 - g_lo) * C);
    float4* dst = reinterpret_cast<float4*>(y + (static_cast<size_t>(b) * T + q0) * C);
    for (int i = threadIdx.x; i < (q1 - q0) * C4; i += kThreads) dst[i] = src[i];
  }
}

}  // namespace

extern "C" int fvt_fused_resstacks_smem_bytes(int C, int M) {
  return static_cast<int>(sizeof(float)) * 3 * (kRowsPerBlock + 2 * M) * C;
}

extern "C" int fvt_fused_resstacks_max_stacks() { return kMaxStacks; }

// x, y (B, T, C) float32 contiguous; C in {32, 64, 128, 256}.  dil: n host
// ints.  weights: 6 * n host pointers to device float32 arrays, per stack
// (wd (K, C, C), bd (C,), w1 (C, C), b1 (C,), ws (C, C), bs (C,)), each
// 16-byte aligned.  Returns the CUDA error of the launch (0 = ok).
extern "C" int fvt_fused_resstacks(const float* x, float* y, int B, int T, int C, int n,
                                   int K, const int* dil, const float* const* weights,
                                   void* stream) {
  if (n < 1 || n > kMaxStacks || K < 1 || K % 2 == 0 || C % 4 != 0 ||
      kThreads % (C / 4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainArgs a;
  a.n = n;
  a.K = K;
  a.M = 0;
  for (int s = 0; s < n; ++s) {
    a.wd[s] = weights[6 * s + 0];
    a.bd[s] = weights[6 * s + 1];
    a.w1[s] = weights[6 * s + 2];
    a.b1[s] = weights[6 * s + 3];
    a.ws[s] = weights[6 * s + 4];
    a.bs[s] = weights[6 * s + 5];
    a.dil[s] = dil[s];
    a.M += (K - 1) / 2 * dil[s];
  }
  const int smem = fvt_fused_resstacks_smem_bytes(C, a.M);
  cudaError_t err = cudaFuncSetAttribute(
      fused_resstacks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock, B);
  fused_resstacks_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, T, C, a);
  return static_cast<int>(cudaGetLastError());
}
