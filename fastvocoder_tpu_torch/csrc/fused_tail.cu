// The last HiFiGAN stage and the output head, forward only.
//
// Replaces: fastvocoder_tpu/ops/fused_tail.py::_tail_kernel (driven by
// `fused_hifigan_tail`).
//
//     y = tanh(conv_post(leaky_0.01(MRF(conv_transpose_u(leaky_0.1(x))))))
//
// over x (B, T_in, C_in) float32, channels last, to y (B, u T_in, bands):
// the transposed conv (kernel K, stride u, padding p) maps output row t to
// the input rows (t + p - k) / u of its taps k = (t + p) mod u, +u, ...
// below K; the MRF is the stage of mrf_common.cuh at C = C_out; conv_post
// has an odd kernel Kp and zero "same" padding; every conv zero-pads its own
// input.  C_out in {16, 32, 64, 128, 256}, C_in a multiple of 4, any
// T_in >= 1, any B; u must divide the row groups of a block (u = 2 in
// HiFiGAN).
//
// Bound on an H100: operations.  The MRF dominates: 252 C^2 FLOP a row, 9.1
// GFLOP at (1, 140400, 16) for a 585-frame utterance, plus 0.3 GFLOP of
// upsampling and 0.03 of conv_post, against 9 MB read and 0.56 MB written.
//
// The TPU kernel computed the whole tail from VMEM over one row-aligned
// tile.  Here the stage runs as
//   * one launch of the upsample: each block stages leaky(x) over the input
//     rows its R output rows read, zeros outside [0, T_in), and each thread
//     computes 4 channels of 8 output rows that share one phase (t + p) mod
//     u, so they share their taps; h0 goes to scratch;
//   * the MRF's pair launches (`launch_pairs`), as in fused_mrf.cu;
//   * the head: each block folds the branches' mean over its rows plus the
//     (Kp - 1) / 2 rows each side that conv_post reads, zero outside
//     [0, T) (conv_post's padding), applies leaky(0.01) into shared memory
//     (rows padded to C + 1 floats, so the head's threads, one per output
//     row and band, read different banks), and writes tanh(conv_post) once.

#include "mrf_common.cuh"

namespace {

using namespace fvt_mrf;

constexpr int kMaxBands = 4;
constexpr float kHeadSlope = 0.01f;  // torch's default slope before conv_post

// the input rows [lo, lo + n) that output rows [q0, q0 + R) read
__host__ __device__ inline int up_lo(int q0, int K, int u, int pad) {
  return floor_div(q0 + pad - (K - 1), u);
}
__host__ __device__ inline int up_rows(int R, int K, int u) { return (R + K - 2) / u + 2; }

FVT_PAIR_KERNEL(tail_pair_kernel)

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tail_upsample_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, int T_in, int cin,
                     int K, int u, int pad) {
  extern __shared__ __align__(16) float smem[];
  constexpr int C4 = C / 4;
  constexpr int kGroups = kThreads / C4;
  constexpr int R = pass_rows(C);
  const int T = T_in * u;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int i_lo = up_lo(q0, K, u, pad);
  const int ni = floor_div(q0 + R - 1 + pad, u) + 1 - i_lo;
  const int cin4 = cin / 4;
  {
    const float* src = x + static_cast<size_t>(b) * T_in * cin;
    for (int i = threadIdx.x; i < ni * cin4; i += kThreads) {
      const int g = i_lo + i / cin4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T_in) {
        v = leaky4(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * cin) +
                         i % cin4),
                   kSlope);
      }
      reinterpret_cast<float4*>(smem)[i] = v;
    }
  }
  __syncthreads();

  const int col = (threadIdx.x % C4) * 4;
  const int rgroup = threadIdx.x / C4;
  float4 acc[kRowsPerThread];
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + col));
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = b4;
  // rows rgroup + j kGroups share the phase, as u divides kGroups
  for (int k = (q0 + rgroup + pad) % u; k < K; k += u) {
    int off[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int t = q0 + rgroup + j * kGroups;
      off[j] = ((t + pad - k) / u - i_lo) * cin;  // exact division: t + pad - k = 0 mod u
    }
    rows_times_weight<C>(acc, smem, off, w + static_cast<size_t>(k) * cin * C, cin, col);
  }
  const size_t base = static_cast<size_t>(b) * T * C;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int t = q0 + rgroup + j * kGroups;
    if (t < T) *reinterpret_cast<float4*>(y + base + static_cast<size_t>(t) * C + col) = acc[j];
  }
}

// output rows of a head block (its shared memory: (R + Kp - 1) (C + 1) floats)
__host__ __device__ constexpr int head_rows(int C) { return 4096 / C; }

template <int C>
__global__ void __launch_bounds__(kThreads)
tail_head_kernel(const float* __restrict__ out, size_t n, int nb, int T,
                 const float* __restrict__ wp, const float* __restrict__ bp, int kp, int bands,
                 float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  constexpr int C4 = C / 4;
  constexpr int CP = C + 1;  // padded row of the head's input
  constexpr int R = head_rows(C);
  const int e = (kp - 1) / 2;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const size_t base4 = static_cast<size_t>(b) * T * C4;
  for (int i = threadIdx.x; i < (R + 2 * e) * C4; i += kThreads) {
    const int r = i / C4, c4 = i % C4;
    const int g = q0 - e + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < T) {
      v = leaky4(branch_mean4(out, n, nb, base4 + static_cast<size_t>(g) * C4 + c4), kHeadSlope);
    }
    float* row = smem + r * CP + c4 * 4;
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * bands; idx += kThreads) {
    const int r = idx / bands, ob = idx % bands;
    const int g = q0 + r;
    if (g >= T) continue;
    float acc = __ldg(bp + ob);
    for (int k = 0; k < kp; ++k) {
      const float* m = smem + (r + k) * CP;  // head input row g + k - e
      const float* wk = wp + static_cast<size_t>(k) * C * bands + ob;
#pragma unroll 4
      for (int c = 0; c < C; ++c) acc = fmaf(m[c], __ldg(wk + c * bands), acc);
    }
    y[(static_cast<size_t>(b) * T + g) * bands + ob] = tanhf(acc);
  }
}

template <int C>
cudaError_t run_tail(const float* x, float* y, float* scratch, int B, int T_in, int cin,
                     const float* w_up, const float* b_up, int k_up, int u, int pad, int nb,
                     int np, PairArgs* steps, const float* w_post, const float* b_post, int k_post,
                     int bands, cudaStream_t stream) {
  constexpr int kGroups = kThreads / (C / 4);
  if (kGroups % u != 0) return cudaErrorInvalidValue;
  const int T = T_in * u;
  const size_t n = static_cast<size_t>(B) * T * C;
  float* h0 = scratch + 2 * nb * n;

  const int up_smem = static_cast<int>(sizeof(float)) * up_rows(pass_rows(C), k_up, u) * cin;
  if (up_smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_upsample_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, up_smem);
  if (err != cudaSuccess) return err;
  tail_upsample_kernel<C><<<dim3((T + pass_rows(C) - 1) / pass_rows(C), B), kThreads, up_smem,
                            stream>>>(x, w_up, b_up, h0, T_in, cin, k_up, u, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_pairs<C, tail_pair_kernel<C>>(steps, nb, np, h0, scratch, B, T, stream);
  if (err != cudaSuccess) return err;

  const int head_smem = static_cast<int>(sizeof(float)) * (head_rows(C) + k_post - 1) * (C + 1);
  if (head_smem > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(tail_head_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             head_smem);
  if (err != cudaSuccess) return err;
  tail_head_kernel<C><<<dim3((T + head_rows(C) - 1) / head_rows(C), B), kThreads, head_smem,
                        stream>>>(scratch + ((np - 1) % 2) * nb * n, n, nb, T, w_post, b_post,
                                  k_post, bands, y);
  return cudaGetLastError();
}

}  // namespace

// x (B, T_in, cin) and y (B, stride * T_in, bands) float32 contiguous; C (the
// stage's width) in {16, 32, 64, 128, 256}, cin a multiple of 4.  scratch:
// (2 nb + 1) * B * stride * T_in * C floats.  w_up (k_up, cin, C), b_up (C,):
// the transposed conv, torch semantics with `pad`.  ints / weights: the MRF's
// nb branches of np pairs, as fvt_fused_mrf takes them.  w_post (k_post, C,
// bands), b_post (bands,), k_post odd, bands <= 4.  Device pointers 16-byte
// aligned.  Returns the first CUDA error of the launches (0 = ok).
extern "C" int fvt_fused_tail(const float* x, float* y, float* scratch, int B, int T_in,
                              int cin, int C, const float* w_up, const float* b_up, int k_up,
                              int stride, int pad, int nb, int np, const int* ints,
                              const float* const* weights, const float* w_post,
                              const float* b_post, int k_post, int bands, void* stream) {
  if (B < 1 || T_in < 1 || cin < 4 || cin % 4 != 0 || k_up < 1 || stride < 1 || pad < 0 ||
      k_post < 1 || k_post % 2 == 0 || bands < 1 || bands > kMaxBands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairArgs steps[kMaxPairs];
  cudaError_t err = load_steps(steps, nb, np, ints, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FVT_TAIL(CC)                                                                         \
  run_tail<CC>(x, y, scratch, B, T_in, cin, w_up, b_up, k_up, stride, pad, nb, np, steps, \
               w_post, b_post, k_post, bands, s)
  switch (C) {
    case 16: err = FVT_TAIL(16); break;
    case 32: err = FVT_TAIL(32); break;
    case 64: err = FVT_TAIL(64); break;
    case 128: err = FVT_TAIL(128); break;
    case 256: err = FVT_TAIL(256); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FVT_TAIL
  return static_cast<int>(err);
}

extern "C" int fvt_fused_tail_max_bands() { return kMaxBands; }
extern "C" int fvt_fused_tail_max_branches() { return kMaxBranches; }
extern "C" int fvt_fused_tail_max_pairs() { return kMaxPairs; }
