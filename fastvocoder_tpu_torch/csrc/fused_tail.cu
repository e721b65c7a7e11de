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
// below K; the MRF is a stage as fused_mrf.cu computes it, at C = C_out;
// conv_post has an odd kernel Kp and zero "same" padding; every conv
// zero-pads its own input.  C_out in {16, 32, 64, 128, 256}, C_in a
// multiple of 4, any T_in >= 1, any B; u must divide the row groups of an
// upsample block (u = 2 in HiFiGAN).
//
// Bound on an H100: operations.  The MRF dominates: 252 C^2 FLOP a row, 9.1
// GFLOP at (1, 140400, 16) for a 585-frame utterance, plus 0.3 GFLOP of
// upsampling and 0.03 of conv_post, against 9 MB read and 0.56 MB written.
// So the MRF contracts on the tensor cores in 3xTF32, on the pair body of
// mma_common.cuh that kernel 4 runs (split operands, each weight unit summed
// from zero in the tensor core and added on the CUDA cores in float32),
// which keeps float32 accuracy at a ceiling of 165 TFLOP/s instead of the
// CUDA cores' 67.
//
// The TPU kernel computed the whole tail from VMEM over one row-aligned
// tile.  Here the stage runs as
//   * one launch of the upsample on the CUDA cores (3 % of the work): each
//     block stages leaky(x) over the input rows its R output rows read,
//     zeros outside [0, T_in), and each thread computes 4 channels of 8
//     output rows that share one phase (t + p) mod u, so they share their
//     taps; h0 goes to scratch;
//   * one launch per pair position of the MRF, all branches at once
//     (`tail_pair_kernel`, blockIdx.z = branch), reading the kernels that
//     `fvt_fused_tail_pack` split and laid out once for a kept table, and
//     writing h' to scratch, as fused_mrf.cu does;
//   * the head: each block folds the branches' mean over its rows plus the
//     (Kp - 1) / 2 rows each side that conv_post reads, zero outside
//     [0, T) (conv_post's padding), applies leaky(0.01) into shared memory
//     (rows padded to C + 1 floats, so the head's threads, one per output
//     row and band, read different banks), and writes tanh(conv_post) once.
// The TPU kernel's own shape (one launch staging a tile plus the pairs'
// 60-row halo, every branch, the mean and the head in one block) was not
// taken: on an H100 kernel 4 runs this MRF at (1, 140400, 16) in 0.32-0.34
// ms (bin/kernel_times.py), of which the intermediates between its launches
// are about 0.06 ms of traffic (0.2 GB at 3.35 TB/s), so the contraction
// sets the pace and the halo's 12 % more operations would not pay.  Each
// kernel is allowed its shared memory once per process (smem_attr.cuh), not
// on every call.
//
// The bf16 form (`fvt_fused_tail_bf16`: `tail_upsample_bf16_kernel`,
// `tail_pair_bf16_kernel`, `tail_head_bf16_kernel`): x, y and the
// intermediates in bf16; the MRF's kernels packed as bf16 once for a kept
// table (`fvt_fused_tail_bf16_pack`), the upsample's and the head's weights
// and biases given as float32 holding bf16 values; float32 sums, rounded to
// bf16 where fused_tail.py's Pallas body rounds: the upsample's output, the
// MRF as in fused_mrf.cu, the branches' mean, the head's leaky-relu and its
// tanh (taken of the float32 sum).  Bound: the MRF's operations at 989
// TFLOP/s, the upsample's and the head's at the float32 rate.

#include "mma_common.cuh"
#include "mrf_common.cuh"

namespace {

using fvt_mma::bf16;
using fvt_mma::leaky_fit;
using fvt_mrf::kMaxBranches;
using fvt_mrf::kMaxPairs;
using fvt_mrf::kSlope;
using fvt_mrf::branch_mean4;

constexpr int kThreads = 256;       // threads of the upsample and the head
constexpr int kRowsPerThread = 8;   // output rows of an upsample thread
constexpr int kMaxBands = 4;
constexpr float kHeadSlope = 0.01f;  // torch's default slope before conv_post

// output rows of an upsample block at width C (8192 / C)
__host__ __device__ constexpr int pass_rows(int C) {
  return kThreads / (C / 4) * kRowsPerThread;
}

__host__ __device__ inline int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// the input rows [lo, lo + n) that output rows [q0, q0 + R) read
__host__ __device__ inline int up_lo(int q0, int K, int u, int pad) {
  return floor_div(q0 + pad - (K - 1), u);
}
__host__ __device__ inline int up_rows(int R, int K, int u) { return (R + K - 2) / u + 2; }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

// acc[j] += sum_{ci < cin} smem[off[j] + ci] * W[ci, col .. col+3], with W
// (cin, COUT) row-major in device memory: one 16-byte weight load feeds
// kRowsPerThread * 4 FMAs and one broadcast 16-byte shared load feeds 16.
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

FVT_MMA_PAIR_KERNEL(tail_pair_kernel)
FVT_MMA_BF16_PAIR_KERNEL(tail_pair_bf16_kernel)

template <typename E>
__device__ __forceinline__ float4 leaky4_fit(float4 v, float slope) {
  return make_float4(leaky_fit<E>(v.x, slope), leaky_fit<E>(v.y, slope),
                     leaky_fit<E>(v.z, slope), leaky_fit<E>(v.w, slope));
}

template <int C, typename E>
__device__ __forceinline__ void upsample_body(const E* __restrict__ x, const float* __restrict__ w,
                                              const float* __restrict__ bias, E* __restrict__ y,
                                              int T_in, int cin, int K, int u, int pad,
                                              float* smem) {
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
    const E* src = x + static_cast<size_t>(b) * T_in * cin;
    for (int i = threadIdx.x; i < ni * cin4; i += kThreads) {
      const int g = i_lo + i / cin4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T_in) {
        v = leaky4_fit<E>(fvt_mma::load4(src + static_cast<size_t>(g) * cin + 4 * (i % cin4)),
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
    if (t < T) fvt_mma::store4(y + base + static_cast<size_t>(t) * C + col, acc[j]);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tail_upsample_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, int T_in, int cin,
                     int K, int u, int pad) {
  extern __shared__ __align__(16) float smem[];
  upsample_body<C>(x, w, bias, y, T_in, cin, K, u, pad, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
tail_upsample_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, bf16* __restrict__ y, int T_in,
                          int cin, int K, int u, int pad) {
  extern __shared__ __align__(16) float smem[];
  upsample_body<C>(x, w, bias, y, T_in, cin, K, u, pad, smem);
}

// output rows of a head block (its shared memory: (R + Kp - 1) (C + 1) floats)
__host__ __device__ constexpr int head_rows(int C) { return 4096 / C; }

template <int C, typename E>
__device__ __forceinline__ void head_body(const E* __restrict__ out, size_t n, int nb, int T,
                                          const float* __restrict__ wp,
                                          const float* __restrict__ bp, int kp, int bands,
                                          E* __restrict__ y, float* smem) {
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
      v = leaky4_fit<E>(branch_mean4(out, n, nb, base4 + static_cast<size_t>(g) * C4 + c4),
                        kHeadSlope);
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
    const float v = tanhf(acc);
    if constexpr (fvt_mma::is_bf16<E>()) {
      y[(static_cast<size_t>(b) * T + g) * bands + ob] = __float2bfloat16_rn(v);
    } else {
      y[(static_cast<size_t>(b) * T + g) * bands + ob] = v;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
tail_head_kernel(const float* __restrict__ out, size_t n, int nb, int T,
                 const float* __restrict__ wp, const float* __restrict__ bp, int kp, int bands,
                 float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  head_body<C>(out, n, nb, T, wp, bp, kp, bands, y, smem);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
tail_head_bf16_kernel(const bf16* __restrict__ out, size_t n, int nb, int T,
                      const float* __restrict__ wp, const float* __restrict__ bp, int kp,
                      int bands, bf16* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  head_body<C>(out, n, nb, T, wp, bp, kp, bands, y, smem);
}

template <int C, typename E>
cudaError_t run_tail(const E* x, E* y, E* scratch, const E* packed, int B, int T_in, int cin,
                     const float* w_up, const float* b_up, int k_up, int u, int pad, int nb,
                     int np, const fvt_mrf::PairArgs* steps, const float* w_post,
                     const float* b_post, int k_post, int bands, cudaStream_t stream) {
  constexpr bool kBf16 = fvt_mma::is_bf16<E>();
  constexpr int kGroups = kThreads / (C / 4);
  using Tl = fvt_mma::PairTile<C, E>;
  constexpr int WM = Tl::kWM, ST = Tl::kST, SLAB = Tl::kSlabBytes;
  if (kGroups % u != 0) return cudaErrorInvalidValue;
  const int T = T_in * u;
  const size_t n = static_cast<size_t>(B) * T * C;
  E* h0 = scratch + 2 * nb * n;

  const int up_smem = static_cast<int>(sizeof(float)) * up_rows(pass_rows(C), k_up, u) * cin;
  if (up_smem > fvt_smem::kMaxSmem) return cudaErrorInvalidValue;
  const void* up_kernel = kBf16 ? reinterpret_cast<const void*>(tail_upsample_bf16_kernel<C>)
                                : reinterpret_cast<const void*>(tail_upsample_kernel<C>);
  cudaError_t err = fvt_smem::allow_max_smem(up_kernel);
  if (err != cudaSuccess) return err;
  const dim3 up_grid((T + pass_rows(C) - 1) / pass_rows(C), B);
  if constexpr (kBf16) {
    tail_upsample_bf16_kernel<C><<<up_grid, kThreads, up_smem, stream>>>(x, w_up, b_up, h0, T_in,
                                                                         cin, k_up, u, pad);
  } else {
    tail_upsample_kernel<C><<<up_grid, kThreads, up_smem, stream>>>(x, w_up, b_up, h0, T_in, cin,
                                                                    k_up, u, pad);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if constexpr (kBf16) {
    err = fvt_mrf::run_pairs<C>(tail_pair_bf16_kernel<C, WM, ST, SLAB>, steps, nb, np, packed, h0,
                                scratch, B, T, stream);
  } else {
    err = fvt_mrf::run_pairs<C>(tail_pair_kernel<C, WM, ST>, steps, nb, np, packed, h0, scratch,
                                B, T, stream);
  }
  if (err != cudaSuccess) return err;

  const int head_smem = static_cast<int>(sizeof(float)) * (head_rows(C) + k_post - 1) * (C + 1);
  if (head_smem > fvt_smem::kMaxSmem) return cudaErrorInvalidValue;
  const void* head_kernel = kBf16 ? reinterpret_cast<const void*>(tail_head_bf16_kernel<C>)
                                  : reinterpret_cast<const void*>(tail_head_kernel<C>);
  err = fvt_smem::allow_max_smem(head_kernel);
  if (err != cudaSuccess) return err;
  const dim3 head_grid((T + head_rows(C) - 1) / head_rows(C), B);
  const E* last = scratch + ((np - 1) % 2) * nb * n;
  if constexpr (kBf16) {
    tail_head_bf16_kernel<C><<<head_grid, kThreads, head_smem, stream>>>(
        last, n, nb, T, w_post, b_post, k_post, bands, y);
  } else {
    tail_head_kernel<C><<<head_grid, kThreads, head_smem, stream>>>(last, n, nb, T, w_post,
                                                                    b_post, k_post, bands, y);
  }
  return cudaGetLastError();
}

template <typename E>
long long packed_elems(int C, int nb, int np, const int* ints) {
  fvt_mrf::PairArgs steps[kMaxPairs];
  const float* none[4 * kMaxBranches * kMaxPairs] = {};
  if (fvt_mrf::load_steps(steps, nb, np, ints, none) != cudaSuccess) return -1;
  switch (C) {
    case 16: return static_cast<long long>(fvt_mrf::packed_layout<16, E>(steps, nb, np));
    case 32: return static_cast<long long>(fvt_mrf::packed_layout<32, E>(steps, nb, np));
    case 64: return static_cast<long long>(fvt_mrf::packed_layout<64, E>(steps, nb, np));
    case 128: return static_cast<long long>(fvt_mrf::packed_layout<128, E>(steps, nb, np));
    case 256: return static_cast<long long>(fvt_mrf::packed_layout<256, E>(steps, nb, np));
    default: return -1;
  }
}

template <typename E>
int pack_any(E* packed, int C, int nb, int np, const int* ints, const float* const* weights,
             void* stream) {
  fvt_mrf::PairArgs steps[kMaxPairs];
  cudaError_t err = fvt_mrf::load_steps(steps, nb, np, ints, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return static_cast<int>(fvt_mrf::pack_stage<16>(packed, steps, nb, np, true, s));
    case 32: return static_cast<int>(fvt_mrf::pack_stage<32>(packed, steps, nb, np, true, s));
    case 64: return static_cast<int>(fvt_mrf::pack_stage<64>(packed, steps, nb, np, true, s));
    case 128: return static_cast<int>(fvt_mrf::pack_stage<128>(packed, steps, nb, np, true, s));
    case 256: return static_cast<int>(fvt_mrf::pack_stage<256>(packed, steps, nb, np, true, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename E>
int run_any(const E* x, E* y, E* scratch, const E* packed, int B, int T_in, int cin, int C,
            const float* w_up, const float* b_up, int k_up, int stride, int pad, int nb, int np,
            const int* ints, const float* const* weights, const float* w_post,
            const float* b_post, int k_post, int bands, void* stream) {
  if (B < 1 || T_in < 1 || cin < 4 || cin % 4 != 0 || k_up < 1 || stride < 1 || pad < 0 ||
      k_post < 1 || k_post % 2 == 0 || bands < 1 || bands > kMaxBands) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fvt_mrf::PairArgs steps[kMaxPairs];
  cudaError_t err = fvt_mrf::load_steps(steps, nb, np, ints, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FVT_TAIL(CC)                                                                          \
  run_tail<CC>(x, y, scratch, packed, B, T_in, cin, w_up, b_up, k_up, stride, pad, nb, np, \
               steps, w_post, b_post, k_post, bands, s)
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

}  // namespace

extern "C" int fvt_fused_tail_max_bands() { return kMaxBands; }
extern "C" int fvt_fused_tail_max_branches() { return kMaxBranches; }
extern "C" int fvt_fused_tail_max_pairs() { return kMaxPairs; }

// floats of the packed MRF kernels of a tail (`fvt_fused_tail_pack`); -1
// for a width or table it refuses.  ints as `fvt_fused_tail` takes them.
extern "C" long long fvt_fused_tail_packed_floats(int C, int nb, int np, const int* ints) {
  return packed_elems<float>(C, nb, np, ints);
}

// packed (`fvt_fused_tail_packed_floats` floats, 16-byte aligned) = the
// MRF's kernels split for the tensor cores, in one launch on `stream`.
// ints and weights as `fvt_fused_tail` takes them.  Returns the CUDA error
// of the launch (0 = ok).
extern "C" int fvt_fused_tail_pack(float* packed, int C, int nb, int np, const int* ints,
                                   const float* const* weights, void* stream) {
  return pack_any(packed, C, nb, np, ints, weights, stream);
}

// x (B, T_in, cin) and y (B, stride * T_in, bands) float32 contiguous; C (the
// stage's width) in {16, 32, 64, 128, 256}, cin a multiple of 4.  scratch:
// (2 nb + 1) * B * stride * T_in * C floats.  packed: the MRF's kernels as
// `fvt_fused_tail_pack` wrote them from the same table.  w_up (k_up, cin,
// C), b_up (C,): the transposed conv, torch semantics with `pad`.  ints /
// weights: the MRF's nb branches of np pairs, per (branch, pair),
// branch-major, (K1, dilation, K2) and (w1 (K1, C, C), b1 (C,), w2
// (K2, C, C), b2 (C,)), kernels (tap, c_in, c_out), of which this call
// reads the biases.  w_post (k_post, C, bands), b_post (bands,), k_post
// odd, bands <= 4.  Device pointers 16-byte aligned.  Returns the first
// CUDA error of the launches (0 = ok).
extern "C" int fvt_fused_tail(const float* x, float* y, float* scratch, const float* packed,
                              int B, int T_in, int cin, int C, const float* w_up,
                              const float* b_up, int k_up, int stride, int pad, int nb, int np,
                              const int* ints, const float* const* weights,
                              const float* w_post, const float* b_post, int k_post, int bands,
                              void* stream) {
  return run_any(x, y, scratch, packed, B, T_in, cin, C, w_up, b_up, k_up, stride, pad, nb, np,
                 ints, weights, w_post, b_post, k_post, bands, stream);
}

// The bf16 form.  Elements (bf16) of the packed MRF kernels of a tail; -1
// for a width or table it refuses.
extern "C" long long fvt_fused_tail_bf16_packed_elems(int C, int nb, int np, const int* ints) {
  return packed_elems<bf16>(C, nb, np, ints);
}

// packed (`fvt_fused_tail_bf16_packed_elems` bf16, 16-byte aligned) = the
// MRF's float32 kernels, as `fvt_fused_tail_pack` takes them, rounded to
// bf16 in the order the pair launches read them.
extern "C" int fvt_fused_tail_bf16_pack(bf16* packed, int C, int nb, int np, const int* ints,
                                        const float* const* weights, void* stream) {
  return pack_any(packed, C, nb, np, ints, weights, stream);
}

// x (B, T_in, cin), y (B, stride * T_in, bands) and scratch ((2 nb + 1) B
// stride T_in C elements) bf16; packed as `fvt_fused_tail_bf16_pack` wrote
// it; the other arguments as `fvt_fused_tail` takes them, w_up, b_up,
// w_post and b_post float32 holding bf16 values.  Returns the first CUDA
// error of the launches (0 = ok).
extern "C" int fvt_fused_tail_bf16(const bf16* x, bf16* y, bf16* scratch, const bf16* packed,
                                   int B, int T_in, int cin, int C, const float* w_up,
                                   const float* b_up, int k_up, int stride, int pad, int nb,
                                   int np, const int* ints, const float* const* weights,
                                   const float* w_post, const float* b_post, int k_post,
                                   int bands, void* stream) {
  return run_any(x, y, scratch, packed, B, T_in, cin, C, w_up, b_up, k_up, stride, pad, nb, np,
                 ints, weights, w_post, b_post, k_post, bands, stream);
}
