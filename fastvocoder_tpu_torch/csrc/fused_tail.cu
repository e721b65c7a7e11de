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
// The bf16 form: x, y and the intermediates in bf16; the MRF's kernels
// packed as bf16 once for a kept table (`fvt_fused_tail_bf16_pack`), the
// upsample's and the head's weights and biases given as float32 holding
// bf16 values; float32 sums, rounded to bf16 where fused_tail.py's Pallas
// body rounds: the upsample's output, the MRF as in fused_mrf.cu, the
// branches' mean, the head's leaky-relu and its tanh (taken of the float32
// sum).  Bound: the MRF's and the upsample's operations at 989 TFLOP/s
// (0.0092 and 0.0003 ms at (1, 140400, 16)), the head's at the float32
// rate (0.0005).  The contraction does not set the pace here, so at
// HiFiGAN light's width (C = 16, stride 2, 32 input channels) the form is
// the TPU kernel's one pass (`fvt_fused_tail_bf16_tiled`,
// `tail_fused_bf16_kernel`, namespace `fused`): a persistent block (one an
// SM) stages its 70.5 KB of packed kernels once and takes tiles of R
// output rows with H rows of h0 halo each side
// (`ops/fused_tail.py::TailTable.plan`), reads x's rows for the tile once,
// and runs the upsample (the blocked dense conv of `blocked_upsample`,
// m64n32k16 wgmmas over input rows), every branch's pairs (one m64n16k16 a
// tap and 64-row block, both operands in shared memory), the branches'
// sum, the mean and the head from shared memory and registers; y is
// written once.  The five launches of the float32 form moved about 103 MB
// through device memory at (1, 70200, 32); this moves 4.8.  Other widths
// (HiFiGAN large's C = 32, whose MRF kernels, 258 KB, do not fit a block
// beside its tile, and a form that streams them is not built; C >= 64,
// which no shipped configuration has) run `fvt_fused_tail_bf16`, the five
// launches in bf16: `tail_upsample_bf16_kernel`, `tail_pair_bf16_kernel` x
// np, `tail_head_bf16_kernel`.  Measured on an H100 at 700 W (PERF.md,
// `bin/chain_times.py`): 0.0948 ms at (1, 70200, 32) against the five
// launches' 0.1632, 0.5834 at (32, 16800, 32) against 1.0634.

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

// Launches of the tail's kernels since the library was loaded, by role
// (`fvt_fused_tail_launches`), counted where a launch succeeds: a caller
// tells the one launch from the five without a profiler.
enum Role { kRoleFused, kRoleUpsample, kRolePair, kRoleHead, kRoles };
long long g_launches[kRoles] = {};

cudaError_t counted(cudaError_t err, Role role, int n = 1) {
  if (err == cudaSuccess) g_launches[role] += n;
  return err;
}

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
  err = counted(cudaGetLastError(), kRoleUpsample);
  if (err != cudaSuccess) return err;

  if constexpr (kBf16) {
    err = fvt_mrf::run_pairs<C>(tail_pair_bf16_kernel<C, WM, ST, SLAB>, steps, nb, np, packed, h0,
                                scratch, B, T, stream);
  } else {
    err = fvt_mrf::run_pairs<C>(tail_pair_kernel<C, WM, ST>, steps, nb, np, packed, h0, scratch,
                                B, T, stream);
  }
  err = counted(err, kRolePair, np);
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
  return counted(cudaGetLastError(), kRoleHead);
}

// ---------------------------------------------------------------------------
// the bf16 tail in one launch at C = 16 (`tail_fused_bf16_kernel`)
// ---------------------------------------------------------------------------
//
// Six warpgroups (768 threads) share a tile of kMaxRows rows (the R output
// rows and both halos; rows past them give sums no kept row reads): every
// conv runs over all of them in 64-row blocks wg + kWM i, so a lane owns the
// same rows in every conv and keeps its rows of a branch's running sum and
// of the branches' sum in registers; only the convs' operands pass through
// shared memory.  Between the convs the block's work is per element on the
// CUDA cores (rounding, leaky-relu, masks, residuals): on an H100 that,
// not the products, sets its time (`bin/tile_variants.py --one-launch
// --probes`; PERF.md).

namespace fused {

using fvt_mma::Lane;
using fvt_mma::tile_at;
using fvt_mma::wgmma_desc;
using fvt_mma::WgmmaBf16;

constexpr int kC = 16;             // the stage's width
constexpr int kU = 2;              // the upsample's stride
constexpr int kCin = kU * kC;      // its input width: one input row makes kU output rows
constexpr int kWM = 6;             // warpgroups over the rows
constexpr int kThreads = 128 * kWM;
constexpr int kMaxB = 2;           // 64-row blocks of one conv a warpgroup holds
constexpr int kMaxRows = 64 * kWM * kMaxB;  // rows of a tile with both halos
constexpr int kMaxUpB = (kMaxRows / kU / 64 + kWM - 1) / kWM;  // the upsample's, a warpgroup
constexpr int kMaxWj = 4;          // taps of the blocked upsample
constexpr int kUnit = kC * kC;     // elements of a packed MRF tap (Geo<16, bf16>: one unit)
constexpr int kUnitUp = kCin * kCin;  // of a packed tap of the blocked upsample (Geo<32, bf16>)

// What a launch reads: the operands, where each packed kernel lies in the
// table, and the tile plan (`ops/fused_tail.py::tail_plan`).
struct Args {
  const bf16* x;        // (B, T_in, kCin)
  bf16* y;              // (B, T, bands)
  const bf16* packed;   // the MRF's kernels (`fvt_mrf::packed_layout`), then the upsample's
  int n_packed;         // elements of packed, a multiple of 8
  int up_off;           // where the upsample's wj taps start in packed
  const float* b_up;    // (kC,), bf16 values
  const float* b1[kMaxBranches][kMaxPairs];
  const float* b2[kMaxBranches][kMaxPairs];
  int w1[kMaxBranches][kMaxPairs];  // element offsets of the packed kernels
  int w2[kMaxBranches][kMaxPairs];
  int k1[kMaxBranches][kMaxPairs];
  int dil[kMaxBranches][kMaxPairs];
  int k2[kMaxBranches][kMaxPairs];
  int nb, np;
  const float* w_post;  // (kp, kC, bands), bf16 values
  const float* b_post;  // (bands,)
  int kp, bands;
  int B, T_in, T;
  int R, H;             // output rows of a tile, rows of h0 staged each side
  int wj, off_up;       // taps of the blocked upsample and its left margin (input rows)
  int tiles_per_seq, n_tiles;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of a block, in bf16 elements, every piece on 128 bytes: the
// packed kernels (staged once a block), then h0 (the upsample's output), l
// (leaky(hh): conv1's operand), u (conv1's output: conv2's operand) and s
// (the head's input), each kMaxRows rows of kC in `tile_at` columns with
// kPad rows before and after them (the taps' reach past the tile's first
// and last blocks: up to 25 rows), and x's rows.
constexpr int kPad = 32;

struct Layout {
  int n, rs, xrs, h0, l, u, s, x, bytes;
  __host__ __device__ Layout(int R, int H, int wj, int n_packed) {
    n = R + 2 * H;
    rs = 8 * (kMaxRows + 2 * kPad);
    xrs = 8 * round_up(round_up(n / kU, 64) + wj, 8);
    h0 = round_up(n_packed, 64) + 8 * kPad;  // row 0 of each tile kPad rows into it
    l = h0 + kC / 8 * rs;
    u = l + kC / 8 * rs;
    s = u + kC / 8 * rs;
    x = s + kC / 8 * rs - 8 * kPad;
    bytes = 2 * (x + kCin / 8 * xrs);
  }
};

__device__ __forceinline__ bool inside(int g, int T) { return g >= 0 && g < T; }

// two neighbouring channels (c even) of row r of a kC-wide tile
__device__ __forceinline__ uint32_t* pair_at(bf16* tile, int rs, int r, int c) {
  return reinterpret_cast<uint32_t*>(tile_at<kC>(tile, rs, r, c));
}

// The epilogues' arithmetic on a pair of channels, one packed conversion a
// pair: two sums rounded to bf16 (as floats), and leaky(v) of bf16 values
// rounded, as max(v, slope v) (slope < 1): the product is rounded where it
// is taken, a value v >= 0 passes exactly.
__device__ __forceinline__ float2 rounded(float v0, float v1) {
  return fvt_mma::unpack_bf16x2(fvt_mma::pack_bf16x2(v0, v1));
}
__device__ __forceinline__ uint32_t leaky2(float2 v, float slope) {
  return fvt_mma::pack_bf16x2(fmaxf(v.x, v.x * slope), fmaxf(v.y, v.y * slope));
}
__device__ __forceinline__ uint32_t add2(uint32_t a, float2 b) {
  const float2 f = fvt_mma::unpack_bf16x2(a);
  return fvt_mma::pack_bf16x2(f.x + b.x, f.y + b.y);
}

// acc[i][j] = the bias of the lane's channels (rounded to bf16)
template <int NT, int NB>
__device__ __forceinline__ void bias_acc(float (&acc)[NB][NT][4], const float* __restrict__ bias,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = (8 * j + 2 * t) % kC;
    const float b0 = fvt_mma::fit<bf16>(__ldg(bias + c));
    const float b1 = fvt_mma::fit<bf16>(__ldg(bias + c + 1));
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      acc[i][j][0] = acc[i][j][2] = b0;
      acc[i][j][1] = acc[i][j][3] = b1;
    }
  }
}

// One conv of the MRF over the kMaxRows rows of a tile: acc[i] += sum_k
// A[r - m + k step] W[k] for the warpgroup's blocks i.  Rows past the ones
// a conv needs give sums that no kept row reads.  Both operands in shared
// memory, W the K resident taps; one m64n16k16 a tap and block, all summed
// in the tensor core, tap by tap over the blocks, so that neighbouring
// wgmmas add into different accumulators; one commit for the conv.  No
// wgmma lies under a branch and no accumulator is defined between the fence
// and the commit: ptxas serializes every wgmma of a kernel otherwise
// (C7520, C7515; found on an H100).
__device__ __forceinline__ void conv_mrf(float (&acc)[kMaxB][2][4], const bf16* A, int rs, int m,
                                         int step, const bf16* W, int K, int wg) {
  const uint64_t b0 = wgmma_desc(W, fvt_mma::Geo<kC, bf16>::kStrideK, 128);
  uint64_t a0[kMaxB];
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
    a0[i] = wgmma_desc(A + 8 * (64 * (wg + kWM * i) - m), 2 * rs, 128);
    fvt_mma::fence_regs(acc[i]);
  }
  fvt_mma::wgmma_fence();
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) {
      // a row is 16 bytes of a column; a tap 512 bytes of the table
      WgmmaBf16<kC>::run(acc[i], a0[i] + static_cast<uint64_t>(k * step),
                         b0 + static_cast<uint64_t>(k * (kUnit / 8)));
    }
  }
  fvt_mma::wgmma_commit();
  fvt_mma::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) fvt_mma::fence_regs(acc[i]);
}

// fn(i, half, j, row, channel) for each pair of sums a lane holds of an MRF
// conv: block i of its warpgroup (64 rows from 64 (wg + kWM i)), its rows g
// and g + 8 of its warp's 16, channels 8 j + 2 t and + 1.  Every conv
// covers the tile's kMaxRows rows in the same blocks, so a lane owns the
// same rows and channels in all of them.
template <typename F>
__device__ __forceinline__ void each_pair(const Lane<kC, kWM>& ln, F fn) {
#pragma unroll
  for (int i = 0; i < kMaxB; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 64 * (ln.group_m + kWM * i) + ln.row0 % 64 + ln.g + 8 * half;
#pragma unroll
      for (int j = 0; j < 2; ++j) fn(i, half, j, r, 8 * j + 2 * ln.t);
    }
  }
}

// what generic stores wrote becomes visible to every warpgroup's wgmmas
__device__ __forceinline__ void publish() {
  fvt_mma::fence_smem_for_wgmma();
  __syncthreads();
}

// One persistent block: the packed kernels staged once, then for each of its
// tiles (output rows [t0, t0 + R) of sequence b) the whole tail from x's
// rows: h0 over rows [t0 - H, t0 + R + H) (local row i is t0 - H + i), each
// branch's pairs, the branches summed, the head.  A lane keeps its rows of
// a branch's running sum hh and of the branches' sum in registers; only
// the convs' operands (l, u) pass through shared memory.  Every conv's
// output rows outside [0, T) are zeros: the next conv's zero padding, as
// `mask_rows` in the Pallas body.  A branch's rows shrink by its margins
// pair by pair; the halo keeps [H - e, H + R + e) (e: conv_post's margin)
// exact through the largest branch, and rows outside the shrinking range
// are computed and never read by a kept row.
__global__ void __launch_bounds__(kThreads, 1) tail_fused_bf16_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const Layout lay(a.R, a.H, a.wj, a.n_packed);
  const int n = lay.n, rs = lay.rs, xrs = lay.xrs;
  bf16 *h0 = sm + lay.h0, *lk = sm + lay.l, *uu = sm + lay.u, *ss = sm + lay.s;
  bf16* xs = sm + lay.x;
  const Lane<kC, kWM> ln;
  const int wg = ln.group_m;
  const int e = (a.kp - 1) / 2;

  const int npr = n / kU;  // input rows of h0's rows
  // x's rows for a tile's upsample: input row (t0 - H) / kU - off_up + i,
  // zeros outside [0, T_in); one commit group
  auto stage_x = [&](int tile) {
    const int b = tile / a.tiles_per_seq, t0 = tile % a.tiles_per_seq * a.R;
    fvt_mma::stage_rows_bf16<kCin, kThreads>(xs, xrs,
                                             a.x + static_cast<size_t>(b) * a.T_in * kCin, a.T_in,
                                             (t0 - a.H) / kU - a.off_up, npr + a.wj - 1);
  };
  for (int i = threadIdx.x; i < a.n_packed / 8; i += kThreads) {
    fvt_mma::cp_async16(sm + 8 * i, a.packed + 8 * i);
  }
  fvt_mma::cp_async_commit();

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int b = tile / a.tiles_per_seq;
    const int t0 = tile % a.tiles_per_seq * a.R;
    const int g0 = t0 - a.H;  // global row of local row 0
    const bool interior = g0 >= 0 && g0 + kMaxRows <= a.T;  // no row of the tile to zero
    __syncthreads();  // the last tile's head has read s
    stage_x(tile);
    fvt_mma::cp_async_wait<0>();
    __syncthreads();
    fvt_mma::leaky_rows_bf16<kCin, kThreads>(xs, xrs, npr + a.wj - 1, kSlope);
    publish();

    {  // the upsample: input row r of h0's rows makes h0 rows kU r .. kU r + kU - 1
      constexpr int NT = kU * kC / 8;
      const int nblk = (npr + 63) / 64;
      float acc[kMaxUpB][NT][4];
      bias_acc<NT>(acc, a.b_up, ln.t);
      const uint64_t b0 = wgmma_desc(sm + a.up_off, fvt_mma::Geo<kCin, bf16>::kStrideK, 128);
      uint64_t a0[kMaxUpB];
#pragma unroll
      for (int i = 0; i < kMaxUpB; ++i) {
        a0[i] = wgmma_desc(xs + 8 * 64 * min(wg + kWM * i, nblk - 1), 2 * xrs, 128);
        fvt_mma::fence_regs(acc[i]);
      }
      fvt_mma::wgmma_fence();
      for (int j = 0; j < a.wj; ++j) {
#pragma unroll
        for (int ks = 0; ks < kCin / 16; ++ks) {
#pragma unroll
          for (int i = 0; i < kMaxUpB; ++i) {
            // depth step ks: x's columns 2 ks, 2 ks + 1; the unit's core matrices 2 ks, 2 ks + 1
            WgmmaBf16<kU * kC>::run(
                acc[i], a0[i] + static_cast<uint64_t>(j + 2 * ks * (xrs / 8)),
                b0 + static_cast<uint64_t>(j * (kUnitUp / 8) + 2 * ks * (kU * kC / 8) * 8));
          }
        }
      }
      fvt_mma::wgmma_commit();
      fvt_mma::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kMaxUpB; ++i) {
        fvt_mma::fence_regs(acc[i]);
        const int mb = wg + kWM * i;
        if (mb >= nblk) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 64 * mb + ln.row0 % 64 + ln.g + 8 * half;
          if (r >= npr) continue;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int row = kU * r + j / (kC / 8), c = 8 * (j % (kC / 8)) + 2 * ln.t;
            const bool ok = interior || inside(g0 + row, a.T);
            *pair_at(h0, rs, row, c) =
                ok ? fvt_mma::pack_bf16x2(acc[i][j][2 * half], acc[i][j][2 * half + 1]) : 0u;
          }
        }
      }
    }
    publish();

    float acc[kMaxB][2][4];
    uint32_t hh[kMaxB][2][2], sum[kMaxB][2][2];  // the lane's pairs of hh and of the branches' sum
    // a branch starts from hh = h0 and l = leaky(h0): the first here, the
    // others in the last epilogue of the branch before
    each_pair(ln, [&](int i, int half, int j, int r, int c) {
      hh[i][half][j] = *pair_at(h0, rs, r, c);
      *pair_at(lk, rs, r, c) = leaky2(fvt_mma::unpack_bf16x2(hh[i][half][j]), kSlope);
    });
    publish();
    for (int br = 0; br < a.nb; ++br) {
      for (int p = 0; p < a.np; ++p) {
        const int m1 = (a.k1[br][p] - 1) / 2 * a.dil[br][p], m2 = (a.k2[br][p] - 1) / 2;
        // u = leaky(conv1(leaky(hh)) + b1)
        bias_acc<2>(acc, a.b1[br][p], ln.t);
        conv_mrf(acc, lk, rs, m1, a.dil[br][p], sm + a.w1[br][p], a.k1[br][p], wg);
        each_pair(ln, [&](int i, int half, int j, int r, int c) {
          const bool ok = interior || inside(g0 + r, a.T);
          *pair_at(uu, rs, r, c) =
              ok ? leaky2(rounded(acc[i][j][2 * half], acc[i][j][2 * half + 1]), kSlope) : 0u;
        });
        publish();
        // hh' = hh + conv2(u) + b2, and l = leaky(hh') for the next pair; after
        // the last pair hh joins the branches' sum (in order, each sum
        // rounded, as `branch_mean4`) and the next branch starts
        const bool next = p + 1 < a.np, next_branch = !next && br + 1 < a.nb;
        bias_acc<2>(acc, a.b2[br][p], ln.t);
        conv_mrf(acc, uu, rs, m2, 1, sm + a.w2[br][p], a.k2[br][p], wg);
        each_pair(ln, [&](int i, int half, int j, int r, int c) {
          const bool ok = interior || inside(g0 + r, a.T);
          uint32_t& h = hh[i][half][j];
          h = ok ? add2(h, rounded(acc[i][j][2 * half], acc[i][j][2 * half + 1])) : 0u;
          if (next) {
            *pair_at(lk, rs, r, c) = leaky2(fvt_mma::unpack_bf16x2(h), kSlope);
          } else {
            sum[i][half][j] = br == 0 ? h : add2(sum[i][half][j], fvt_mma::unpack_bf16x2(h));
            if (next_branch) {
              h = *pair_at(h0, rs, r, c);
              *pair_at(lk, rs, r, c) = leaky2(fvt_mma::unpack_bf16x2(h), kSlope);
            }
          }
        });
        if (next || next_branch) publish();
      }
    }

    // the head's input: leaky(mean, 0.01)
    const float nb = static_cast<float>(a.nb);
    each_pair(ln, [&](int i, int half, int j, int r, int c) {
      const float2 f = fvt_mma::unpack_bf16x2(sum[i][half][j]);
      *pair_at(ss, rs, r, c) = fvt_mma::pack_bf16x2(
          fvt_mma::leaky_fit<bf16>(fvt_mma::fit<bf16>(f.x / nb), kHeadSlope),
          fvt_mma::leaky_fit<bf16>(fvt_mma::fit<bf16>(f.y / nb), kHeadSlope));
    });
    __syncthreads();
    // conv_post and tanh: a thread an output row and band, in the five
    // launches' order of sums (bias, then tap by tap, channel by channel)
    for (int idx = threadIdx.x; idx < a.R * a.bands; idx += kThreads) {
      const int r = idx / a.bands, ob = idx % a.bands;
      const int g = t0 + r;
      if (g >= a.T) continue;
      float acc1 = __ldg(a.b_post + ob);
      for (int k = 0; k < a.kp; ++k) {
        const float* wk = a.w_post + static_cast<size_t>(k) * kC * a.bands + ob;
#pragma unroll
        for (int cv = 0; cv < kC / 8; ++cv) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(tile_at<kC>(ss, rs, a.H + r - e + k, 8 * cv));
          const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = fvt_mma::unpack_bf16x2(w[q]);
            acc1 = fmaf(f.x, __ldg(wk + (8 * cv + 2 * q) * a.bands), acc1);
            acc1 = fmaf(f.y, __ldg(wk + (8 * cv + 2 * q + 1) * a.bands), acc1);
          }
        }
      }
      a.y[(static_cast<size_t>(b) * a.T + g) * a.bands + ob] = __float2bfloat16_rn(tanhf(acc1));
    }
  }
  fvt_mma::cp_async_wait<0>();  // a block without a tile leaves no copy in flight
}

// the largest R (a multiple of 16) whose tile fits a block: rows and shared
// memory; -1 where none does or where a conv reaches past the pads
int max_rows(int H, int wj, int n_packed, int reach) {
  if (wj < 1 || wj > kMaxWj || reach > kPad) return -1;
  int best = -1;
  for (int R = 16; R + 2 * H <= kMaxRows; R += 16) {
    if (Layout(R, H, wj, n_packed).bytes <= fvt_smem::kMaxSmem) best = R;
  }
  return best;
}

cudaError_t launch(Args& a, int n_blocks, cudaStream_t stream) {
  if (a.R < 16 || a.R % 16 != 0 || a.H < 0 || a.H % kU != 0 || a.wj < 1 || a.wj > kMaxWj ||
      a.off_up < 0 || a.R + 2 * a.H > kMaxRows || a.kp < 1 || a.kp % 2 == 0 ||
      a.bands < 1 || a.bands > kMaxBands || a.n_packed % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const int e = (a.kp - 1) / 2;
  for (int br = 0; br < a.nb; ++br) {
    int a_sum = 0;
    for (int p = 0; p < a.np; ++p) {
      const int m1 = (a.k1[br][p] - 1) / 2 * a.dil[br][p], m2 = (a.k2[br][p] - 1) / 2;
      if (a.k1[br][p] < 1 || a.k1[br][p] % 2 == 0 || a.dil[br][p] < 1 || a.k2[br][p] < 1 ||
          a.k2[br][p] % 2 == 0 || m1 > kPad || m2 > kPad) {
        return cudaErrorInvalidValue;  // a tap past the pads
      }
      a_sum += m1 + m2;
    }
    if (a_sum + e > a.H) return cudaErrorInvalidValue;  // the halo does not cover the branch
  }
  const Layout lay(a.R, a.H, a.wj, a.n_packed);
  if (lay.bytes > fvt_smem::kMaxSmem) return cudaErrorInvalidValue;
  a.tiles_per_seq = (a.T + a.R - 1) / a.R;
  const long long tiles = static_cast<long long>(a.B) * a.tiles_per_seq;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  a.n_tiles = static_cast<int>(tiles);
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(tail_fused_bf16_kernel));
  if (err != cudaSuccess) return err;
  const int blocks = n_blocks < a.n_tiles ? n_blocks : a.n_tiles;
  tail_fused_bf16_kernel<<<blocks, kThreads, lay.bytes, stream>>>(a);
  return counted(cudaGetLastError(), kRoleFused);
}

}  // namespace fused

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

// Launches of the tail's kernels since the library was loaded, in both
// forms: role 0 the one-launch bf16 tail, 1 the upsample, 2 the pair
// launches (one a pair), 3 the head; -1 for another role.
extern "C" long long fvt_fused_tail_launches(int role) {
  return role >= 0 && role < kRoles ? g_launches[role] : -1;
}
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

// The bf16 tail in one launch (`tail_fused_bf16_kernel`): the width it
// takes, C = 16 with stride 2 from 32 input channels (HiFiGAN light's
// tail); other widths run `fvt_fused_tail_bf16`.
extern "C" int fvt_tail_fused_width() { return fused::kC; }
extern "C" int fvt_tail_fused_stride() { return fused::kU; }

// The largest R (output rows of a tile, a multiple of 16) of a tile with
// H rows of halo each side whose block fits, for a table of n_packed
// elements (the MRF's and the upsample's wj taps) whose convs reach `reach`
// rows each side at most; -1 if none (the tail then runs
// `fvt_fused_tail_bf16`).
extern "C" int fvt_tail_fused_max_rows(int H, int wj, int n_packed, int reach) {
  return fused::max_rows(H, wj, n_packed, reach);
}

// x (B, T_in, 32) and y (B, 2 T_in, bands) bf16; packed (n_packed bf16):
// the MRF's kernels as `fvt_fused_tail_bf16_pack` wrote them, then from
// element up_off the wj taps of the blocked upsample (`ops/fused_tail.py::
// blocked_upsample`, packed as a Geo<32, bf16> kernel); b_up (16,) and the
// head's operands float32 holding bf16 values; ints and weights as
// `fvt_fused_tail` takes them (this call reads the tables and biases).
// R, H: the tile plan (`tail_plan`), off_up the upsample's left margin in
// input rows.  n_blocks: the persistent grid (one block an SM).  Returns the
// CUDA error of the launch (0 = ok; cudaErrorInvalidValue for a shape or
// plan it refuses).
extern "C" int fvt_fused_tail_bf16_tiled(const bf16* x, bf16* y, const bf16* packed,
                                         int n_packed, int up_off, int B, int T_in, int cin,
                                         int C, const float* b_up, int stride, int wj,
                                         int off_up, int nb, int np, const int* ints,
                                         const float* const* weights, const float* w_post,
                                         const float* b_post, int k_post, int bands, int R, int H,
                                         int n_blocks, void* stream) {
  if (C != fused::kC || stride != fused::kU || cin != fused::kCin || B < 1 || T_in < 1 ||
      n_blocks < 1 || up_off % 64 != 0 || up_off + wj * fused::kUnitUp > n_packed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fvt_mrf::PairArgs steps[kMaxPairs];
  cudaError_t err = fvt_mrf::load_steps(steps, nb, np, ints, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t off[kMaxPairs][kMaxBranches][2];
  if (fvt_mrf::packed_layout<fused::kC, bf16>(steps, nb, np, off) > static_cast<size_t>(up_off)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused::Args a;
  a.x = x;
  a.y = y;
  a.packed = packed;
  a.n_packed = n_packed;
  a.up_off = up_off;
  a.b_up = b_up;
  for (int br = 0; br < nb; ++br) {
    for (int p = 0; p < np; ++p) {
      a.b1[br][p] = steps[p].b1[br];
      a.b2[br][p] = steps[p].b2[br];
      a.w1[br][p] = static_cast<int>(off[p][br][0]);
      a.w2[br][p] = static_cast<int>(off[p][br][1]);
      a.k1[br][p] = steps[p].k1[br];
      a.dil[br][p] = steps[p].dil[br];
      a.k2[br][p] = steps[p].k2[br];
    }
  }
  a.nb = nb;
  a.np = np;
  a.w_post = w_post;
  a.b_post = b_post;
  a.kp = k_post;
  a.bands = bands;
  a.B = B;
  a.T_in = T_in;
  a.T = stride * T_in;
  a.R = R;
  a.H = H;
  a.wj = wj;
  a.off_up = off_up;
  return static_cast<int>(fused::launch(a, n_blocks, static_cast<cudaStream_t>(stream)));
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
