// One HiFiGAN MRF stage: the mean over ResBlock1 branches, forward only.
//
// Replaces: fastvocoder_tpu/ops/fused_mrf.py::_mrf_kernel (driven by
// `_run_mrf_fwd`), forward only.
//
// y = mean_br chain_br(x) over x (B, T, C) float32, channels last, C in
// {16, 32, 64, 128, 256}, any T >= 1 and any B; each chain is a sequence of
// pairs h' = h + conv2_K2(leaky(conv1_K1,d(leaky(h)) + b1)) + b2 with slope
// 0.1 and zero "same" padding on every conv's own input.
//
// Bound on an H100: operations.  A row costs 2 * 2 * sum_br sum_pairs
// (K1 + K2) * C^2 FLOP, 252 C^2 for the k = 3 / 7 / 11, d = 1 / 3 / 5 stage
// of HiFiGAN: 19.3 GFLOP for the (1, 4680, 128) stage of a 585-frame
// utterance, against 4.8 MB of input and output.  So the contraction runs on
// the tensor cores in 3xTF32 (mma_common.cuh: wgmma on split operands,
// float32 accumulation, the kernels packed once a call and streamed through
// shared memory once a block), which keeps float32 accuracy at a ceiling of
// 165 TFLOP/s instead of the CUDA cores' 67.
//
// The TPU kernel ran the whole stage from VMEM over one tile with a halo of
// 60 rows (the k = 11 chain).  Here a block has at most 227 KB of shared
// memory, and a 60-row halo on a tile that fits would cost 1.7x the
// operations in recomputed rows at C = 128.  So the stage runs as
//   * a launch that packs the stage's kernels for the tensor cores;
//   * one launch per pair position, all branches at once (blockIdx.z =
//     branch), each reading the branch's h and writing h' to a scratch
//     buffer (two sets, used in turn): the halo of a pair is at most
//     m1 + m2 = 30 rows, and only the 2 m2 <= 10 rows of u are recomputed;
//     the tile's rows are planned per launch, from that position's margins;
//     3 branches give 3x the blocks, which fills the 132 SMs at batch 1;
//   * a memory-bound launch that writes the mean of the branches, summed in
//     the plain version's order (((b0 + b1) + b2) / n).
// Intermediates between launches (B T C floats per branch) stay in L2 at
// batch 1 and cost a few percent of the stage's time.
//
// The bf16 form (`fvt_fused_mrf_bf16`: `mrf_pair_bf16_kernel`,
// `mrf_mean_bf16_kernel`): x, y and the intermediates in bf16, the stage's
// kernels packed as bf16 once, by `fvt_fused_mrf_bf16_pack` from the
// module's layout, for a kept table (ops/fused_mrf.py's StageTable in
// bf16), biases float32 rounded to bf16 on load; rounded where
// fused_mrf.py's Pallas body rounds (`fvt_mma::pair_body`,
// `fvt_mrf::branch_mean4`).  Bound: the same operations at 989 TFLOP/s.
// Its pair launches run the bf16 core (`fvt_mma::conv_core_bf16`: the
// tensor core sums a whole conv from shared memory, slabs of weights in
// flight), with the blocks of `fvt_mma::TileBf16Pair`: 4 warpgroups over
// the rows at C = 32 and 64, where the grid is large and a block's
// weights serve more rows.

#include "mma_common.cuh"
#include "mrf_common.cuh"

namespace {

using fvt_mrf::kMaxBranches;
using fvt_mrf::kMaxPairs;
using fvt_mrf::kThreads;

FVT_MMA_PAIR_KERNEL(mrf_pair_kernel)
FVT_MMA_BF16_PAIR_KERNEL(mrf_pair_bf16_kernel)

using fvt_mma::bf16;

template <typename E>
__device__ __forceinline__ void mean_body(const E* __restrict__ out, size_t n, int nb,
                                          E* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    fvt_mma::store4(y + 4 * i, fvt_mrf::branch_mean4(out, n, nb, i));
  }
}

__global__ void __launch_bounds__(kThreads)
mrf_mean_kernel(const float* __restrict__ out, size_t n, int nb, float* __restrict__ y) {
  mean_body(out, n, nb, y);
}

__global__ void __launch_bounds__(kThreads)
mrf_mean_bf16_kernel(const bf16* __restrict__ out, size_t n, int nb, bf16* __restrict__ y) {
  mean_body(out, n, nb, y);
}

// The np pair positions of every branch, one launch each, h' to scratch
// (2 nb B T C elements: two sets of nb buffers used in turn), then the mean
// of the buffers the last position wrote.
template <int C, typename E>
cudaError_t run_pairs_and_mean(const E* x, E* y, E* scratch, const E* packed, int B, int T,
                               int nb, int np, const fvt_mrf::PairArgs* steps,
                               cudaStream_t stream) {
  using Tl = fvt_mma::PairTile<C, E>;
  constexpr int WM = Tl::kWM, ST = Tl::kST, SLAB = Tl::kSlabBytes;
  const size_t n = static_cast<size_t>(B) * T * C;
  cudaError_t err;
  if constexpr (fvt_mma::is_bf16<E>()) {
    err = fvt_mrf::run_pairs<C>(mrf_pair_bf16_kernel<C, WM, ST, SLAB>, steps, nb, np, packed, x,
                                scratch, B, T, stream);
  } else {
    err = fvt_mrf::run_pairs<C>(mrf_pair_kernel<C, WM, ST>, steps, nb, np, packed, x, scratch,
                                B, T, stream);
  }
  if (err != cudaSuccess) return err;
  const size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 1056 ? blocks : 1056);
  const E* last = scratch + ((np - 1) % 2) * nb * n;
  if constexpr (fvt_mma::is_bf16<E>()) {
    mrf_mean_bf16_kernel<<<grid, kThreads, 0, stream>>>(last, n, nb, y);
  } else {
    mrf_mean_kernel<<<grid, kThreads, 0, stream>>>(last, n, nb, y);
  }
  return cudaGetLastError();
}

// Packs the stage's kernels, then runs it (`run_pairs_and_mean`): scratch
// holds 2 nb B T C floats, then the packed kernels.
template <int C>
cudaError_t run_stage(const float* x, float* y, float* scratch, int B, int T, int nb, int np,
                      const fvt_mrf::PairArgs* steps, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T * C;
  float* packed = scratch + 2 * nb * n;
  // the kernels come as (tap, c_out, c_in)
  cudaError_t err = fvt_mrf::pack_stage<C>(packed, steps, nb, np, false, stream);
  if (err != cudaSuccess) return err;
  return run_pairs_and_mean<C>(x, y, scratch, packed, B, T, nb, np, steps, stream);
}

template <int C>
long long scratch_floats(int B, int T, int nb, int np, const fvt_mrf::PairArgs* steps) {
  return static_cast<long long>(2 * static_cast<size_t>(nb) * B * T * C +
                                fvt_mrf::packed_layout<C>(steps, nb, np));
}

// the (branch, pair) table of the C entry points without its pointers;
// false for one it refuses
bool load_table(fvt_mrf::PairArgs* steps, int nb, int np, const int* ints) {
  const float* none[4 * kMaxBranches * kMaxPairs] = {};
  return nb >= 1 && nb <= kMaxBranches && np >= 1 && np <= kMaxPairs &&
         fvt_mrf::load_steps(steps, nb, np, ints, none) == cudaSuccess;
}

}  // namespace

extern "C" int fvt_fused_mrf_max_branches() { return kMaxBranches; }
extern "C" int fvt_fused_mrf_max_pairs() { return kMaxPairs; }

// floats of scratch `fvt_fused_mrf` needs; -1 for a table it refuses
extern "C" long long fvt_fused_mrf_scratch_floats(int B, int T, int C, int nb, int np,
                                                  const int* ints) {
  fvt_mrf::PairArgs steps[kMaxPairs];
  if (B < 1 || T < 1 || !load_table(steps, nb, np, ints)) return -1;
  switch (C) {
    case 16: return scratch_floats<16>(B, T, nb, np, steps);
    case 32: return scratch_floats<32>(B, T, nb, np, steps);
    case 64: return scratch_floats<64>(B, T, nb, np, steps);
    case 128: return scratch_floats<128>(B, T, nb, np, steps);
    case 256: return scratch_floats<256>(B, T, nb, np, steps);
    default: return -1;
  }
}

// x, y (B, T, C) float32 contiguous, C in {16, 32, 64, 128, 256}.
// scratch: `fvt_fused_mrf_scratch_floats` floats.  nb branches of
// np pairs each.  ints: per (branch, pair), branch-major, (K1, dilation, K2);
// weights: per (branch, pair) the device pointers (w1 (K1, C, C), b1 (C,),
// w2 (K2, C, C), b2 (C,)), each 16-byte aligned, the kernels laid out
// (tap, c_out, c_in).  Kernel sizes are odd.
// Returns the first CUDA error of the launches (0 = ok).
extern "C" int fvt_fused_mrf(const float* x, float* y, float* scratch, int B, int T, int C,
                             int nb, int np, const int* ints, const float* const* weights,
                             void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  fvt_mrf::PairArgs steps[kMaxPairs];
  cudaError_t err = fvt_mrf::load_steps(steps, nb, np, ints, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: err = run_stage<16>(x, y, scratch, B, T, nb, np, steps, s); break;
    case 32: err = run_stage<32>(x, y, scratch, B, T, nb, np, steps, s); break;
    case 64: err = run_stage<64>(x, y, scratch, B, T, nb, np, steps, s); break;
    case 128: err = run_stage<128>(x, y, scratch, B, T, nb, np, steps, s); break;
    case 256: err = run_stage<256>(x, y, scratch, B, T, nb, np, steps, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The bf16 form.  Elements (bf16) of the stage's packed kernels; -1 for a
// width or table it refuses.  ints as `fvt_fused_mrf` takes them.
extern "C" long long fvt_fused_mrf_bf16_packed_elems(int C, int nb, int np, const int* ints) {
  fvt_mrf::PairArgs steps[kMaxPairs];
  if (!load_table(steps, nb, np, ints)) return -1;
  switch (C) {
    case 16: return static_cast<long long>(fvt_mrf::packed_layout<16, bf16>(steps, nb, np));
    case 32: return static_cast<long long>(fvt_mrf::packed_layout<32, bf16>(steps, nb, np));
    case 64: return static_cast<long long>(fvt_mrf::packed_layout<64, bf16>(steps, nb, np));
    case 128: return static_cast<long long>(fvt_mrf::packed_layout<128, bf16>(steps, nb, np));
    case 256: return static_cast<long long>(fvt_mrf::packed_layout<256, bf16>(steps, nb, np));
    default: return -1;
  }
}

// packed (`fvt_fused_mrf_bf16_packed_elems` bf16, 16-byte aligned) = the
// stage's float32 kernels rounded to bf16 in the order the pair launches
// read them, in one launch on `stream`.  ints and weights as `fvt_fused_mrf`
// takes them, but for the kernels' layout: (tap, c_in, c_out), as the
// module holds them (the launch swaps their channel axes).
extern "C" int fvt_fused_mrf_bf16_pack(bf16* packed, int C, int nb, int np, const int* ints,
                                       const float* const* weights, void* stream) {
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

// x, y (B, T, C) bf16 contiguous, C in {16, 32, 64, 128, 256}; scratch
// 2 nb B T C bf16; packed as `fvt_fused_mrf_bf16_pack` wrote it from the
// same table; ints and weights as `fvt_fused_mrf_bf16_pack` takes them, of
// which this call reads the biases (float32).  Returns the first CUDA error
// of the launches (0 = ok).
extern "C" int fvt_fused_mrf_bf16(const bf16* x, bf16* y, bf16* scratch, const bf16* packed,
                                  int B, int T, int C, int nb, int np, const int* ints,
                                  const float* const* weights, void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  fvt_mrf::PairArgs steps[kMaxPairs];
  cudaError_t err = fvt_mrf::load_steps(steps, nb, np, ints, weights);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FVT_RUN(CC) run_pairs_and_mean<CC>(x, y, scratch, packed, B, T, nb, np, steps, s)
  switch (C) {
    case 16: err = FVT_RUN(16); break;
    case 32: err = FVT_RUN(32); break;
    case 64: err = FVT_RUN(64); break;
    case 128: err = FVT_RUN(128); break;
    case 256: err = FVT_RUN(256); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FVT_RUN
  return static_cast<int>(err);
}
