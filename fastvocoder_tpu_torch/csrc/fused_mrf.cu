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

#include "mma_common.cuh"
#include "mrf_common.cuh"

namespace {

using fvt_mrf::kMaxBranches;
using fvt_mrf::kMaxPairs;
using fvt_mrf::kThreads;

FVT_MMA_PAIR_KERNEL(mrf_pair_kernel)

__global__ void __launch_bounds__(kThreads)
mrf_mean_kernel(const float* __restrict__ out, size_t n, int nb, float* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    reinterpret_cast<float4*>(y)[i] = fvt_mrf::branch_mean4(out, n, nb, i);
  }
}

// Packs the stage's kernels, then runs the np pair positions of every
// branch, one launch each, h' to scratch (2 nb B T C floats: two sets of nb
// buffers used in turn; the packed kernels follow), then the mean of the
// buffers the last position wrote.
template <int C>
cudaError_t run_stage(const float* x, float* y, float* scratch, int B, int T, int nb, int np,
                      const fvt_mrf::PairArgs* steps, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T * C;
  float* packed = scratch + 2 * nb * n;
  // the kernels come as (tap, c_out, c_in)
  cudaError_t err = fvt_mrf::pack_stage<C>(packed, steps, nb, np, false, stream);
  if (err != cudaSuccess) return err;
  err = fvt_mrf::run_pairs<C>(mrf_pair_kernel<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>,
                              steps, nb, np, packed, x, scratch, B, T, stream);
  if (err != cudaSuccess) return err;
  const size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  mrf_mean_kernel<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056), kThreads, 0, stream>>>(
      scratch + ((np - 1) % 2) * nb * n, n, nb, y);
  return cudaGetLastError();
}

template <int C>
long long scratch_floats(int B, int T, int nb, int np, const fvt_mrf::PairArgs* steps) {
  return static_cast<long long>(2 * static_cast<size_t>(nb) * B * T * C +
                                fvt_mrf::packed_layout<C>(steps, nb, np));
}

}  // namespace

extern "C" int fvt_fused_mrf_max_branches() { return kMaxBranches; }
extern "C" int fvt_fused_mrf_max_pairs() { return kMaxPairs; }

// floats of scratch `fvt_fused_mrf` needs; -1 for a table it refuses
extern "C" long long fvt_fused_mrf_scratch_floats(int B, int T, int C, int nb, int np,
                                                  const int* ints) {
  if (B < 1 || T < 1) return -1;
  fvt_mrf::PairArgs steps[kMaxPairs];
  const float* none[4 * kMaxBranches * kMaxPairs] = {};
  if (nb < 1 || nb > kMaxBranches || np < 1 || np > kMaxPairs ||
      fvt_mrf::load_steps(steps, nb, np, ints, none) != cudaSuccess) {
    return -1;
  }
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
