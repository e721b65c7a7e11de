// One HiFiGAN MRF stage: the mean over ResBlock1 branches, forward only.
//
// Replaces: fastvocoder_tpu/ops/fused_mrf.py::_mrf_kernel (driven by
// `_run_mrf_fwd`), forward only.
//
// y = mean_br chain_br(x) over x (B, T, C) float32, channels last, C in
// {16, 32, 64, 128, 256}, any T >= 1 and any B; each chain is a sequence of
// pairs (see mrf_common.cuh).
//
// Bound on an H100: operations.  A row costs 2 * 2 * sum_br sum_pairs
// (K1 + K2) * C^2 FLOP, 252 C^2 for the k = 3 / 7 / 11, d = 1 / 3 / 5 stage
// of HiFiGAN: 19.3 GFLOP for the (1, 4680, 128) stage of a 585-frame
// utterance, against 4.8 MB of input and output.
//
// The TPU kernel ran the whole stage from VMEM over one tile with a halo of
// 60 rows (the k = 11 chain).  Here a block has at most 227 KB of shared
// memory, and a 60-row halo on a tile that fits would cost 1.7x the
// operations in recomputed rows at C = 128.  So the stage runs as
//   * one launch per pair position, all branches at once (blockIdx.z =
//     branch), each reading the branch's h and writing h' to a scratch
//     buffer (two sets, used in turn): the halo of a pair is at most
//     m1 + m2 = 30 rows, and only the 2 m2 <= 10 rows of u are recomputed;
//     3 branches give 3x the blocks, which fills the 132 SMs at batch 1;
//   * a memory-bound launch that writes the mean of the branches, summed in
//     the plain version's order (((b0 + b1) + b2) / n).
// Intermediates between launches (B T C floats per branch) stay in L2 at
// batch 1 and cost a few percent of the stage's time.

#include "mrf_common.cuh"

namespace {

using namespace fvt_mrf;

FVT_PAIR_KERNEL(mrf_pair_kernel)

__global__ void __launch_bounds__(kThreads)
mrf_mean_kernel(const float* __restrict__ out, size_t n, int nb, float* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    reinterpret_cast<float4*>(y)[i] = branch_mean4(out, n, nb, i);
  }
}

template <int C>
cudaError_t run_stage(const float* x, float* y, float* scratch, int B, int T, int nb, int np,
                      PairArgs* steps, cudaStream_t stream) {
  cudaError_t err = launch_pairs<C, mrf_pair_kernel<C>>(steps, nb, np, x, scratch, B, T, stream);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * T * C;
  const size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  mrf_mean_kernel<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056), kThreads, 0, stream>>>(
      scratch + ((np - 1) % 2) * nb * n, n, nb, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fvt_fused_mrf_max_branches() { return kMaxBranches; }
extern "C" int fvt_fused_mrf_max_pairs() { return kMaxPairs; }

// x, y (B, T, C) float32 contiguous, C in {16, 32, 64, 128, 256}.
// scratch: 2 * nb * B * T * C floats.  nb branches of
// np pairs each.  ints: per (branch, pair), branch-major, (K1, dilation, K2);
// weights: per (branch, pair) the device pointers (w1 (K1, C, C), b1 (C,),
// w2 (K2, C, C), b2 (C,)), each 16-byte aligned.  Kernel sizes are odd.
// Returns the first CUDA error of the launches (0 = ok).
extern "C" int fvt_fused_mrf(const float* x, float* y, float* scratch, int B, int T, int C,
                             int nb, int np, const int* ints, const float* const* weights,
                             void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  PairArgs steps[kMaxPairs];
  cudaError_t err = load_steps(steps, nb, np, ints, weights);
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
