// The operand table and the branch mean shared by the MRF-stage kernel
// (fused_mrf.cu) and the HiFiGAN-tail kernel (fused_tail.cu).
//
// A HiFiGAN MRF stage is the mean over branches (ResBlock1, kernel sizes
// 3 / 7 / 11) of a chain of pairs, each
//
//     h' = h + conv2_K2(leaky(conv1_K1,d(leaky(h)) + b1)) + b2
//
// with leaky slope 0.1 and zero "same" padding on every conv's own input,
// over x (B, T, C) float32, channels last.  Both kernels run a stage as one
// launch per pair position, all branches of that position at once, on the
// tensor-core pair body of mma_common.cuh, each writing the branch's h' to
// scratch; a last, memory-bound launch folds the branches' mean (and, in
// the tail, the output head).  What they share here: the (branch, pair)
// table their C entry points take (`PairArgs`, `load_steps`), the packing
// of a stage's kernels for the tensor cores (`packed_layout`, `pack_stage`:
// once a call in the MRF kernel, once a kept table in the tail), the pair
// launches (`run_pairs`), and the mean in the plain version's order
// (`branch_mean4`); each in the float32 form and the bf16 one (E).

#pragma once

#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace fvt_mrf {

constexpr int kThreads = 256;  // threads of the memory-bound launches
constexpr int kMaxBranches = 4;
constexpr int kMaxPairs = 8;
constexpr float kSlope = 0.1f;  // leaky-relu slope of HiFiGAN's resblocks

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One pair position of up to kMaxBranches branches, as the C entry points
// give it: kernels in the caller's layout, before packing.
struct PairArgs {
  const float* w1[kMaxBranches];  // (K1, C, C)
  const float* b1[kMaxBranches];  // (C,)
  const float* w2[kMaxBranches];  // (K2, C, C)
  const float* b2[kMaxBranches];  // (C,)
  int k1[kMaxBranches];
  int dil[kMaxBranches];
  int k2[kMaxBranches];
};

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

static_assert(kMaxBranches <= fvt_mma::kMaxZ, "a launch holds every branch");
static_assert(2 * kMaxBranches * kMaxPairs <= fvt_mma::kMaxPack, "one pack launch a stage");

// Elements (of the form's type E) of the packed kernels of a stage
// (`pack_stage`) and, where `off` is given, each kernel's offset among them:
// pair by pair, branch by branch, conv1 then conv2.
template <int C, typename E = float>
size_t packed_layout(const PairArgs* steps, int nb, int np,
                     size_t (*off)[kMaxBranches][2] = nullptr) {
  size_t total = 0;
  for (int p = 0; p < np; ++p) {
    for (int br = 0; br < nb; ++br) {
      const int K[2] = {steps[p].k1[br], steps[p].k2[br]};
      for (int c = 0; c < 2; ++c) {
        if (off != nullptr) off[p][br][c] = total;
        total += fvt_mma::packed_elems<C, E>(K[c]);
      }
    }
  }
  return total;
}

// packed (`packed_layout` elements) = every kernel of the stage in the form
// the pair launches read (TF32 halves, or bf16), by one launch.  `swap`: the
// kernels are given as (tap, c_in, c_out), else as (tap, c_out, c_in).
template <int C, typename E>
cudaError_t pack_stage(E* packed, const PairArgs* steps, int nb, int np, bool swap,
                       cudaStream_t stream) {
  size_t off[kMaxPairs][kMaxBranches][2];
  packed_layout<C, E>(steps, nb, np, off);
  fvt_mma::PackArgsT<E> pack;
  int i = 0;
  for (int p = 0; p < np; ++p) {
    for (int br = 0; br < nb; ++br) {
      const float* src[2] = {steps[p].w1[br], steps[p].w2[br]};
      const int K[2] = {steps[p].k1[br], steps[p].k2[br]};
      for (int c = 0; c < 2; ++c, ++i) {
        pack.src[i] = src[c];
        pack.dst[i] = packed + off[p][br][c];
        pack.K[i] = K[c];
        pack.swap[i] = swap ? 1 : 0;
      }
    }
  }
  return fvt_mma::launch_pack<C>(pack, i, stream);
}

// Runs the np pair positions of every branch on x (B, T, C), one launch of
// `kernel` (a FVT_MMA_PAIR_KERNEL or FVT_MMA_BF16_PAIR_KERNEL at <C, WM,
// ST>) each, all branches at once, reading the kernels `pack_stage` wrote to
// `packed` and writing h' to scratch (2 nb B T C elements: two sets of nb
// buffers used in turn).  The branches' outputs end in set (np - 1) % 2:
// buffer br at scratch + ((np - 1) % 2 * nb + br) B T C.
template <int C, typename E, int WM = fvt_mma::Tile<C>::kWM, int ST = fvt_mma::Tile<C>::kST>
cudaError_t run_pairs(fvt_mma::PairKernelT<E> kernel, const PairArgs* steps, int nb, int np,
                      const E* packed, const E* x, E* scratch, int B, int T,
                      cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T * C;
  size_t off[kMaxPairs][kMaxBranches][2];
  packed_layout<C, E>(steps, nb, np, off);
  for (int p = 0; p < np; ++p) {
    fvt_mma::PairArgsT<E> a;
    a.slope = kSlope;
    for (int br = 0; br < fvt_mma::kMaxZ; ++br) {
      const int z = br < nb ? br : 0;
      a.src[br] = p == 0 ? x : scratch + (((p - 1) % 2) * nb + z) * n;
      a.dst[br] = scratch + ((p % 2) * nb + z) * n;
      a.u_dst[br] = nullptr;
      a.w1[br] = packed + off[p][z][0];
      a.b1[br] = steps[p].b1[z];
      a.w2[br] = packed + off[p][z][1];
      a.b2[br] = steps[p].b2[z];
      a.k1[br] = steps[p].k1[z];
      a.dil[br] = steps[p].dil[z];
      a.k2[br] = steps[p].k2[z];
    }
    const cudaError_t err = fvt_mma::launch_pair<C, WM, ST>(kernel, a, nb, B, T, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The mean of the nb branch outputs at elements 4 i .. 4 i + 3: (((b0 + b1)
// + b2) ...) / nb, the plain version's order; the bf16 form rounds each sum
// and the quotient, as fused_mrf.py's Pallas body does.
template <typename E>
__device__ __forceinline__ float4 branch_mean4(const E* out, size_t n, int nb, size_t i) {
  using fvt_mma::fit;
  float4 s = fvt_mma::load4(out + 4 * i);
  for (int br = 1; br < nb; ++br) {
    const float4 v = add4(s, fvt_mma::load4(out + br * n + 4 * i));
    s = make_float4(fit<E>(v.x), fit<E>(v.y), fit<E>(v.z), fit<E>(v.w));
  }
  const float f = static_cast<float>(nb);
  return make_float4(fit<E>(s.x / f), fit<E>(s.y / f), fit<E>(s.z / f), fit<E>(s.w / f));
}

}  // namespace fvt_mrf
