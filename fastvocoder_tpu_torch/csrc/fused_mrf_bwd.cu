// Backward of one HiFiGAN MRF stage: from x and the cotangent g of
// y = mean_br chain_br(x), the cotangent dx and the gradient of every
// weight and bias of the stage, all float32.
//
// Replaces: fastvocoder_tpu/ops/fused_mrf.py::_mrf_bwd_kernel (driven by
// `_run_mrf_bwd` and the per-branch split of `_mrf_interior_bwd`).
//
// Each branch is a chain of pairs
//     a = leaky(h); t1 = conv1_K1,d(a) + b1; u = leaky(t1) (zero outside
//     [0, T)); h' = h + conv2_K2(u) + b2
// with slope 0.1 and zero "same" padding.  Given dh', a pair's backward is
//     db2 = sum dh'            dW2[k] = sum_r u[r + k - m2]^T dh'[r]
//     du  = conv2^T(dh')       dt1 = du * leaky'(t1)   (sign of u)
//     db1 = sum dt1            dW1[k] = sum_r a[r + (k - h1) d]^T dt1[r]
//     dh  = dh' + conv1^T(dt1) * leaky'(h)
// and g / n_branches enters every branch's last pair; dx is the sum of the
// branches' dh of their first pair.
//
// Bound on an H100: operations.  The forward costs 252 C^2 FLOP a row for
// HiFiGAN's stage; the backward recomputes it and does twice as much again
// (one adjoint conv and one weight gradient per conv): 756 C^2 a row.  All
// of it is dense contraction, so all of it runs on the tensor cores in
// 3xTF32 with float32 accumulation (wgmma, mma_common.cuh), which keeps
// float32 accuracy at a ceiling of 165 TFLOP/s instead of the CUDA cores' 67.
//
// The TPU kernel recomputed every intermediate of a branch in VMEM over one
// tile and carried dW in scratch across its sequential grid.  Here:
//   * the intermediates do not fit in 227 KB beside a tile, so the stage is
//     recomputed from x into device memory by the forward's pair launches
//     (`mrf_bwd_pair_kernel`, the forward's body), one per pair position for
//     all branches, which also store each pair's activated u from shared
//     memory (2 np - 1
//     tensors of B T C floats per branch; the sign of u stands for the sign
//     of t1); the last position stops after u;
//   * then the pairs run last to first, four launches each for all branches
//     at once (blockIdx.z = branch): conv2's adjoint with the leaky mask
//     (-> dt1), dW2 and db2, conv1's adjoint with mask and residual
//     (-> dh), dW1 and db1.  An adjoint is `mrf_bwd_conv_kernel` with the
//     taps walked backwards and the forward's own weight layout (the
//     produced channel of an adjoint is the forward's input channel); dt1
//     crosses device memory once per pair;
//   * a weight gradient is a split-K GEMM on wgmma (`mrf_bwd_wgrad_kernel`,
//     `fvt_mma::wgrad_body` says how), summed over blocks in a fixed order:
//     no atomics, the same bits from run to run.
//   * the kernels are taken as the module holds them, (tap, c_in, c_out),
//     and packed for the tensor cores by one launch in both orientations:
//     as the recompute's forward convs read them (channel axes swapped by
//     the pack) and as the adjoints do.
// Scratch, in floats, n = B T C: n (g / n_branches) + per branch
// (2 np + 2) n (h of pairs 1.., u of every pair, dt1, two dh used in turn)
// + the kernels packed for the tensor cores, as the forward convs and as the
// adjoints read them + the weight gradients' partials.
//
// The bf16 form (`fvt_fused_mrf_bwd_bf16`, kernel 5b: bf16 x, g, weights
// and biases, as a model trained with compute_dtype bf16 hands them)
// computes what the Pallas body does with bf16 inputs (`_mrf_bwd_kernel`
// upcasts them and recomputes in float32; dx and dW are cast back): one
// launch widens the inputs into float32 scratch (exact), the float32 passes
// above run on them unchanged, and one launch rounds dx and every dW and db
// to bf16, once.  The TPU path summed the branches' dx in bf16 and, below
// C = 128, the VJP of its blocked weights summed bf16 partials; here both
// sums stay float32 until the one rounding.  A bf16 weight is exact in TF32 (its lo half is
// zero); this form still runs all three products.  Extra scratch: 3 n (x,
// g and dx in float32) + twice the weights' floats.

#include "bwd_common.cuh"
#include "mma_common.cuh"

namespace {

using fvt_bwd::divide_kernel;
using fvt_bwd::elementwise_blocks;
using fvt_bwd::kThreads;
using fvt_bwd::sum_kernel;
using fvt_bwd::SumArgs;
using fvt_bwd::WgradArgs;
using fvt_mma::kMaxZ;

constexpr int kMaxBranches = kMaxZ;
constexpr int kMaxPairs = 8;
constexpr float kSlope = 0.1f;  // leaky-relu slope of HiFiGAN's resblocks

static_assert(fvt_bwd::kMaxZ == kMaxZ, "one launch holds every branch in both headers");
static_assert(2 * kMaxBranches * kMaxPairs <= fvt_mma::kMaxPack, "one pack launch a side");

FVT_MMA_PAIR_KERNEL(mrf_bwd_pair_kernel)
FVT_MMA_CONV_KERNEL(mrf_bwd_conv_kernel)
FVT_MMA_WGRAD_KERNEL(mrf_bwd_wgrad_kernel)
FVT_BWD_WIDEN_KERNEL(mrf_bwd_bf16_widen_kernel)
FVT_BWD_NARROW_KERNEL(mrf_bwd_bf16_narrow_kernel)

// ---------------------------------------------------------------------------
// the stage
// ---------------------------------------------------------------------------

struct Pair {
  int K1, d, K2;
  // w (tap, c_in, c_out) as the module holds it
  const float *w1, *b1, *w2, *b2;
  float *dw1, *db1, *dw2, *db2;
};

// floats of the stage's packed kernels (both orientations) and of the
// partials the largest weight-gradient launch of the stage needs
template <int C>
size_t partial_floats(int B, int T, int nb, int np, const int* ints) {
  size_t packed = 0;
  for (int i = 0; i < nb * np; ++i) {
    packed += 2 * (fvt_mma::packed_floats<C>(ints[3 * i]) + fvt_mma::packed_floats<C>(ints[3 * i + 2]));
  }
  size_t most = 0;
  for (int p = 0; p < np; ++p) {
    for (int which = 0; which < 3; which += 2) {  // K1, then K2
      int K[kMaxZ];
      for (int br = 0; br < nb; ++br) K[br] = ints[3 * (br * np + p) + which];
      const size_t need = fvt_mma::wgrad_floats<C>(B, T, K, nb);
      most = most > need ? most : need;
    }
  }
  return packed + most;
}

template <int C>
cudaError_t run_bwd(const float* x, const float* g, float* dx, float* scratch, int B, int T,
                    int nb, int np, const Pair (*pairs)[kMaxPairs], cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T * C;
  float* gs = scratch;
  float* per_branch = scratch + n;
  const size_t branch_floats = static_cast<size_t>(2 * np + 2) * n;
  float* packed = per_branch + nb * branch_floats;
  // the kernels packed for the tensor cores: per (branch, pair) conv1 and
  // conv2 as the forward reads them ([0], channel axes swapped), then as the
  // adjoints do ([1])
  const float* pk[2][kMaxBranches][kMaxPairs][2];
  for (int side = 0; side < 2; ++side) {
    fvt_mma::PackArgs pack;
    int i = 0;
    for (int br = 0; br < nb; ++br) {
      for (int p = 0; p < np; ++p) {
        const Pair& q = pairs[br][p];
        const float* src[2] = {q.w1, q.w2};
        const int K[2] = {q.K1, q.K2};
        for (int c = 0; c < 2; ++c, ++i) {
          pack.src[i] = src[c];
          pack.dst[i] = packed;
          pack.K[i] = K[c];
          pack.swap[i] = side == 0;
          pk[side][br][p][c] = packed;
          packed += fvt_mma::packed_floats<C>(K[c]);
        }
      }
    }
    const cudaError_t perr = fvt_mma::launch_pack<C>(pack, i, stream);
    if (perr != cudaSuccess) return perr;
  }
  float* partials = packed;
  // buffers of branch br
  auto h_in = [&](int br, int p) -> const float* {
    return p == 0 ? x : per_branch + br * branch_floats + static_cast<size_t>(p - 1) * n;
  };
  auto u_of = [&](int br, int p) -> float* {
    return per_branch + br * branch_floats + static_cast<size_t>(np - 1 + p) * n;
  };
  auto dt_of = [&](int br) -> float* {
    return per_branch + br * branch_floats + static_cast<size_t>(2 * np - 1) * n;
  };
  auto dh_of = [&](int br, int p) -> float* {
    return per_branch + br * branch_floats + static_cast<size_t>(2 * np + p % 2) * n;
  };

  divide_kernel<<<elementwise_blocks(n), kThreads, 0, stream>>>(g, static_cast<float>(nb), n, gs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // recompute: u of every pair, h of every pair but the first
  for (int p = 0; p < np; ++p) {
    fvt_mma::PairArgs a;
    a.slope = kSlope;
    for (int z = 0; z < kMaxZ; ++z) {
      const int br = z < nb ? z : 0;
      const Pair& q = pairs[br][p];
      a.src[z] = h_in(br, p);
      a.dst[z] = p == np - 1 ? nullptr : const_cast<float*>(h_in(br, p + 1));
      a.u_dst[z] = u_of(br, p);
      a.w1[z] = pk[0][br][p][0];
      a.b1[z] = q.b1;
      a.w2[z] = pk[0][br][p][1];
      a.b2[z] = q.b2;
      a.k1[z] = q.K1;
      a.dil[z] = q.d;
      a.k2[z] = q.K2;
    }
    err = FVT_MMA_LAUNCH_PAIR(mrf_bwd_pair_kernel, C, a, nb, B, T, stream);
    if (err != cudaSuccess) return err;
  }

  for (int p = np - 1; p >= 0; --p) {
    auto dh_out = [&](int br) -> const float* { return p == np - 1 ? gs : dh_of(br, p + 1); };
    fvt_mma::ConvArgs a;
    WgradArgs w;
    // dt1 = conv2^T(dh') * leaky'(t1)
    fvt_mma::clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      a.src[br] = dh_out(br);
      a.w[br] = pk[1][br][p][1];
      a.K[br] = q.K2;
      a.sgn[br] = u_of(br, p);
      a.dst[br] = dt_of(br);
    }
    err = FVT_MMA_LAUNCH_CONV(mrf_bwd_conv_kernel, C, a, nb, B, T, stream);
    if (err != cudaSuccess) return err;
    // dW2, db2
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      w.a[br] = u_of(br, p);
      w.dy[br] = dh_out(br);
      w.dw[br] = q.dw2;
      w.db[br] = q.db2;
      w.K[br] = q.K2;
      w.dil[br] = 1;
      w.reflect[br] = 0;
      w.slope[br] = 1.0f;
    }
    err = FVT_MMA_LAUNCH_WGRAD(mrf_bwd_wgrad_kernel, C, w, nb, B, T, partials, stream);
    if (err != cudaSuccess) return err;
    // dh = dh' + conv1^T(dt1) * leaky'(h)
    fvt_mma::clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      a.src[br] = dt_of(br);
      a.w[br] = pk[1][br][p][0];
      a.K[br] = q.K1;
      a.dil[br] = q.d;
      a.sgn[br] = h_in(br, p);
      a.res[br] = dh_out(br);
      a.dst[br] = dh_of(br, p);
    }
    err = FVT_MMA_LAUNCH_CONV(mrf_bwd_conv_kernel, C, a, nb, B, T, stream);
    if (err != cudaSuccess) return err;
    // dW1, db1
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      w.a[br] = h_in(br, p);
      w.dy[br] = dt_of(br);
      w.dw[br] = q.dw1;
      w.db[br] = q.db1;
      w.K[br] = q.K1;
      w.dil[br] = q.d;
      w.reflect[br] = 0;
      w.slope[br] = kSlope;
    }
    err = FVT_MMA_LAUNCH_WGRAD(mrf_bwd_wgrad_kernel, C, w, nb, B, T, partials, stream);
    if (err != cudaSuccess) return err;
  }

  SumArgs s;
  for (int br = 0; br < nb; ++br) s.src[br] = dh_of(br, 0);
  sum_kernel<<<elementwise_blocks(n), kThreads, 0, stream>>>(s, nb, n, dx);
  return cudaGetLastError();
}

// elements of pair i's (w1, b1, w2, b2)
void pair_sizes(int C, const int* ints, int i, long long* n) {
  const long long cc = static_cast<long long>(C) * C;
  n[0] = ints[3 * i] * cc;
  n[1] = C;
  n[2] = ints[3 * i + 2] * cc;
  n[3] = C;
}

// the float32 scratch the bf16 form needs beyond the float32 form's
size_t bf16_extra_floats(int B, int T, int C, int nb, int np, const int* ints) {
  size_t weights = 0;
  for (int i = 0; i < nb * np; ++i) {
    long long n[4];
    pair_sizes(C, ints, i, n);
    weights += static_cast<size_t>(n[0] + n[1] + n[2] + n[3]);
  }
  return static_cast<size_t>(3) * B * T * C + 2 * weights;
}

// the float32 form on float32 operands: per pair 4 weight pointers and 4
// gradient pointers, as the C entry takes them
cudaError_t run_stage(const float* x, const float* g, float* dx, float* scratch, int B, int T,
                      int C, int nb, int np, const int* ints, const float* const* weights,
                      float* const* grads, cudaStream_t s) {
  Pair pairs[kMaxBranches][kMaxPairs];
  for (int br = 0; br < nb; ++br) {
    for (int p = 0; p < np; ++p) {
      const int i = br * np + p;
      Pair& q = pairs[br][p];
      q.K1 = ints[3 * i];
      q.d = ints[3 * i + 1];
      q.K2 = ints[3 * i + 2];
      q.w1 = weights[4 * i];
      q.b1 = weights[4 * i + 1];
      q.w2 = weights[4 * i + 2];
      q.b2 = weights[4 * i + 3];
      q.dw1 = grads[4 * i];
      q.db1 = grads[4 * i + 1];
      q.dw2 = grads[4 * i + 2];
      q.db2 = grads[4 * i + 3];
    }
  }
  switch (C) {
    case 16: return run_bwd<16>(x, g, dx, scratch, B, T, nb, np, pairs, s);
    case 32: return run_bwd<32>(x, g, dx, scratch, B, T, nb, np, pairs, s);
    case 64: return run_bwd<64>(x, g, dx, scratch, B, T, nb, np, pairs, s);
    case 128: return run_bwd<128>(x, g, dx, scratch, B, T, nb, np, pairs, s);
    case 256: return run_bwd<256>(x, g, dx, scratch, B, T, nb, np, pairs, s);
    default: return cudaErrorInvalidValue;
  }
}

bool table_ok(int nb, int np, const int* ints) {
  if (nb < 1 || nb > kMaxBranches || np < 1 || np > kMaxPairs) return false;
  for (int i = 0; i < nb * np; ++i) {
    const int* v = ints + 3 * i;
    if (v[0] < 1 || v[0] % 2 == 0 || v[1] < 1 || v[2] < 1 || v[2] % 2 == 0) return false;
  }
  return true;
}

}  // namespace

extern "C" int fvt_fused_mrf_bwd_max_branches() { return kMaxBranches; }
extern "C" int fvt_fused_mrf_bwd_max_pairs() { return kMaxPairs; }

// floats of scratch `fvt_fused_mrf_bwd` needs; -1 for a table it refuses
extern "C" long long fvt_fused_mrf_bwd_scratch_floats(int B, int T, int C, int nb, int np,
                                                      const int* ints) {
  if (B < 1 || T < 1 || !table_ok(nb, np, ints)) return -1;
  size_t partials;
  switch (C) {
    case 16: partials = partial_floats<16>(B, T, nb, np, ints); break;
    case 32: partials = partial_floats<32>(B, T, nb, np, ints); break;
    case 64: partials = partial_floats<64>(B, T, nb, np, ints); break;
    case 128: partials = partial_floats<128>(B, T, nb, np, ints); break;
    case 256: partials = partial_floats<256>(B, T, nb, np, ints); break;
    default: return -1;
  }
  const size_t n = static_cast<size_t>(B) * T * C;
  return static_cast<long long>(n + static_cast<size_t>(nb) * (2 * np + 2) * n + partials);
}

// x, g, dx (B, T, C) float32 contiguous, C in {16, 32, 64, 128, 256}.
// ints: per (branch, pair), branch-major, (K1, dilation, K2).  weights: per
// (branch, pair) the device pointers (w1 (K1, C, C), b1 (C,), w2 (K2, C, C),
// b2 (C,)), w (tap, c_in, c_out) as the module holds it.  grads: per
// (branch, pair) the outputs (dw1 (K1, C, C), db1 (C,), dw2 (K2, C, C),
// db2 (C,)), (tap, c_in, c_out).  scratch: `fvt_fused_mrf_bwd_scratch_floats`
// floats.  Every pointer 16-byte aligned.  Returns the first CUDA error of
// the launches (0 = ok).
extern "C" int fvt_fused_mrf_bwd(const float* x, const float* g, float* dx, float* scratch,
                                 int B, int T, int C, int nb, int np, const int* ints,
                                 const float* const* weights, float* const* grads,
                                 void* stream) {
  if (B < 1 || T < 1 || !table_ok(nb, np, ints)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_stage(x, g, dx, scratch, B, T, C, nb, np, ints, weights, grads,
                                    static_cast<cudaStream_t>(stream)));
}

// floats of scratch `fvt_fused_mrf_bwd_bf16` needs; -1 as above
extern "C" long long fvt_fused_mrf_bwd_bf16_scratch_floats(int B, int T, int C, int nb, int np,
                                                           const int* ints) {
  const long long base = fvt_fused_mrf_bwd_scratch_floats(B, T, C, nb, np, ints);
  if (base < 0) return -1;
  return base + static_cast<long long>(bf16_extra_floats(B, T, C, nb, np, ints));
}

// x, g, dx (B, T, C) bf16 contiguous; ints as `fvt_fused_mrf_bwd` takes
// them; weights: per (branch, pair) the device pointers (w1, b1, w2, b2),
// bf16, w (tap, c_in, c_out); grads: per (branch, pair)
// (dw1, db1, dw2, db2), bf16.  scratch: `fvt_fused_mrf_bwd_bf16_scratch_floats`
// floats.  dx and every dW and db are the float32 form's on the widened
// inputs, rounded to bf16 once.
extern "C" int fvt_fused_mrf_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                      __nv_bfloat16* dx, float* scratch, int B, int T, int C,
                                      int nb, int np, const int* ints,
                                      const __nv_bfloat16* const* weights,
                                      __nv_bfloat16* const* grads, void* stream) {
  if (B < 1 || T < 1 || !table_ok(nb, np, ints)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kMost = 2 + 4 * kMaxBranches * kMaxPairs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_el = static_cast<long long>(B) * T * C;
  const int n_pairs = nb * np;
  // float32 x, g, dx, then the weights' copies, then their gradients
  float* x32 = scratch;
  float* g32 = x32 + n_el;
  float* dx32 = g32 + n_el;
  float* at = dx32 + n_el;
  const void* src[kMost];
  void* dst[kMost];
  long long count[kMost];
  long long sizes[4 * kMaxBranches * kMaxPairs];
  const float* w32[4 * kMaxBranches * kMaxPairs];
  float* d32[4 * kMaxBranches * kMaxPairs];
  for (int i = 0; i < n_pairs; ++i) pair_sizes(C, ints, i, sizes + 4 * i);
  src[0] = x, dst[0] = x32, count[0] = n_el;
  src[1] = g, dst[1] = g32, count[1] = n_el;
  for (int i = 0; i < 4 * n_pairs; ++i) {
    src[2 + i] = weights[i], dst[2 + i] = at, count[2 + i] = sizes[i];
    w32[i] = at;
    at += sizes[i];
  }
  for (int i = 0; i < 4 * n_pairs; ++i) {
    d32[i] = at;
    at += sizes[i];
  }
  cudaError_t err = fvt_bwd::launch_convert(mrf_bwd_bf16_widen_kernel, src, dst, count,
                                            2 + 4 * n_pairs, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_stage(x32, g32, dx32, at, B, T, C, nb, np, ints, w32, d32, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  src[0] = dx32, dst[0] = dx, count[0] = n_el;
  for (int i = 0; i < 4 * n_pairs; ++i) {
    src[1 + i] = d32[i], dst[1 + i] = grads[i], count[1 + i] = sizes[i];
  }
  return static_cast<int>(fvt_bwd::launch_convert(mrf_bwd_bf16_narrow_kernel, src, dst, count,
                                                  1 + 4 * n_pairs, st));
}
