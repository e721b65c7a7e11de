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
// (one adjoint conv and one weight gradient per conv): 756 C^2 a row.
//
// The TPU kernel recomputed every intermediate of a branch in VMEM over one
// tile and carried dW in scratch across its sequential grid.  Here:
//   * the intermediates do not fit in 227 KB beside a tile, so the stage is
//     recomputed from x into device memory, pair by pair, by forward
//     launches that keep each pair's input h and activated u (2 np - 1
//     tensors of B T C floats per branch; the sign of u stands for the sign
//     of t1);
//   * then the pairs run last to first, four launches each for all branches
//     at once (blockIdx.z = branch): conv2's adjoint with the leaky mask
//     (-> dt1), dW2 and db2, conv1's adjoint with mask and residual
//     (-> dh), dW1 and db1.  Each launch is one of the two passes of
//     bwd_common.cuh; dt1 crosses device memory once per pair;
//   * dW and db are summed over rows in two stages (partials per block of
//     rows, then a fixed-order reduction): no atomics, the same bits from
//     run to run.
// Scratch, in floats, n = B T C: n (g / n_branches) + per branch
// (2 np + 2) n (h of pairs 1.., u of every pair, dt1, two dh used in turn)
// + the weight gradients' partials.

#include "bwd_common.cuh"

namespace {

using namespace fvt_bwd;

constexpr int kMaxBranches = kMaxZ;
constexpr int kMaxPairs = 8;
constexpr float kSlope = 0.1f;  // leaky-relu slope of HiFiGAN's resblocks

struct Pair {
  int K1, d, K2;
  const float *w1, *b1, *w2, *b2, *w1t, *w2t;
  float *dw1, *db1, *dw2, *db2;
};

int max_taps(const int* ints, int nb, int np) {
  int k = 1;
  for (int i = 0; i < nb * np; ++i) {
    k = k > ints[3 * i] ? k : ints[3 * i];
    k = k > ints[3 * i + 2] ? k : ints[3 * i + 2];
  }
  return k;
}

template <int C>
cudaError_t run_bwd(const float* x, const float* g, float* dx, float* scratch, int B, int T,
                    int nb, int np, const Pair (*pairs)[kMaxPairs], cudaStream_t stream) {
  const size_t n = static_cast<size_t>(B) * T * C;
  float* gs = scratch;
  float* per_branch = scratch + n;
  const size_t branch_floats = static_cast<size_t>(2 * np + 2) * n;
  float* partials = per_branch + nb * branch_floats;
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
    ConvArgs a;
    clear(a);
    a.in_slope = kSlope;
    a.out_slope = kSlope;
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      a.src[br] = h_in(br, p);
      a.w[br] = q.w1;
      a.bias[br] = q.b1;
      a.K[br] = q.K1;
      a.dil[br] = q.d;
      a.dst[br] = u_of(br, p);
    }
    err = launch_conv<C>(a, nb, B, T, stream);
    if (err != cudaSuccess) return err;
    if (p == np - 1) break;
    clear(a);
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      a.src[br] = u_of(br, p);
      a.w[br] = q.w2;
      a.bias[br] = q.b2;
      a.K[br] = q.K2;
      a.res[br] = h_in(br, p);
      a.dst[br] = const_cast<float*>(h_in(br, p + 1));
    }
    err = launch_conv<C>(a, nb, B, T, stream);
    if (err != cudaSuccess) return err;
  }

  for (int p = np - 1; p >= 0; --p) {
    auto dh_out = [&](int br) -> const float* { return p == np - 1 ? gs : dh_of(br, p + 1); };
    ConvArgs a;
    WgradArgs w;
    // dt1 = conv2^T(dh') * leaky'(t1)
    clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      a.src[br] = dh_out(br);
      a.w[br] = q.w2t;
      a.K[br] = q.K2;
      a.sgn[br] = u_of(br, p);
      a.dst[br] = dt_of(br);
    }
    err = launch_conv<C>(a, nb, B, T, stream);
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
    err = launch_wgrad<C>(w, nb, B, T, partials, stream);
    if (err != cudaSuccess) return err;
    // dh = dh' + conv1^T(dt1) * leaky'(h)
    clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    for (int br = 0; br < nb; ++br) {
      const Pair& q = pairs[br][p];
      a.src[br] = dt_of(br);
      a.w[br] = q.w1t;
      a.K[br] = q.K1;
      a.dil[br] = q.d;
      a.sgn[br] = h_in(br, p);
      a.res[br] = dh_out(br);
      a.dst[br] = dh_of(br, p);
    }
    err = launch_conv<C>(a, nb, B, T, stream);
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
    err = launch_wgrad<C>(w, nb, B, T, partials, stream);
    if (err != cudaSuccess) return err;
  }

  SumArgs s;
  for (int br = 0; br < nb; ++br) s.src[br] = dh_of(br, 0);
  sum_kernel<<<elementwise_blocks(n), kThreads, 0, stream>>>(s, nb, n, dx);
  return cudaGetLastError();
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
  if (B < 1 || T < 1 || C < 16 || C % 4 != 0 || !table_ok(nb, np, ints)) return -1;
  const size_t n = static_cast<size_t>(B) * T * C;
  return static_cast<long long>(n + static_cast<size_t>(nb) * (2 * np + 2) * n +
                                wgrad_scratch(B, T, C, max_taps(ints, nb, np), nb));
}

// x, g, dx (B, T, C) float32 contiguous, C in {16, 32, 64, 128, 256}.
// ints: per (branch, pair), branch-major, (K1, dilation, K2).  weights: per
// (branch, pair) the device pointers (w1 (K1, C, C), b1 (C,), w2 (K2, C, C),
// b2 (C,), w1t, w2t): w (tap, c_in, c_out) as the forward takes it, and wt
// the same with its channel axes swapped (tap, c_out, c_in).  grads: per
// (branch, pair) the outputs (dw1 (K1, C, C), db1 (C,), dw2 (K2, C, C),
// db2 (C,)), (tap, c_in, c_out).  scratch: `fvt_fused_mrf_bwd_scratch_floats`
// floats.  Every pointer 16-byte aligned.  Returns the first CUDA error of
// the launches (0 = ok).
extern "C" int fvt_fused_mrf_bwd(const float* x, const float* g, float* dx, float* scratch,
                                 int B, int T, int C, int nb, int np, const int* ints,
                                 const float* const* weights, float* const* grads,
                                 void* stream) {
  if (B < 1 || T < 1 || !table_ok(nb, np, ints)) return static_cast<int>(cudaErrorInvalidValue);
  Pair pairs[kMaxBranches][kMaxPairs];
  for (int br = 0; br < nb; ++br) {
    for (int p = 0; p < np; ++p) {
      const int i = br * np + p;
      Pair& q = pairs[br][p];
      q.K1 = ints[3 * i];
      q.d = ints[3 * i + 1];
      q.K2 = ints[3 * i + 2];
      q.w1 = weights[6 * i];
      q.b1 = weights[6 * i + 1];
      q.w2 = weights[6 * i + 2];
      q.b2 = weights[6 * i + 3];
      q.w1t = weights[6 * i + 4];
      q.w2t = weights[6 * i + 5];
      q.dw1 = grads[4 * i];
      q.db1 = grads[4 * i + 1];
      q.dw2 = grads[4 * i + 2];
      q.db2 = grads[4 * i + 3];
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 16: err = run_bwd<16>(x, g, dx, scratch, B, T, nb, np, pairs, s); break;
    case 32: err = run_bwd<32>(x, g, dx, scratch, B, T, nb, np, pairs, s); break;
    case 64: err = run_bwd<64>(x, g, dx, scratch, B, T, nb, np, pairs, s); break;
    case 128: err = run_bwd<128>(x, g, dx, scratch, B, T, nb, np, pairs, s); break;
    case 256: err = run_bwd<256>(x, g, dx, scratch, B, T, nb, np, pairs, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
