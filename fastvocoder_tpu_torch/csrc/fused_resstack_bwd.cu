// Backward of one MelGAN-family upsample stage (a chain of ResidualStacks):
// from x and the cotangent g of the chain's output, the cotangent dx and
// the gradient of every weight and bias of every stack, all float32.
//
// Replaces: fastvocoder_tpu/ops/fused_resstack.py::_chain_bwd_kernel
// (driven by `_run_interior_bwd`).
//
// Stack s (dilation d, odd kernel K, margin m = (K-1)/2 d) maps
//     a = leaky(h); t = conv_K,d(reflect_pad(a, m)) + bd; u = leaky(t)
//     h' = conv_1x1(u) + b1 + conv_1x1_skip(h) + bs
// with slope 0.2.  Given dh', its backward is
//     db1 = dbs = sum dh'      dW1 = sum_r u[r]^T dh'[r]
//     dWs = sum_r h[r]^T dh'[r]
//     dt  = dh' W1^T * leaky'(t)   (sign of u)
//     dbd = sum dt             dWd[k] = sum_r a[mirror(r + (k - half) d)]^T dt[r]
//     dh  = reflect_pad^T(conv_K,d^T(dt)) * leaky'(h) + dh' Ws^T
//
// Bound on an H100: operations.  The forward costs 2 n (K + 2) C^2 FLOP a
// row (30 C^2 for 3 stacks at K = 3); the backward recomputes it and does
// twice as much again: 90 C^2 a row.
//
// The TPU kernel recomputed the chain's interior in VMEM, left the mirrored
// edges to XLA and carried dW across its sequential grid.  Here:
//   * the forward kernel's tile already fills 174 KiB of shared memory at
//     C = 256, so the inputs and activations of three stacks do not fit
//     beside it: the chain is recomputed from x into device memory, stack by
//     stack (each stack's input h and activated u: 2 n - 1 tensors of B T C
//     floats);
//   * then the stacks run last to first, three launches each: the 1x1
//     conv's adjoint with the leaky mask (-> dt); the dilated conv's
//     adjoint, which also folds the mirrored rows' sums back onto the rows
//     they were copied from, applies the mask and adds the skip conv's
//     adjoint (-> dh); and the three weight gradients of the stack at once
//     (blockIdx.z), the dilated conv's reading mirrored rows like any
//     other input;
//   * dW and db are summed over rows in two stages: no atomics.
// The mirrored edges need m <= T - 1, as torch's ReflectionPad1d does.
// Scratch, in floats, n_el = B T C: (2 n + 2) n_el (h of stacks 1.., u of
// every stack, dt, two dh used in turn) + the weight gradients' partials.

#include "bwd_common.cuh"

namespace {

using namespace fvt_bwd;

constexpr int kMaxStacks = 4;
constexpr float kSlope = 0.2f;  // leaky-relu slope of MelGAN's stacks

struct Stack {
  int d;
  const float *wd, *bd, *w1, *b1, *ws, *bs, *wdt, *w1t, *wst;
  float *dwd, *dbd, *dw1, *db1, *dws, *dbs;
};

template <int C>
cudaError_t run_bwd(const float* x, const float* g, float* dx, float* scratch, int B, int T,
                    int n, int K, const Stack* stacks, cudaStream_t stream) {
  const size_t n_el = static_cast<size_t>(B) * T * C;
  auto h_in = [&](int s) -> const float* {
    return s == 0 ? x : scratch + static_cast<size_t>(s - 1) * n_el;
  };
  auto u_of = [&](int s) -> float* { return scratch + static_cast<size_t>(n - 1 + s) * n_el; };
  float* dt = scratch + static_cast<size_t>(2 * n - 1) * n_el;
  auto dh_of = [&](int s) -> float* {
    return scratch + static_cast<size_t>(2 * n + s % 2) * n_el;
  };
  float* partials = scratch + static_cast<size_t>(2 * n + 2) * n_el;
  cudaError_t err;

  // recompute: u of every stack, h of every stack but the first
  for (int s = 0; s < n; ++s) {
    const Stack& q = stacks[s];
    ConvArgs a;
    clear(a);
    a.in_slope = kSlope;
    a.out_slope = kSlope;
    a.reflect = 1;
    a.src[0] = h_in(s);
    a.w[0] = q.wd;
    a.bias[0] = q.bd;
    a.K[0] = K;
    a.dil[0] = q.d;
    a.dst[0] = u_of(s);
    err = launch_conv<C>(a, 1, B, T, stream);
    if (err != cudaSuccess) return err;
    if (s == n - 1) break;
    clear(a);
    a.src[0] = u_of(s);
    a.w[0] = q.w1;
    a.bias[0] = q.b1;
    a.src2[0] = h_in(s);
    a.w2[0] = q.ws;
    a.bias2[0] = q.bs;
    a.dst[0] = const_cast<float*>(h_in(s + 1));
    err = launch_conv<C>(a, 1, B, T, stream);
    if (err != cudaSuccess) return err;
  }

  for (int s = n - 1; s >= 0; --s) {
    const Stack& q = stacks[s];
    const float* dh_out = s == n - 1 ? g : dh_of(s + 1);
    ConvArgs a;
    // dt = dh' W1^T * leaky'(t)
    clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    a.src[0] = dh_out;
    a.w[0] = q.w1t;
    a.sgn[0] = u_of(s);
    a.dst[0] = dt;
    err = launch_conv<C>(a, 1, B, T, stream);
    if (err != cudaSuccess) return err;
    // dh = reflect_pad^T(conv^T(dt)) * leaky'(h) + dh' Ws^T
    clear(a);
    a.flip = 1;
    a.reflect = 1;
    a.sgn_slope = kSlope;
    a.src[0] = dt;
    a.w[0] = q.wdt;
    a.K[0] = K;
    a.dil[0] = q.d;
    a.sgn[0] = h_in(s);
    a.src2[0] = dh_out;
    a.w2[0] = q.wst;
    a.dst[0] = s == 0 ? dx : dh_of(s);
    err = launch_conv<C>(a, 1, B, T, stream);
    if (err != cudaSuccess) return err;
    // dWd, dbd; dW1, db1; dWs, dbs
    WgradArgs w;
    w.a[0] = h_in(s);
    w.dy[0] = dt;
    w.dw[0] = q.dwd;
    w.db[0] = q.dbd;
    w.K[0] = K;
    w.dil[0] = q.d;
    w.reflect[0] = 1;
    w.slope[0] = kSlope;
    w.a[1] = u_of(s);
    w.dy[1] = dh_out;
    w.dw[1] = q.dw1;
    w.db[1] = q.db1;
    w.a[2] = h_in(s);
    w.dy[2] = dh_out;
    w.dw[2] = q.dws;
    w.db[2] = q.dbs;
    for (int z = 1; z < 3; ++z) {
      w.K[z] = 1;
      w.dil[z] = 1;
      w.reflect[z] = 0;
      w.slope[z] = 1.0f;
    }
    err = launch_wgrad<C>(w, 3, B, T, partials, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool chain_ok(int B, int T, int C, int n, int K, const int* dil) {
  if (B < 1 || T < 1 || n < 1 || n > kMaxStacks || K < 1 || K % 2 == 0 || C < 32 || C % 4 != 0) {
    return false;
  }
  for (int s = 0; s < n; ++s) {
    if (dil[s] < 1 || (K - 1) / 2 * dil[s] > T - 1) return false;
  }
  return true;
}

}  // namespace

extern "C" int fvt_fused_resstacks_bwd_max_stacks() { return kMaxStacks; }

// floats of scratch `fvt_fused_resstacks_bwd` needs; -1 for a chain it
// refuses (a margin above T - 1 among the reasons)
extern "C" long long fvt_fused_resstacks_bwd_scratch_floats(int B, int T, int C, int n, int K,
                                                            const int* dil) {
  if (!chain_ok(B, T, C, n, K, dil)) return -1;
  const size_t n_el = static_cast<size_t>(B) * T * C;
  return static_cast<long long>(static_cast<size_t>(2 * n + 2) * n_el +
                                wgrad_scratch(B, T, C, K, 3));
}

// x, g, dx (B, T, C) float32 contiguous, C in {32, 64, 128, 256}.  dil: n
// host ints.  weights: 9 n host pointers to device float32 arrays, per stack
// (wd (K, C, C), bd (C,), w1 (C, C), b1 (C,), ws (C, C), bs (C,), wdt, w1t,
// wst): w (tap, c_in, c_out) as the forward takes it, wt the same with its
// channel axes swapped.  grads: 6 n host pointers to the outputs, per stack
// (dwd, dbd, dw1, db1, dws, dbs), laid out like the weights.  scratch:
// `fvt_fused_resstacks_bwd_scratch_floats` floats.  Every pointer 16-byte
// aligned.  Returns the first CUDA error of the launches (0 = ok).
extern "C" int fvt_fused_resstacks_bwd(const float* x, const float* g, float* dx,
                                       float* scratch, int B, int T, int C, int n, int K,
                                       const int* dil, const float* const* weights,
                                       float* const* grads, void* stream) {
  if (!chain_ok(B, T, C, n, K, dil)) return static_cast<int>(cudaErrorInvalidValue);
  Stack stacks[kMaxStacks];
  for (int s = 0; s < n; ++s) {
    Stack& q = stacks[s];
    const float* const* w = weights + 9 * s;
    float* const* d = grads + 6 * s;
    q.d = dil[s];
    q.wd = w[0];
    q.bd = w[1];
    q.w1 = w[2];
    q.b1 = w[3];
    q.ws = w[4];
    q.bs = w[5];
    q.wdt = w[6];
    q.w1t = w[7];
    q.wst = w[8];
    q.dwd = d[0];
    q.dbd = d[1];
    q.dw1 = d[2];
    q.db1 = d[3];
    q.dws = d[4];
    q.dbs = d[5];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 32: err = run_bwd<32>(x, g, dx, scratch, B, T, n, K, stacks, st); break;
    case 64: err = run_bwd<64>(x, g, dx, scratch, B, T, n, K, stacks, st); break;
    case 128: err = run_bwd<128>(x, g, dx, scratch, B, T, n, K, stacks, st); break;
    case 256: err = run_bwd<256>(x, g, dx, scratch, B, T, n, K, stacks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
