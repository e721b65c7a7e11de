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
// twice as much again: 90 C^2 a row.  All of it is dense contraction, so all
// of it runs on the tensor cores in 3xTF32 with float32 accumulation (wgmma,
// mma_common.cuh), at a ceiling of 165 TFLOP/s instead of the CUDA cores'
// 67.
//
// The TPU kernel recomputed the chain's interior in VMEM, left the mirrored
// edges to XLA and carried dW across its sequential grid.  Here:
//   * the chain is recomputed from x into device memory by the forward's
//     stack launch (`resstack_bwd_stack_kernel`, the forward's body), which
//     also stores each stack's activated u; its ordinary output is the next
//     stack's h; the last stack stops after u (2 n - 1 tensors of B T C
//     floats);
//   * then the stacks run last to first, four launches each: the 1x1 conv's
//     adjoint with the leaky mask (-> dt, `resstack_bwd_conv_kernel`); the
//     dilated conv's adjoint with the mask of h, and the skip conv's adjoint
//     as a second product over dh' staged in the same tile (-> dh); the
//     mirrored edges' sums folded back onto the rows they were copied from
//     (`resstack_bwd_fold_kernel`: m rows a side a sequence, masked by h);
//     and the three weight gradients of the stack at once (blockIdx.z,
//     `resstack_bwd_wgrad_kernel`), the dilated conv's staging mirrored rows
//     of leaky(h);
//   * an adjoint reads the kernels as the module holds them (tap, c_in,
//     c_out), a forward conv with its channels swapped: one pack launch
//     writes both forms of every kernel of the chain;
//   * dW and db are summed over rows in two stages: no atomics, the same bits
//     from run to run.
// The mirrored edges need m <= T - 1, as torch's ReflectionPad1d does.
// Scratch, in floats, n_el = B T C: (2 n + 2) n_el (h of stacks 1.., u of
// every stack, dt, two dh used in turn) + the packed kernels (2 (K + 2) C^2
// a stack and form) + the weight gradients' partials.
//
// The bf16 form (`fvt_fused_resstacks_bwd_bf16`, kernel 3b: bf16 x, g,
// weights and biases, as a model trained with compute_dtype bf16 hands
// them) computes what the Pallas body does with bf16 inputs
// (`_chain_bwd_kernel` upcasts x, g and the weights, recomputes the chain
// and its adjoint in float32 and `_run_interior_bwd` casts dx and dW back):
// one launch widens the inputs into float32 scratch (exact), the float32
// passes above run on them unchanged, and one launch rounds dx and every dW
// and db to bf16, once.  Unlike the TPU kernel, which left the mirrored
// edges to XLA's bf16 autograd, it takes the edges in float32 too.  A bf16
// weight is exact in TF32, so the lo half of its split is zero and one of
// the three products of each depth step against a weight adds nothing;
// this form does not skip it (the weight gradients, which contract two
// float32 intermediates, need all three).  Extra scratch: 3 n_el (x, g and
// dx in float32) + twice the weights' floats (their float32 copies and the
// float32 gradients).

#include "bwd_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kMaxStacks = 4;
constexpr float kSlope = 0.2f;  // leaky-relu slope of MelGAN's stacks

static_assert(6 * kMaxStacks <= fvt_mma::kMaxPack, "one pack launch a chain");

FVT_MMA_STACK_KERNEL(resstack_bwd_stack_kernel)
FVT_MMA_CONV_KERNEL(resstack_bwd_conv_kernel)
FVT_MMA_FOLD_KERNEL(resstack_bwd_fold_kernel)
FVT_MMA_WGRAD_KERNEL(resstack_bwd_wgrad_kernel)
FVT_BWD_WIDEN_KERNEL(resstack_bwd_bf16_widen_kernel)
FVT_BWD_NARROW_KERNEL(resstack_bwd_bf16_narrow_kernel)

struct Stack {
  int d;
  const float *wd, *bd, *w1, *b1, *ws, *bs;  // (tap, c_in, c_out) as the module holds them
  float *dwd, *dbd, *dw1, *db1, *dws, *dbs;
};

size_t packed_stack_floats(int C, int K) {
  return static_cast<size_t>(2) * (K + 2) * C * C;
}

// elements of a stack's six weights and biases (wd, bd, w1, b1, ws, bs)
void stack_sizes(int C, int K, long long* n) {
  const long long cc = static_cast<long long>(C) * C;
  const long long sizes[6] = {K * cc, C, cc, C, cc, C};
  for (int i = 0; i < 6; ++i) n[i] = sizes[i];
}

// the float32 scratch the bf16 form needs beyond the float32 form's
size_t bf16_extra_floats(int B, int T, int C, int n, int K) {
  long long sizes[6];
  stack_sizes(C, K, sizes);
  size_t weights = 0;
  for (int i = 0; i < 6; ++i) weights += static_cast<size_t>(sizes[i]);
  return static_cast<size_t>(3) * B * T * C + static_cast<size_t>(2) * n * weights;
}

template <int C>
size_t partial_floats(int B, int T, int K) {
  const int taps[3] = {K, 1, 1};
  return fvt_mma::wgrad_floats<C>(B, T, taps, 3);
}

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
  // every kernel packed twice: [0] as the forward reads it (produced c_out),
  // [1] as the adjoint does (produced c_in); (wd, w1, ws) a stack
  float* packed = scratch + static_cast<size_t>(2 * n + 2) * n_el;
  float* partials = packed + 2 * n * packed_stack_floats(C, K);
  const float* pk[kMaxStacks][2][3];
  {
    fvt_mma::PackArgs pack;
    float* at = packed;
    int i = 0;
    for (int side = 0; side < 2; ++side) {
      for (int s = 0; s < n; ++s) {
        const float* src[3] = {stacks[s].wd, stacks[s].w1, stacks[s].ws};
        const int taps[3] = {K, 1, 1};
        for (int c = 0; c < 3; ++c, ++i) {
          pack.src[i] = src[c];
          pack.dst[i] = at;
          pack.K[i] = taps[c];
          pack.swap[i] = side == 0;
          pk[s][side][c] = at;
          at += fvt_mma::packed_floats<C>(taps[c]);
        }
      }
    }
    const cudaError_t err = fvt_mma::launch_pack<C>(pack, i, stream);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err;

  // recompute: u of every stack, h of every stack but the first
  for (int s = 0; s < n; ++s) {
    const Stack& q = stacks[s];
    fvt_mma::StackArgs a;
    a.src = h_in(s);
    a.dst = s == n - 1 ? nullptr : const_cast<float*>(h_in(s + 1));
    a.u_dst = u_of(s);
    a.wd = pk[s][0][0];
    a.w1 = pk[s][0][1];
    a.ws = pk[s][0][2];
    a.bd = q.bd;
    a.b1 = q.b1;
    a.bs = q.bs;
    a.K = K;
    a.dil = q.d;
    a.slope = kSlope;
    err = FVT_MMA_LAUNCH_STACK(resstack_bwd_stack_kernel, C, a, B, T, stream);
    if (err != cudaSuccess) return err;
  }

  for (int s = n - 1; s >= 0; --s) {
    const Stack& q = stacks[s];
    const float* dh_out = s == n - 1 ? g : dh_of(s + 1);
    float* dh = s == 0 ? dx : dh_of(s);
    fvt_mma::ConvArgs a;
    // dt = dh' W1^T * leaky'(t)
    fvt_mma::clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    a.src[0] = dh_out;
    a.w[0] = pk[s][1][1];
    a.sgn[0] = u_of(s);
    a.dst[0] = dt;
    err = FVT_MMA_LAUNCH_CONV(resstack_bwd_conv_kernel, C, a, 1, B, T, stream);
    if (err != cudaSuccess) return err;
    // dh = conv^T(dt) * leaky'(h) + dh' Ws^T, then the mirrored edges
    fvt_mma::clear(a);
    a.flip = 1;
    a.sgn_slope = kSlope;
    a.src[0] = dt;
    a.w[0] = pk[s][1][0];
    a.K[0] = K;
    a.dil[0] = q.d;
    a.sgn[0] = h_in(s);
    a.src2[0] = dh_out;
    a.w2[0] = pk[s][1][2];
    a.dst[0] = dh;
    err = FVT_MMA_LAUNCH_CONV(resstack_bwd_conv_kernel, C, a, 1, B, T, stream);
    if (err != cudaSuccess) return err;
    a.src2[0] = nullptr;
    err = FVT_MMA_LAUNCH_FOLD(resstack_bwd_fold_kernel, C, a, B, T, stream);
    if (err != cudaSuccess) return err;
    // dWd, dbd; dW1, db1; dWs, dbs
    fvt_bwd::WgradArgs w;
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
    err = FVT_MMA_LAUNCH_WGRAD(resstack_bwd_wgrad_kernel, C, w, 3, B, T, partials, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// the float32 form on float32 operands, laid out as the C entry takes them
cudaError_t run_chain(const float* x, const float* g, float* dx, float* scratch, int B, int T,
                      int C, int n, int K, const int* dil, const float* const* weights,
                      float* const* grads, cudaStream_t st) {
  Stack stacks[kMaxStacks];
  for (int s = 0; s < n; ++s) {
    Stack& q = stacks[s];
    const float* const* w = weights + 6 * s;
    float* const* d = grads + 6 * s;
    q.d = dil[s];
    q.wd = w[0];
    q.bd = w[1];
    q.w1 = w[2];
    q.b1 = w[3];
    q.ws = w[4];
    q.bs = w[5];
    q.dwd = d[0];
    q.dbd = d[1];
    q.dw1 = d[2];
    q.db1 = d[3];
    q.dws = d[4];
    q.dbs = d[5];
  }
  switch (C) {
    case 32: return run_bwd<32>(x, g, dx, scratch, B, T, n, K, stacks, st);
    case 64: return run_bwd<64>(x, g, dx, scratch, B, T, n, K, stacks, st);
    case 128: return run_bwd<128>(x, g, dx, scratch, B, T, n, K, stacks, st);
    default: return run_bwd<256>(x, g, dx, scratch, B, T, n, K, stacks, st);
  }
}

bool chain_ok(int B, int T, int C, int n, int K, const int* dil) {
  if (B < 1 || T < 1 || n < 1 || n > kMaxStacks || K < 1 || K % 2 == 0 ||
      !(C == 32 || C == 64 || C == 128 || C == 256)) {
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
  size_t partials;
  switch (C) {
    case 32: partials = partial_floats<32>(B, T, K); break;
    case 64: partials = partial_floats<64>(B, T, K); break;
    case 128: partials = partial_floats<128>(B, T, K); break;
    default: partials = partial_floats<256>(B, T, K);
  }
  return static_cast<long long>(static_cast<size_t>(2 * n + 2) * n_el +
                                2 * n * packed_stack_floats(C, K) + partials);
}

// floats of scratch `fvt_fused_resstacks_bwd_bf16` needs; -1 as above
extern "C" long long fvt_fused_resstacks_bwd_bf16_scratch_floats(int B, int T, int C, int n,
                                                                 int K, const int* dil) {
  const long long base = fvt_fused_resstacks_bwd_scratch_floats(B, T, C, n, K, dil);
  if (base < 0) return -1;
  return base + static_cast<long long>(bf16_extra_floats(B, T, C, n, K));
}

// x, g, dx (B, T, C) float32 contiguous, C in {32, 64, 128, 256}.  dil: n
// host ints.  weights: 6 n host pointers to device float32 arrays, per stack
// (wd (K, C, C), bd (C,), w1 (1, C, C), b1 (C,), ws (1, C, C), bs (C,)),
// kernels laid out (tap, c_in, c_out).  grads: 6 n host pointers to the
// outputs, per stack (dwd, dbd, dw1, db1, dws, dbs), laid out like the
// weights.  scratch: `fvt_fused_resstacks_bwd_scratch_floats` floats.  Every
// pointer 16-byte aligned.  Returns the first CUDA error of the launches
// (0 = ok).
extern "C" int fvt_fused_resstacks_bwd(const float* x, const float* g, float* dx,
                                       float* scratch, int B, int T, int C, int n, int K,
                                       const int* dil, const float* const* weights,
                                       float* const* grads, void* stream) {
  if (!chain_ok(B, T, C, n, K, dil)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_chain(x, g, dx, scratch, B, T, C, n, K, dil, weights, grads,
                                    static_cast<cudaStream_t>(stream)));
}

// x, g, dx (B, T, C) bf16 contiguous; weights and grads as
// `fvt_fused_resstacks_bwd` takes them, bf16.  scratch:
// `fvt_fused_resstacks_bwd_bf16_scratch_floats` floats.  dx and every dW and
// db are the float32 form's on the widened inputs, rounded to bf16 once.
extern "C" int fvt_fused_resstacks_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                            __nv_bfloat16* dx, float* scratch, int B, int T,
                                            int C, int n, int K, const int* dil,
                                            const __nv_bfloat16* const* weights,
                                            __nv_bfloat16* const* grads, void* stream) {
  if (!chain_ok(B, T, C, n, K, dil)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_el = static_cast<long long>(B) * T * C;
  long long sizes[6];
  stack_sizes(C, K, sizes);
  // float32 x, g, dx, then the weights' copies, then their gradients
  float* x32 = scratch;
  float* g32 = x32 + n_el;
  float* dx32 = g32 + n_el;
  float* at = dx32 + n_el;
  const void* src[2 + 6 * kMaxStacks];
  void* dst[2 + 6 * kMaxStacks];
  long long count[2 + 6 * kMaxStacks];
  const float* w32[6 * kMaxStacks];
  float* d32[6 * kMaxStacks];
  src[0] = x, dst[0] = x32, count[0] = n_el;
  src[1] = g, dst[1] = g32, count[1] = n_el;
  for (int i = 0; i < 6 * n; ++i) {
    src[2 + i] = weights[i], dst[2 + i] = at, count[2 + i] = sizes[i % 6];
    w32[i] = at;
    at += sizes[i % 6];
  }
  for (int i = 0; i < 6 * n; ++i) {
    d32[i] = at;
    at += sizes[i % 6];
  }
  cudaError_t err = fvt_bwd::launch_convert(resstack_bwd_bf16_widen_kernel, src, dst, count,
                                            2 + 6 * n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_chain(x32, g32, dx32, at, B, T, C, n, K, dil, w32, d32, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  src[0] = dx32, dst[0] = dx, count[0] = n_el;
  for (int i = 0; i < 6 * n; ++i) {
    src[1 + i] = d32[i], dst[1 + i] = grads[i], count[1 + i] = sizes[i % 6];
  }
  return static_cast<int>(fvt_bwd::launch_convert(resstack_bwd_bf16_narrow_kernel, src, dst,
                                                  count, 1 + 6 * n, st));
}
