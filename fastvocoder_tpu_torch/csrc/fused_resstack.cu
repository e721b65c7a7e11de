// One MelGAN-family upsample stage: a chain of ResidualStacks, forward only.
//
// Replaces: fastvocoder_tpu/ops/fused_resstack.py::_chain_kernel (driven by
// `_run_interior_fwd`), forward only.
//
// Each stack s (dilation d, odd kernel K, margin m = (K-1)/2 * d) maps
//
//     t = leaky(h); t = reflect_pad(t, m); t = conv_K,d(t) + bd
//     h' = conv_1x1(leaky(t)) + b1 + conv_1x1_skip(h) + bs
//
// over x (B, T, C) float32, channels last, slope 0.2, any T >= 1 (a pad
// wider than the sequence mirrors again, as numpy's does).  The TPU kernel
// computed only the valid interior and left the sequence edges to XLA,
// because reflect padding does not commute through the fused chain.  Here
// every stack mirrors its own input at the sequence edges as it stages it.
//
// Bound on an H100: operations.  A row costs 2 * n * (K + 2) * C^2 FLOP
// (30 C^2 for 3 stacks at K = 3), about 18 GFLOP for the 9,360-row stage
// at C = 256, against 19 MB of input and output.  So the contraction runs on
// the tensor cores in 3xTF32 (mma_common.cuh: wgmma on split operands,
// float32 accumulation, the kernels packed once and streamed through shared
// memory once a block), which keeps float32 accuracy at a ceiling of 165
// TFLOP/s instead of the CUDA cores' 67.
//
// One launch for the whole chain would stage each block's rows with a halo
// of the margins' sum (13 rows each side): a warpgroup of the tensor cores
// owns 64 rows, where such a halo costs 1.4-2x the work, and the tile, u and
// h' of 90 rows would not fit in shared memory at C = 256.  So the stage
// runs one launch per stack (`fvt_mma::stack_body`): the dilated conv needs
// a halo of m rows, the two 1x1 convs none, so nothing is recomputed; each
// stack reads its input h and writes h' to device memory (two scratch
// buffers used in turn, the last stack writes y): 2 B T C floats of traffic
// a stack, most of which stays in the 50 MB L2 at batch 1.  The kernels are
// packed by a launch of their own (`fvt_fused_resstacks_pack`), which a
// served model runs once.
//
// The bf16 form (`fvt_fused_resstacks_bf16`, `resstack_bf16_kernel`): x, y
// and the scratch in bf16, the kernels packed as bf16 by
// `fvt_fused_resstacks_bf16_pack` from the same float32 operands (in
// wgmma's 128-byte swizzle at C >= 64), biases float32 rounded to bf16 on
// load; rounded to bf16 where fused_resstack.py's Pallas body rounds
// (`fvt_mma::stack_body`).  Bound: the same operations at the 989 TFLOP/s
// bf16 rate, a sixth of the 3xTF32 bound; half the bytes.  Its core
// (`fvt_mma::conv_core_bf16`) lets the tensor core sum a whole conv from
// shared memory, a 32 KB slab of weights at a time with one in flight; at
// C = 256 a grid of 64-row blocks that would run in several waves takes
// 128-row blocks where they run in fewer (`wide_stack_blocks`).

#include "mma_common.cuh"

namespace {

constexpr int kMaxStacks = 4;
constexpr float kSlope = 0.2f;  // leaky-relu slope of MelGAN's stacks

FVT_MMA_STACK_KERNEL(resstack_kernel)
FVT_MMA_BF16_STACK_KERNEL(resstack_bf16_kernel)

using fvt_mma::bf16;

// elements of a stack's packed kernels in the form E
template <typename E>
size_t packed_stack_elems(int C, int K) {
  return static_cast<size_t>(fvt_mma::Form<E>::kHalves) * (K + 2) * C * C;
}

bool chain_ok(int C, int n, int K) {
  return n >= 1 && n <= kMaxStacks && K >= 1 && K % 2 == 1 &&
         (C == 32 || C == 64 || C == 128 || C == 256);
}

template <int C, typename E>
cudaError_t pack_chain(E* packed, int n, int K, const float* const* kernels,
                       cudaStream_t stream) {
  fvt_mma::PackArgsT<E> pack;
  E* at = packed;
  for (int s = 0; s < n; ++s) {
    const int taps[3] = {K, 1, 1};
    for (int c = 0; c < 3; ++c) {
      const int i = 3 * s + c;
      pack.src[i] = kernels[i];
      pack.dst[i] = at;
      pack.K[i] = taps[c];
      pack.swap[i] = 1;  // (tap, c_in, c_out): the forward produces c_out
      at += fvt_mma::packed_elems<C, E>(taps[c]);
    }
  }
  return fvt_mma::launch_pack<C>(pack, 3 * n, stream);
}

// Whether the bf16 form's stacks at C = 256 take 128-row blocks: where the
// grid of 64-row blocks runs in more waves than that of 128-row ones, by
// their times (`fvt_mma::TileBf16StackWide::kCost`).
bool wide_stack_blocks(int B, int T) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 132;  // an H100's; a failing device fails the launch anyway
    }
    return n;
  }();
  const long long narrow = static_cast<long long>(B) * ((T + 63) / 64);
  const long long wide = static_cast<long long>(B) * ((T + 127) / 128);
  return fvt_mma::TileBf16StackWide::kCost * ((wide + sms - 1) / sms) <
         3 * ((narrow + sms - 1) / sms);
}

template <int C, typename E>
cudaError_t run_chain(const E* x, E* y, E* scratch, const E* packed, int B, int T, int n, int K,
                      const int* dil, const float* const* biases, cudaStream_t stream) {
  using Wide = fvt_mma::TileBf16StackWide;
  const size_t n_el = static_cast<size_t>(B) * T * C;
  const bool wide = fvt_mma::is_bf16<E>() && C == 256 && wide_stack_blocks(B, T);
  const E* wd = packed;
  for (int s = 0; s < n; ++s) {
    fvt_mma::StackArgsT<E> a;
    a.src = s == 0 ? x : scratch + static_cast<size_t>((s - 1) % 2) * n_el;
    a.dst = s == n - 1 ? y : scratch + static_cast<size_t>(s % 2) * n_el;
    a.u_dst = nullptr;
    a.wd = wd;
    a.w1 = wd + fvt_mma::packed_elems<C, E>(K);
    a.ws = a.w1 + fvt_mma::packed_elems<C, E>(1);
    a.bd = biases[3 * s];
    a.b1 = biases[3 * s + 1];
    a.bs = biases[3 * s + 2];
    a.K = K;
    a.dil = dil[s];
    a.slope = kSlope;
    cudaError_t err;
    if constexpr (fvt_mma::is_bf16<E>() && C == 256) {
      err = wide ? fvt_mma::launch_stack<C, Wide::kWM, Wide::kST, E, Wide::kSlabBytes>(
                       resstack_bf16_kernel<C, Wide::kWM, Wide::kST, Wide::kSlabBytes>, a, B, T,
                       stream)
                 : FVT_MMA_LAUNCH_BF16_STACK(resstack_bf16_kernel, C, a, B, T, stream);
    } else if constexpr (fvt_mma::is_bf16<E>()) {
      err = FVT_MMA_LAUNCH_BF16_STACK(resstack_bf16_kernel, C, a, B, T, stream);
    } else {
      err = FVT_MMA_LAUNCH_STACK(resstack_kernel, C, a, B, T, stream);
    }
    if (err != cudaSuccess) return err;
    wd += packed_stack_elems<E>(C, K);
  }
  return cudaSuccess;
}

template <typename E>
int pack_any(E* packed, int C, int n, int K, const float* const* kernels, void* stream) {
  if (!chain_ok(C, n, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return static_cast<int>(pack_chain<32>(packed, n, K, kernels, st));
    case 64: return static_cast<int>(pack_chain<64>(packed, n, K, kernels, st));
    case 128: return static_cast<int>(pack_chain<128>(packed, n, K, kernels, st));
    default: return static_cast<int>(pack_chain<256>(packed, n, K, kernels, st));
  }
}

template <typename E>
int run_any(const E* x, E* y, E* scratch, const E* packed, int B, int T, int C, int n, int K,
            const int* dil, const float* const* biases, void* stream) {
  if (B < 1 || T < 1 || !chain_ok(C, n, K)) return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < n; ++s) {
    if (dil[s] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 32: err = run_chain<32>(x, y, scratch, packed, B, T, n, K, dil, biases, st); break;
    case 64: err = run_chain<64>(x, y, scratch, packed, B, T, n, K, dil, biases, st); break;
    case 128: err = run_chain<128>(x, y, scratch, packed, B, T, n, K, dil, biases, st); break;
    default: err = run_chain<256>(x, y, scratch, packed, B, T, n, K, dil, biases, st);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int fvt_fused_resstacks_max_stacks() { return kMaxStacks; }

// floats of the packed kernels of a chain; -1 for a chain it refuses
extern "C" long long fvt_fused_resstacks_packed_floats(int C, int n, int K) {
  if (!chain_ok(C, n, K)) return -1;
  return static_cast<long long>(n * packed_stack_elems<float>(C, K));
}

// packed (`fvt_fused_resstacks_packed_floats` floats) = the chain's kernels
// split into TF32 halves in the order the tensor cores read them.  kernels:
// 3 n device pointers, per stack (wd (K, C, C), w1 (1, C, C), ws (1, C, C)),
// laid out (tap, c_in, c_out), each 16-byte aligned.  Returns the CUDA
// error of the launch (0 = ok).
extern "C" int fvt_fused_resstacks_pack(float* packed, int C, int n, int K,
                                        const float* const* kernels, void* stream) {
  return pack_any(packed, C, n, K, kernels, stream);
}

// floats of scratch `fvt_fused_resstacks` needs: the stacks' outputs but
// the last, two buffers used in turn (elements, in the bf16 form)
extern "C" long long fvt_fused_resstacks_scratch_floats(int B, int T, int C, int n) {
  return static_cast<long long>(n < 3 ? n - 1 : 2) * B * T * C;
}

// x, y (B, T, C) float32 contiguous; C in {32, 64, 128, 256}.  scratch:
// `fvt_fused_resstacks_scratch_floats` floats; packed: the chain's kernels
// as `fvt_fused_resstacks_pack` wrote them.  dil: n host ints.  biases: 3 n
// host pointers to device float32 arrays, per stack (bd, b1, bs), each (C,)
// and 16-byte aligned.  Returns the first CUDA error of the launches
// (0 = ok).
extern "C" int fvt_fused_resstacks(const float* x, float* y, float* scratch, const float* packed,
                                   int B, int T, int C, int n, int K, const int* dil,
                                   const float* const* biases, void* stream) {
  return run_any(x, y, scratch, packed, B, T, C, n, K, dil, biases, stream);
}

// The bf16 form.  Elements (bf16) of the packed kernels of a chain; -1 for
// a chain it refuses.
extern "C" long long fvt_fused_resstacks_bf16_packed_elems(int C, int n, int K) {
  if (!chain_ok(C, n, K)) return -1;
  return static_cast<long long>(n * packed_stack_elems<bf16>(C, K));
}

// packed (`fvt_fused_resstacks_bf16_packed_elems` bf16) = the chain's
// float32 kernels, as `fvt_fused_resstacks_pack` takes them, rounded to
// bf16 in the order the tensor cores read them.
extern "C" int fvt_fused_resstacks_bf16_pack(bf16* packed, int C, int n, int K,
                                             const float* const* kernels, void* stream) {
  return pack_any(packed, C, n, K, kernels, stream);
}

// x, y (B, T, C) and scratch (`fvt_fused_resstacks_scratch_floats`
// elements) bf16, contiguous, 16-byte aligned; packed as
// `fvt_fused_resstacks_bf16_pack` wrote it; dil and biases (float32) as
// `fvt_fused_resstacks` takes them.  Returns the first CUDA error of the
// launches (0 = ok).
extern "C" int fvt_fused_resstacks_bf16(const bf16* x, bf16* y, bf16* scratch,
                                        const bf16* packed, int B, int T, int C, int n, int K,
                                        const int* dil, const float* const* biases,
                                        void* stream) {
  return run_any(x, y, scratch, packed, B, T, C, n, K, dil, biases, stream);
}
