// Basis-MelGAN decode: basis weights -> waveform, one launch.
//
// Replaces: fastvocoder_tpu/ops/basis_decode.py::basis_decode_pallas (its
// inner `kernel`), the TPU shift-matmul over zero-shifted copies of the
// weight rows.
//
// Computes, for weights W (B, F, C) and basis (L, C) with hop = L / 2,
//
//     out[b, f*hop + h] = W[b, f] . basis[h] + W[b, f-1] . basis[hop + h]
//
// for f in [0, F] (rows f = -1 and f = F read as zero), i.e. a linear layer
// onto frames of length L followed by a 50 %-overlap-add, written straight
// into the (B, (F+1)*hop) waveform.  No frames tensor is ever stored.
//
// Bound on an H100: bytes.  At F = 9360, C = 256 it reads 9.6 MB of weights
// and writes 0.56 MB, against about 0.14 GFLOP.  The design reads every
// weight row from device memory once per block (the TPU kernel read each
// row twice, once per shifted operand): a block stages kFramesPerBlock + 1
// consecutive rows and the whole basis in shared memory.  What limits it
// next is the shared-memory load rate, so each thread computes one sample
// position h of kFramesPerThread consecutive frames: the rows it loads are
// shared by neighbouring frames (frame f reads rows f and f-1) and the two
// basis rows by all of them, 7 16-byte loads for 32 FMAs.  Rows are padded
// to C + 4 floats: 16-byte aligned, and the 8 threads of a load phase, which
// read 8 different basis rows, hit 8 different bank quads.

#include <cuda_runtime.h>

namespace {

constexpr int kFramesPerThread = 4;
constexpr int kFrameGroups = 16;
constexpr int kFramesPerBlock = kFramesPerThread * kFrameGroups;
constexpr int kThreads = 256;

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads)
basis_decode_kernel(const float* __restrict__ w, const float* __restrict__ basis,
                    float* __restrict__ out, int F, int C, int hop) {
  extern __shared__ __align__(16) float smem[];
  const int stride = C + 4;
  const int C4 = C / 4;
  float* bs = smem;                       // 2*hop rows: basis
  float* ws = smem + 2 * hop * stride;    // rows of frames f0-1 .. f0+kFramesPerBlock-1
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFramesPerBlock;

  const float4* basis4 = reinterpret_cast<const float4*>(basis);
  for (int i = threadIdx.x; i < 2 * hop * C4; i += kThreads) {
    *reinterpret_cast<float4*>(bs + (i / C4) * stride + 4 * (i % C4)) = basis4[i];
  }
  const float4* wb = reinterpret_cast<const float4*>(w + static_cast<size_t>(b) * F * C);
  for (int i = threadIdx.x; i < (kFramesPerBlock + 1) * C4; i += kThreads) {
    const int j = i / C4;
    const int f = f0 - 1 + j;
    *reinterpret_cast<float4*>(ws + j * stride + 4 * (i % C4)) =
        (f >= 0 && f < F) ? wb[static_cast<size_t>(f) * C4 + i % C4]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(b) * (F + 1) * hop;
  for (int task = threadIdx.x; task < hop * kFrameGroups; task += kThreads) {
    const int h = task % hop;
    const int fl0 = (task / hop) * kFramesPerThread;
    if (f0 + fl0 > F) continue;
    const float* b1 = bs + h * stride;
    const float* b2 = bs + (hop + h) * stride;
    const float* rows = ws + fl0 * stride;  // row j: frame f0 + fl0 - 1 + j
    float acc[kFramesPerThread] = {};
    for (int c = 0; c < C; c += 4) {
      const float4 p = *reinterpret_cast<const float4*>(b1 + c);
      const float4 q = *reinterpret_cast<const float4*>(b2 + c);
      float4 r[kFramesPerThread + 1];
#pragma unroll
      for (int j = 0; j <= kFramesPerThread; ++j) {
        r[j] = *reinterpret_cast<const float4*>(rows + j * stride + c);
      }
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) {
        acc[i] = dot4(r[i + 1], p, acc[i]);
        acc[i] = dot4(r[i], q, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFramesPerThread; ++i) {
      const int f = f0 + fl0 + i;
      if (f <= F) ob[static_cast<size_t>(f) * hop + h] = acc[i];
    }
  }
}

}  // namespace

extern "C" int fvt_basis_decode_smem_bytes(int C, int L) {
  return static_cast<int>(sizeof(float)) * (L + kFramesPerBlock + 1) * (C + 4);
}

// w (B, F, C), basis (L, C), out (B, (F+1) * L/2); all float32, contiguous,
// 16-byte aligned, on the current device; C a multiple of 4, L even.
// Returns the CUDA error of the launch (0 = ok).
extern "C" int fvt_basis_decode(const float* w, const float* basis, float* out,
                                int B, int F, int C, int L, void* stream) {
  if (C % 4 != 0 || L % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hop = L / 2;
  const int smem = fvt_basis_decode_smem_bytes(C, L);
  cudaError_t err = cudaFuncSetAttribute(
      basis_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((F + 1 + kFramesPerBlock - 1) / kFramesPerBlock, B);
  basis_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, basis, out, F, C, hop);
  return static_cast<int>(cudaGetLastError());
}
