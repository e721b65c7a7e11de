// Building blocks shared by the two backward kernels of the port: the MRF
// stage's (fused_mrf_bwd.cu) and the residual-stack chain's
// (fused_resstack_bwd.cu).
//
// Both stages are chains of small dense convolutions over x (B, T, C)
// float32, channels last.  Their backward is built from two device passes,
// each written here once and launched per conv by the two libraries:
//
//   * `conv_rows_kernel`: out[r] = sum_k in[r +- (k - half) d] W[k] with an
//     epilogue.  Run forwards it recomputes the stage's intermediates from x
//     (the activated conv outputs u and the inputs h of the later pairs or
//     stacks); run with the transposed weights and the taps reversed it is
//     the conv's adjoint, which carries the cotangent back through a conv.
//     The epilogue applies what stands between two convs: a bias, a
//     leaky-relu, the leaky-relu's derivative taken from the sign of a saved
//     tensor, a second 1x1 product (the stack's skip conv), a residual.  For
//     the chain's mirrored edges the forward stages mirrored rows, and the
//     adjoint adds the sums of the mirrored positions back onto the rows
//     they were copied from (the adjoint of a reflect pad).
//   * `wgrad_kernel` + `wgrad_reduce_kernel`: dW[k] = sum over all B T rows
//     of in[r + (k - half) d]^T dy[r], and db = sum of dy.  A CUDA grid does
//     not run in order, so the sum over rows is taken in two stages: the
//     rows are split over S blocks per tile of dW, each block writes its
//     partial sums to scratch, and a second launch adds the S partials in a
//     fixed order.  No atomics: dW is the same from run to run.
//
// Up to kMaxZ convs of the same width run in one launch (blockIdx.z): the
// branches of an MRF stage, or the three convs of a residual stack.
//
// The contraction runs on the CUDA cores in float32, as in the forward
// kernels: in `conv_rows_kernel` a thread owns 4 output channels of
// kRowsPerThread rows; in `wgrad_kernel` a thread owns a 4 x 4 tile of one
// tap of dW and walks over the rows of its block.

#pragma once

#include <cuda_runtime.h>

namespace fvt_bwd {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kMaxZ = 4;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kTargetBlocks = 528;  // blocks a wgrad launch aims at: 4 per SM
constexpr int kMaxSplits = 1024;

// rows of one pass of all threads at width C (8192 / C)
__host__ __device__ constexpr int pass_rows(int C) {
  return kThreads / (C / 4) * kRowsPerThread;
}

// numpy / torch "reflect" extension of [0, T) to any index
__device__ __forceinline__ int reflect_index(int i, int T) {
  if (T == 1) return 0;
  const int p = 2 * (T - 1);
  i %= p;
  if (i < 0) i += p;
  return i >= T ? p - i : i;
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

__device__ __forceinline__ float4 leaky4(float4 v, float slope) {
  return make_float4(leaky(v.x, slope), leaky(v.y, slope), leaky(v.z, slope),
                     leaky(v.w, slope));
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc[j] += sum_{ci < C} smem[off[j] + ci] * W[ci, col .. col+3], with W
// (C, C) row-major in device memory.
template <int C>
__device__ __forceinline__ void rows_times_weight(float4 (&acc)[kRowsPerThread],
                                                  const float* smem,
                                                  const int (&off)[kRowsPerThread],
                                                  const float* __restrict__ W, int col) {
#pragma unroll 2
  for (int ci = 0; ci < C; ci += 4) {
    const float* wp = W + static_cast<size_t>(ci) * C + col;
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + C));
    const float4 w2 = __ldg(reinterpret_cast<const float4*>(wp + 2 * C));
    const float4 w3 = __ldg(reinterpret_cast<const float4*>(wp + 3 * C));
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(smem + off[j] + ci);
      fma4(acc[j], a.x, w0);
      fma4(acc[j], a.y, w1);
      fma4(acc[j], a.z, w2);
      fma4(acc[j], a.w, w3);
    }
  }
}

// ---------------------------------------------------------------------------
// conv_rows_kernel
// ---------------------------------------------------------------------------

// Up to kMaxZ convs of one launch.  For conv z and every row r in [0, T):
//
//   s      = bias + sum_k in(r + sign (k - half) dil) W[k]
//            (+ the mirrored positions' sums, adjoint of a reflect pad)
//   s      = leaky(s, out_slope)
//   s     *= sgn[r] >= 0 ? 1 : sgn_slope          (where sgn is given)
//   s     += src2[r] W2 + bias2                   (where src2 is given)
//   dst[r] = s + res[r]                           (where res is given)
//
// in(g) = leaky(src[g], in_slope) inside [0, T); outside it is zero, or,
// for a forward conv with `reflect`, the mirrored row.  sign is +1 for a
// forward conv and -1 with `flip`, the adjoint, whose W is the forward
// weight with its two channel axes swapped.  Every W is (taps, C, C):
// contracted channel, then produced channel.
struct ConvArgs {
  const float* src[kMaxZ];
  const float* w[kMaxZ];
  const float* bias[kMaxZ];   // (C,) or null
  const float* sgn[kMaxZ];    // (B, T, C) or null
  const float* src2[kMaxZ];   // (B, T, C) or null
  const float* w2[kMaxZ];     // (C, C), with src2
  const float* bias2[kMaxZ];  // (C,) or null
  const float* res[kMaxZ];    // (B, T, C) or null
  float* dst[kMaxZ];
  int K[kMaxZ];
  int dil[kMaxZ];
  float in_slope;   // 1 = no activation
  float out_slope;  // 1 = no activation
  float sgn_slope;
  int flip;
  int reflect;
};

inline void clear(ConvArgs& a) {
  for (int z = 0; z < kMaxZ; ++z) {
    a.src[z] = a.w[z] = a.bias[z] = a.sgn[z] = a.src2[z] = a.w2[z] = a.bias2[z] = a.res[z] =
        nullptr;
    a.dst[z] = nullptr;
    a.K[z] = 1;
    a.dil[z] = 1;
  }
  a.in_slope = a.out_slope = a.sgn_slope = 1.0f;
  a.flip = a.reflect = 0;
}

// Block x owns rows [x R, x R + R) of sequence blockIdx.y, R = pass_rows(C).
// Shared memory: the staged rows of conv z (R + 2 m rows, m = half dil, and
// one row of zeros), then, at s2_off floats, R rows of src2.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
conv_rows_kernel(ConvArgs a, int T, int s2_off) {
  extern __shared__ __align__(16) float smem[];
  constexpr int C4 = C / 4;
  constexpr int kGroups = kThreads / C4;
  constexpr int R = pass_rows(C);
  const int z = blockIdx.z, b = blockIdx.y;
  const int q0 = blockIdx.x * R;
  const int K = a.K[z], d = a.dil[z];
  const int half = (K - 1) / 2, m = half * d;
  const int w0 = q0 - m, n = R + 2 * m;
  const int sign = a.flip ? -1 : 1;
  const size_t base = static_cast<size_t>(b) * T * C;
  const int col = (threadIdx.x % C4) * 4;
  const int rgroup = threadIdx.x / C4;

  {
    const float* src = a.src[z] + base;
    const bool mirror = a.reflect && !a.flip;
    float4* hs4 = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < n * C4; i += kThreads) {
      int g = w0 + i / C4;
      if (mirror) g = reflect_index(g, T);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T) {
        v = leaky4(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * C) +
                         i % C4),
                   a.in_slope);
      }
      hs4[i] = v;
    }
    for (int i = threadIdx.x; i < C4; i += kThreads) {
      hs4[n * C4 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (a.src2[z] != nullptr) {
      const float* src2 = a.src2[z] + base;
      float4* s4 = reinterpret_cast<float4*>(smem + s2_off);
      for (int i = threadIdx.x; i < R * C4; i += kThreads) {
        const int g = q0 + i / C4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < T) {
          v = __ldg(reinterpret_cast<const float4*>(src2 + static_cast<size_t>(g) * C) + i % C4);
        }
        s4[i] = v;
      }
    }
  }
  __syncthreads();

  float4 acc[kRowsPerThread];
  int off[kRowsPerThread];
  {
    float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.bias[z] != nullptr) bias = __ldg(reinterpret_cast<const float4*>(a.bias[z] + col));
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = bias;
  }
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      off[j] = (rgroup + j * kGroups + m + sign * (k - half) * d) * C;
    }
    rows_times_weight<C>(acc, smem, off, a.w[z] + static_cast<size_t>(k) * C * C, col);
  }

  if (a.reflect && a.flip && m > 0) {
    // Adjoint of the reflect pad by m: padded position -r was a copy of row
    // r (1 <= r <= m), padded position 2 (T-1) - r of row r
    // (T-1-m <= r <= T-2); their sums flow back to row r.  m <= T - 1.
    if (q0 <= m && q0 + R > 1) {
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = q0 + rgroup + j * kGroups;
          const int p = -r - (k - half) * d;
          const bool ok = r >= 1 && r <= m && r < T && p >= 0 && p < T;
          off[j] = (ok ? p - w0 : n) * C;
        }
        rows_times_weight<C>(acc, smem, off, a.w[z] + static_cast<size_t>(k) * C * C, col);
      }
    }
    if (q0 + R > T - 1 - m) {
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = q0 + rgroup + j * kGroups;
          const int p = 2 * (T - 1) - r - (k - half) * d;
          const bool ok = r >= T - 1 - m && r <= T - 2 && p >= 0 && p < T;
          off[j] = (ok ? p - w0 : n) * C;
        }
        rows_times_weight<C>(acc, smem, off, a.w[z] + static_cast<size_t>(k) * C * C, col);
      }
    }
  }

  const bool act = a.out_slope != 1.0f;
  const float* sgn = a.sgn[z];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int g = q0 + rgroup + j * kGroups;
    if (act) acc[j] = leaky4(acc[j], a.out_slope);
    if (sgn != nullptr && g < T) {
      const float4 s =
          __ldg(reinterpret_cast<const float4*>(sgn + base + static_cast<size_t>(g) * C + col));
      acc[j].x *= s.x >= 0.0f ? 1.0f : a.sgn_slope;
      acc[j].y *= s.y >= 0.0f ? 1.0f : a.sgn_slope;
      acc[j].z *= s.z >= 0.0f ? 1.0f : a.sgn_slope;
      acc[j].w *= s.w >= 0.0f ? 1.0f : a.sgn_slope;
    }
  }
  if (a.src2[z] != nullptr) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) off[j] = s2_off + (rgroup + j * kGroups) * C;
    rows_times_weight<C>(acc, smem, off, a.w2[z], col);
    if (a.bias2[z] != nullptr) {
      const float4 bias2 = __ldg(reinterpret_cast<const float4*>(a.bias2[z] + col));
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[j] = add4(acc[j], bias2);
    }
  }
  const float* res = a.res[z];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int g = q0 + rgroup + j * kGroups;
    if (g < T) {
      const size_t at = base + static_cast<size_t>(g) * C + col;
      float4 v = acc[j];
      if (res != nullptr) v = add4(v, __ldg(reinterpret_cast<const float4*>(res + at)));
      *reinterpret_cast<float4*>(a.dst[z] + at) = v;
    }
  }
}

// One launch of nz convs of `a` over (B, T, C).
template <int C>
cudaError_t launch_conv(const ConvArgs& a, int nz, int B, int T, cudaStream_t stream) {
  constexpr int R = pass_rows(C);
  int max_m = 0;
  bool any2 = false;
  for (int z = 0; z < nz; ++z) {
    if (a.K[z] < 1 || a.K[z] % 2 == 0 || a.dil[z] < 1) return cudaErrorInvalidValue;
    const int m = (a.K[z] - 1) / 2 * a.dil[z];
    if (a.reflect && a.flip && m > T - 1) return cudaErrorInvalidValue;
    max_m = max_m > m ? max_m : m;
    any2 = any2 || a.src2[z] != nullptr;
  }
  const int s2_off = (R + 2 * max_m + 1) * C;
  const int smem = static_cast<int>(sizeof(float)) * (s2_off + (any2 ? R * C : 0));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_rows_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B, nz);
  conv_rows_kernel<C><<<grid, kThreads, smem, stream>>>(a, T, s2_off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad_kernel
// ---------------------------------------------------------------------------

// Up to kMaxZ weight gradients of one launch.  For conv z:
//   dW[k][ci][co] = sum_{b, r} in_z(b, r + (k - half) dil)[ci] dy[b][r][co]
//   db[co]        = sum_{b, r} dy[b][r][co]
// with in_z as in ConvArgs (leaky(a, slope), zero or mirrored outside
// [0, T)).  part holds S partial sums of K C C + C floats each (dW, then db).
struct WgradArgs {
  const float* a[kMaxZ];
  const float* dy[kMaxZ];
  float* part[kMaxZ];
  float* dw[kMaxZ];
  float* db[kMaxZ];  // or null
  int K[kMaxZ];
  int dil[kMaxZ];
  int reflect[kMaxZ];
  float slope[kMaxZ];
};

// Thread t of tile blockIdx.x owns the 4 x 4 entries (ci .. ci+3,
// co .. co+3) of tap k, (k, ci, co) decoded from 256 blockIdx.x + t so that
// the lanes of a warp read few distinct shared-memory addresses.  Block
// (x, y) sums over the row chunks y, y + S, y + 2 S, ... (a chunk is RC =
// pass_rows(C) rows of one sequence) and writes partial y.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(WgradArgs w, int B, int T, int max_m) {
  extern __shared__ __align__(16) float smem[];
  constexpr int C4 = C / 4;
  constexpr int RC = pass_rows(C);
  constexpr int CW = C4 < 8 ? C4 : 8;  // co groups side by side in a warp
  constexpr int RW = C4 < 4 ? C4 : 4;  // ci groups side by side in a warp
  const int z = blockIdx.z;
  const int K = w.K[z], d = w.dil[z];
  if (static_cast<int>(blockIdx.x) * kThreads >= K * C4 * C4) return;
  const int half = (K - 1) / 2, m = half * d;

  int gp = blockIdx.x * kThreads + threadIdx.x;
  const bool active = gp < K * C4 * C4;
  if (!active) gp = 0;
  const int co_lo = gp % CW;
  gp /= CW;
  const int ci_lo = gp % RW;
  gp /= RW;
  const int co_hi = gp % (C4 / CW);
  gp /= (C4 / CW);
  const int ci_hi = gp % (C4 / RW);
  const int k = gp / (C4 / RW);
  const int ci = (ci_hi * RW + ci_lo) * 4;
  const int co = (co_hi * CW + co_lo) * 4;
  const bool sums_bias = active && k == 0 && ci == 0;

  float* as = smem;                            // (RC + 2 m) rows
  float* ds = smem + (RC + 2 * max_m) * C;     // RC rows
  const int chunks_per_seq = (T + RC - 1) / RC;
  const int n_chunks = B * chunks_per_seq;
  const float slope = w.slope[z];
  const bool mirror = w.reflect[z] != 0;

  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 bsum = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const int b = c / chunks_per_seq;
    const int r0 = (c % chunks_per_seq) * RC;
    const size_t base = static_cast<size_t>(b) * T * C;
    const int rn = min(RC, T - r0);
    {
      const float* src = w.a[z] + base;
      float4* a4 = reinterpret_cast<float4*>(as);
      for (int i = threadIdx.x; i < (rn + 2 * m) * C4; i += kThreads) {
        int g = r0 - m + i / C4;
        if (mirror) g = reflect_index(g, T);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g >= 0 && g < T) {
          v = leaky4(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * C) +
                           i % C4),
                     slope);
        }
        a4[i] = v;
      }
      const float4* dy = reinterpret_cast<const float4*>(w.dy[z] + base +
                                                         static_cast<size_t>(r0) * C);
      float4* d4 = reinterpret_cast<float4*>(ds);
      for (int i = threadIdx.x; i < rn * C4; i += kThreads) d4[i] = __ldg(dy + i);
    }
    __syncthreads();
    if (active) {
      const float* ap = as + k * d * C + ci;
      const float* dp = ds + co;
#pragma unroll 4
      for (int r = 0; r < rn; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(ap + r * C);
        const float4 dv = *reinterpret_cast<const float4*>(dp + r * C);
        fma4(acc[0], av.x, dv);
        fma4(acc[1], av.y, dv);
        fma4(acc[2], av.z, dv);
        fma4(acc[3], av.w, dv);
        if (sums_bias) bsum = add4(bsum, dv);
      }
    }
    __syncthreads();
  }

  if (active) {
    const size_t nw = static_cast<size_t>(K) * C * C;
    float* part = w.part[z] + static_cast<size_t>(blockIdx.y) * (nw + C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(part + (static_cast<size_t>(k) * C + ci + i) * C + co) = acc[i];
    }
    if (sums_bias) *reinterpret_cast<float4*>(part + nw + co) = bsum;
  }
}

// dw, db = the S partials of each conv added in order.
template <int C>
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(WgradArgs w, int S) {
  const int z = blockIdx.y;
  const int nw = w.K[z] * C * C;
  const int total = nw + C;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += gridDim.x * kThreads) {
    float s = 0.0f;
    for (int p = 0; p < S; ++p) s += w.part[z][static_cast<size_t>(p) * total + i];
    if (i < nw) {
      w.dw[z][i] = s;
    } else if (w.db[z] != nullptr) {
      w.db[z][i - nw] = s;
    }
  }
}

// Row splits of a wgrad launch: enough blocks to fill the card, at most one
// per chunk of rows.
inline int row_splits(int B, int T, int C, int max_K, int nz) {
  const int C4 = C / 4;
  const int tiles = (max_K * C4 * C4 + kThreads - 1) / kThreads;
  const int RC = pass_rows(C);
  const long long chunks = static_cast<long long>(B) * ((T + RC - 1) / RC);
  long long s = (kTargetBlocks + tiles * nz - 1) / (tiles * nz);
  if (s > chunks) s = chunks;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : static_cast<int>(s);
}

// floats of scratch that any wgrad launch of nz convs of at most max_K taps
// needs (fewer taps mean fewer tiles and so more row splits)
inline size_t wgrad_scratch(int B, int T, int C, int max_K, int nz) {
  size_t most = 0;
  for (int K = 1; K <= max_K; K += 2) {
    const size_t need = static_cast<size_t>(nz) * row_splits(B, T, C, K, nz) *
                        (static_cast<size_t>(K) * C * C + C);
    most = most > need ? most : need;
  }
  return most;
}

// The nz weight gradients of `w`; w.part[z] are set here from `scratch`
// (wgrad_scratch floats).
template <int C>
cudaError_t launch_wgrad(WgradArgs& w, int nz, int B, int T, float* scratch,
                         cudaStream_t stream) {
  constexpr int RC = pass_rows(C);
  constexpr int C4 = C / 4;
  int max_m = 0, max_K = 0;
  for (int z = 0; z < nz; ++z) {
    if (w.K[z] < 1 || w.K[z] % 2 == 0 || w.dil[z] < 1) return cudaErrorInvalidValue;
    const int m = (w.K[z] - 1) / 2 * w.dil[z];
    max_m = max_m > m ? max_m : m;
    max_K = max_K > w.K[z] ? max_K : w.K[z];
  }
  const int S = row_splits(B, T, C, max_K, nz);
  for (int z = 0; z < nz; ++z) {
    w.part[z] = scratch + static_cast<size_t>(z) * S * (static_cast<size_t>(max_K) * C * C + C);
  }
  const int smem = static_cast<int>(sizeof(float)) * (2 * RC + 2 * max_m) * C;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (max_K * C4 * C4 + kThreads - 1) / kThreads;
  wgrad_kernel<C><<<dim3(tiles, S, nz), kThreads, smem, stream>>>(w, B, T, max_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = max_K * C * C + C;
  const int blocks = (total + kThreads - 1) / kThreads;
  wgrad_reduce_kernel<C><<<dim3(blocks < 256 ? blocks : 256, nz), kThreads, 0, stream>>>(w, S);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// elementwise passes
// ---------------------------------------------------------------------------

// y = x / f over n floats (n % 4 == 0)
__global__ void __launch_bounds__(kThreads)
divide_kernel(const float* __restrict__ x, float f, size_t n, float* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    reinterpret_cast<float4*>(y)[i] = make_float4(v.x / f, v.y / f, v.z / f, v.w / f);
  }
}

struct SumArgs {
  const float* src[kMaxZ];
};

// y = src[0] + src[1] + ... (nz buffers of n floats, n % 4 == 0)
__global__ void __launch_bounds__(kThreads)
sum_kernel(SumArgs a, int nz, size_t n, float* __restrict__ y) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n / 4;
       i += stride) {
    float4 s = __ldg(reinterpret_cast<const float4*>(a.src[0]) + i);
    for (int z = 1; z < nz; ++z) s = add4(s, __ldg(reinterpret_cast<const float4*>(a.src[z]) + i));
    reinterpret_cast<float4*>(y)[i] = s;
  }
}

inline unsigned elementwise_blocks(size_t n) {
  const size_t blocks = (n / 4 + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1056 ? (blocks < 1 ? 1 : blocks) : 1056);
}

}  // namespace fvt_bwd
