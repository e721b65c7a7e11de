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
//     (-> dh), dW1 and db1.  An adjoint is `fvt_mma::conv_mma_kernel` with the
//     taps walked backwards and the forward's own weight layout (the
//     produced channel of an adjoint is the forward's input channel); dt1
//     crosses device memory once per pair;
//   * a weight gradient is a split-K GEMM, dW[k] = in_k^T dy with M = c_in,
//     N = c_out and the B T rows as depth (`wgrad_mma_kernel`), on wgmma: a
//     block stages a chunk of rows of `in` row-major (rows padded to C + 8
//     floats, so that the transposed A fragment, read into registers, meets
//     32 different banks) and of dy transposed and split into TF32 halves,
//     as the K-major B operand; each warpgroup owns the accumulators of one
//     64-row group of dW (several taps x c_in below C = 64, so that no
//     thread idles) across all the block's chunks.  Where a conv has fewer
//     groups than a block has warpgroups they share one and split each
//     chunk's rows, and add their sums through shared memory in a fixed
//     order.  The sum over blocks is taken in two stages (partials per
//     block, then `wgrad_reduce_kernel` in a fixed order): no atomics, the
//     same bits from run to run.  db rides along in the blocks that hold a
//     conv's first groups.
// Scratch, in floats, n = B T C: n (g / n_branches) + per branch
// (2 np + 2) n (h of pairs 1.., u of every pair, dt1, two dh used in turn)
// + the kernels packed for the tensor cores, as the forward convs and as the
// adjoints read them + the weight gradients' partials.

#include "bwd_common.cuh"
#include "mma_common.cuh"

namespace {

using fvt_bwd::divide_kernel;
using fvt_bwd::elementwise_blocks;
using fvt_bwd::kMaxSplits;
using fvt_bwd::kTargetBlocks;
using fvt_bwd::kThreads;
using fvt_bwd::sum_kernel;
using fvt_bwd::SumArgs;
using fvt_bwd::WgradArgs;
using fvt_mma::kMaxZ;

constexpr int kMaxBranches = kMaxZ;
constexpr int kMaxPairs = 8;
constexpr float kSlope = 0.1f;  // leaky-relu slope of HiFiGAN's resblocks
constexpr int kWarps = kThreads / 32;

static_assert(fvt_bwd::kMaxZ == kMaxZ, "one launch holds every branch in both headers");
static_assert(2 * kMaxBranches * kMaxPairs <= fvt_mma::kMaxPack, "one pack launch a side");

FVT_MMA_PAIR_KERNEL(mrf_bwd_pair_kernel)

// ---------------------------------------------------------------------------
// the weight gradient on the tensor cores
// ---------------------------------------------------------------------------

// A warpgroup's group of dW: 64 rows (kTaps taps x C input channels below
// C = 64, 64 input channels of one tap from there) x kNW output channels.
// kRows rows a chunk.
template <int C>
struct WGeo {
  static constexpr int kNW = C < 128 ? C : 128;
  static constexpr int kGroupsN = C / kNW;
  static constexpr int kNT = kNW / 8;
  static constexpr int kTaps = C >= 64 ? 1 : 64 / C;
  static constexpr int kBlocksM = C >= 64 ? C / 64 : 1;
  static constexpr int kGroupsPerTapGroup = kBlocksM * kGroupsN;
  static constexpr int kAcc = kNT * 4;  // accumulators a thread
  static constexpr int kRows = C <= 16 ? 256 : (C <= 32 ? 128 : (C <= 64 ? 64 : 32));
  static constexpr int kS = C + 8;  // floats a staged row of `in`
  // dy is staged as the K-major B operand: hi and lo halves of core matrices
  // [kRows / 4][C / 8][8 channels][4 rows], kCore floats apart (32 and 4 of
  // padding, so that the staging's 16-byte stores fall into different banks)
  static constexpr int kCore = 36;
  static constexpr int kDyHalf = kRows / 4 * (C / 8) * kCore;
  static constexpr uint32_t kStrideK = C / 8 * kCore * 4;  // bytes, along the rows
  static constexpr uint32_t kStrideN = kCore * 4;          // bytes, along the channels
};

constexpr int kGroupsPerBlock = kWarps / 4;  // warpgroups of a block

template <int C>
__host__ __device__ inline int wgrad_groups(int K) {
  return (K + WGeo<C>::kTaps - 1) / WGeo<C>::kTaps * WGeo<C>::kGroupsPerTapGroup;
}

// For conv z of `w` (bwd_common.cuh: dW[k][ci][co] = sum in_z(r + (k - half)
// dil)[ci] dy[r][co], db = sum dy, zero padding): block (x, y) holds the
// groups [2 x, 2 x + 2) of dW, sums over the row chunks y, y + S, ... and
// writes partial y.  The product is in^T dy on wgmma: A = in^T from
// registers (a lane reads its (channel, row) elements from the row-major
// staged tile), B = dy from shared memory, split into TF32 halves when it is
// staged; the products of 32 rows are summed in the tensor core from zero and
// added to the accumulators on the CUDA cores (fvt_mma::conv_core).
template <int C>
__global__ void __launch_bounds__(kThreads)
wgrad_mma_kernel(WgradArgs w, int B, int T, int max_m) {
  extern __shared__ __align__(16) float smem[];
  using G = WGeo<C>;
  constexpr int C4 = C / 4;
  constexpr int RC = G::kRows;
  const int z = gridDim.z - 1 - blockIdx.z;  // the longest blocks first (fvt_mma::launch_pair)
  const int K = w.K[z], d = w.dil[z];
  const int groups = wgrad_groups<C>(K);
  const int g_first = blockIdx.x * kGroupsPerBlock;
  if (g_first >= groups) return;
  const int half_k = (K - 1) / 2;
  const int here = min(kGroupsPerBlock, groups - g_first);  // groups of this block
  const int splits = kGroupsPerBlock / here;                // warpgroups sharing a group
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4, w4 = warp % 4;
  const int split = wg / here;
  const int group = g_first + wg % here;
  const int k_first = group / G::kGroupsPerTapGroup * G::kTaps;
  const int m_block = group % G::kGroupsPerTapGroup / G::kGroupsN;
  const int n0 = group % G::kGroupsN * G::kNW;
  // the lane's rows of dW: m = 16 w4 + g and m + 8, (tap, channel) = (m / C, m % C)
  const int tap_l = C >= 64 ? 0 : 16 * w4 / C;
  const int ci0 = (C >= 64 ? m_block * 64 + 16 * w4 : 16 * w4 % C) + g;
  // the taps the block's groups reach, and the rows of `in` they read
  const int k_lo = g_first / G::kGroupsPerTapGroup * G::kTaps;
  const int k_hi = min(K, (g_first + here - 1) / G::kGroupsPerTapGroup * G::kTaps + G::kTaps) - 1;
  const int lo = (k_lo - half_k) * d, span = (k_hi - k_lo) * d;
  const int k_mine = min(k_first + tap_l, K - 1);

  float* as = smem;                              // RC + span rows of `in`
  float* dyh = smem + (RC + 2 * max_m) * G::kS;  // dy's hi half, then its lo half
  const int chunks_per_seq = (T + RC - 1) / RC;
  const int n_chunks = B * chunks_per_seq;
  const float slope = w.slope[z];
  const bool sums_bias = blockIdx.x == 0;

  float acc[G::kNT][4];
#pragma unroll
  for (int j = 0; j < G::kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float4 bsum = make_float4(0.f, 0.f, 0.f, 0.f);  // of channels 4 (tid % C4) ..

  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const int b = c / chunks_per_seq;
    const int r0 = (c % chunks_per_seq) * RC;
    const size_t base = static_cast<size_t>(b) * T * C;
    const int rn = min(RC, T - r0);
    {
      const float* src = w.a[z] + base;
      for (int i = threadIdx.x; i < (RC + span) * C4; i += kThreads) {
        const int row = i / C4, c4 = i % C4;
        const int gr = r0 + lo + row;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr >= 0 && gr < T) {
          v = fvt_mma::leaky4(
              __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(gr) * C) + c4),
              slope);
        }
        *reinterpret_cast<float4*>(as + row * G::kS + 4 * c4) = v;
      }
      // dy: a thread takes 4 rows of 4 channels and stores, per channel, the
      // 4 rows side by side: the transpose the K-major operand wants
      const float* dy = w.dy[z] + base + static_cast<size_t>(r0) * C;
      for (int i = threadIdx.x; i < RC / 4 * C4; i += kThreads) {
        const int rq = i / C4, c4 = i % C4;
        float v[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (4 * rq + r < rn) {
            x = __ldg(reinterpret_cast<const float4*>(dy + static_cast<size_t>(4 * rq + r) * C) + c4);
          }
          v[r][0] = x.x, v[r][1] = x.y, v[r][2] = x.z, v[r][3] = x.w;
          if (sums_bias) bsum = make_float4(bsum.x + x.x, bsum.y + x.y, bsum.z + x.z, bsum.w + x.w);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = 4 * c4 + e;
          uint32_t hi[4], lo4[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) fvt_mma::split_tf32(v[r][e], hi[r], lo4[r]);
          float* at = dyh + (rq * (C / 8) + co / 8) * G::kCore + co % 8 * 4;
          *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(at + G::kDyHalf) = make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
        }
      }
    }
    fvt_mma::fence_smem_for_wgmma();
    __syncthreads();
    // batch q covers rows 32 q .. 32 q + 31 of the chunk: 4 depth steps
    for (int q = split; q * 32 < rn; q += splits) {
      uint32_t a_hi[4][4], a_lo[4][4];
      // tap k reads `in` row r + (k - half) d: staged row r + (k - k_lo) d
      const float* ap = as + (q * 32 + t + (k_mine - k_lo) * d) * G::kS + ci0;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        fvt_mma::split_tf32(ap[ks * 8 * G::kS], a_hi[ks][0], a_lo[ks][0]);
        fvt_mma::split_tf32(ap[ks * 8 * G::kS + 8], a_hi[ks][1], a_lo[ks][1]);
        fvt_mma::split_tf32(ap[(ks * 8 + 4) * G::kS], a_hi[ks][2], a_lo[ks][2]);
        fvt_mma::split_tf32(ap[(ks * 8 + 4) * G::kS + 8], a_hi[ks][3], a_lo[ks][3]);
      }
      float p[G::kNT][4];
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      fvt_mma::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float* hi = dyh + ((q * 8 + 2 * ks) * (C / 8) + n0 / 8) * G::kCore;
        const uint64_t d_hi = fvt_mma::wgmma_desc(hi, G::kStrideK, G::kStrideN);
        const uint64_t d_lo = fvt_mma::wgmma_desc(hi + G::kDyHalf, G::kStrideK, G::kStrideN);
        fvt_mma::Wgmma<G::kNW>::run(p, a_lo[ks], d_hi, ks > 0);
        fvt_mma::Wgmma<G::kNW>::run(p, a_hi[ks], d_lo, 1);
        fvt_mma::Wgmma<G::kNW>::run(p, a_hi[ks], d_hi, 1);
      }
      fvt_mma::wgmma_commit();
      fvt_mma::wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
      }
    }
    __syncthreads();
  }

  // the warpgroups that shared a group add their sums in the order of their split
  float* red = smem;
  const int in_group = threadIdx.x % 128;
  for (int s = 1; s < splits; ++s) {
    if (split == s) {
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(j * 4 + e) * 128 + in_group] = acc[j][e];
      }
    }
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += red[(j * 4 + e) * 128 + in_group];
      }
    }
    __syncthreads();
  }

  const size_t nw = static_cast<size_t>(K) * C * C;
  float* part = w.part[z] + static_cast<size_t>(blockIdx.y) * (nw + C);
  if (split == 0 && k_first + tap_l < K) {
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      float* at = part + (static_cast<size_t>(k_first + tap_l) * C + ci0) * C + n0 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(at) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(at + 8 * C) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  if (sums_bias) {
    // thread t summed channels 4 (t % C4) ..: kThreads / C4 threads a channel
    *reinterpret_cast<float4*>(red + 4 * threadIdx.x) = bsum;
    __syncthreads();
    if (threadIdx.x < C) {
      const int c4 = threadIdx.x / 4, e = threadIdx.x % 4;
      float s = 0.0f;
      for (int i = c4; i < kThreads; i += C4) s += red[4 * i + e];
      part[nw + threadIdx.x] = s;
    }
  }
}

// Launch geometry of the weight gradients of one stage: the row splits S
// (enough blocks to fill the card, at most one per chunk of rows).
template <int C>
int wgrad_splits(int B, int T, const int* K, int nz) {
  int blocks = 0;
  for (int z = 0; z < nz; ++z) {
    blocks += (wgrad_groups<C>(K[z]) + kGroupsPerBlock - 1) / kGroupsPerBlock;
  }
  const long long chunks =
      static_cast<long long>(B) * ((T + WGeo<C>::kRows - 1) / WGeo<C>::kRows);
  long long s = (kTargetBlocks + blocks - 1) / blocks;
  if (s > chunks) s = chunks;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : static_cast<int>(s);
}

inline int max_of(const int* v, int n) {
  int m = v[0];
  for (int i = 1; i < n; ++i) m = m > v[i] ? m : v[i];
  return m;
}

// floats of partials one launch of nz weight gradients needs
template <int C>
size_t wgrad_floats(int B, int T, const int* K, int nz) {
  return static_cast<size_t>(nz) * wgrad_splits<C>(B, T, K, nz) *
         (static_cast<size_t>(max_of(K, nz)) * C * C + C);
}

// The nz weight gradients of `w`; w.part[z] are set here from `scratch`.
template <int C>
cudaError_t launch_wgrad_mma(WgradArgs& w, int nz, int B, int T, float* scratch,
                         cudaStream_t stream) {
  using G = WGeo<C>;
  int max_m = 0, max_x = 0;
  for (int z = 0; z < nz; ++z) {
    if (w.K[z] < 1 || w.K[z] % 2 == 0 || w.dil[z] < 1) return cudaErrorInvalidValue;
    const int m = (w.K[z] - 1) / 2 * w.dil[z];
    const int x = (wgrad_groups<C>(w.K[z]) + kGroupsPerBlock - 1) / kGroupsPerBlock;
    max_m = max_m > m ? max_m : m;
    max_x = max_x > x ? max_x : x;
  }
  const int max_K = max_of(w.K, nz);
  const int S = wgrad_splits<C>(B, T, w.K, nz);
  for (int z = 0; z < nz; ++z) {
    w.part[z] = scratch + static_cast<size_t>(z) * S * (static_cast<size_t>(max_K) * C * C + C);
  }
  // staging, reused for the sums the warpgroups of a group exchange
  int floats = (G::kRows + 2 * max_m) * G::kS + 2 * G::kDyHalf;
  const int exchange = 128 * G::kAcc > 4 * kThreads ? 128 * G::kAcc : 4 * kThreads;
  floats = floats > exchange ? floats : exchange;
  const int smem = static_cast<int>(sizeof(float)) * floats;
  if (smem > fvt_mma::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wgrad_mma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wgrad_mma_kernel<C><<<dim3(max_x, S, nz), kThreads, smem, stream>>>(w, B, T, max_m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = max_K * C * C + C;
  const int blocks = (total + kThreads - 1) / kThreads;
  fvt_bwd::wgrad_reduce_kernel<C><<<dim3(blocks < 256 ? blocks : 256, nz), kThreads, 0, stream>>>(
      w, S);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the stage
// ---------------------------------------------------------------------------

struct Pair {
  int K1, d, K2;
  // w (tap, c_in, c_out) as the module holds it, wt (tap, c_out, c_in)
  const float *w1, *b1, *w2, *b2, *w1t, *w2t;
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
      const size_t need = wgrad_floats<C>(B, T, K, nb);
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
  // conv2 as the forward reads them ([0], from wt), then as the adjoints do
  // ([1], from w)
  const float* pk[2][kMaxBranches][kMaxPairs][2];
  for (int side = 0; side < 2; ++side) {
    fvt_mma::PackArgs pack;
    int i = 0;
    for (int br = 0; br < nb; ++br) {
      for (int p = 0; p < np; ++p) {
        const Pair& q = pairs[br][p];
        const float* src[2] = {side == 0 ? q.w1t : q.w1, side == 0 ? q.w2t : q.w2};
        const int K[2] = {q.K1, q.K2};
        for (int c = 0; c < 2; ++c, ++i) {
          pack.src[i] = src[c];
          pack.dst[i] = packed;
          pack.K[i] = K[c];
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
    err = fvt_mma::launch_conv<C>(a, nb, B, T, stream);
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
    err = launch_wgrad_mma<C>(w, nb, B, T, partials, stream);
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
    err = fvt_mma::launch_conv<C>(a, nb, B, T, stream);
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
    err = launch_wgrad_mma<C>(w, nb, B, T, partials, stream);
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
// b2 (C,), w1t, w2t): w (tap, c_in, c_out) as the module holds it, and wt
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
