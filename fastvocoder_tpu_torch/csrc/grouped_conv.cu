// Kernel 7: the discriminators' grouped strided 1-D conv, channels last,
// float32 on the CUDA cores: the forward, the input gradient and the weight
// and bias gradients.
//
// Replaces no TPU kernel.  The JAX package runs these convs through XLA
// (fastvocoder_tpu/ops/conv.py::conv1d, lax.conv_general_dilated with
// feature_group_count); on the H100, cuDNN has no fast float32 algorithm for
// them, and its grouped gradient kernels (wgrad_alg1_engine,
// dgrad2d_grouped_direct_kernel) held most of the GAN step's device time.
//
// The convs: x (B, T, Cin) with Cin = 4 G, weight (Cout, 4, K) with
// Cout = N G (N = 16 or 4 outputs a group), stride S, symmetric zero
// padding P, y (B, T_out, Cout), T_out = (T + 2 P - K) / S + 1:
//
//     y[b, t, g N + n] = bias[g N + n] + sum_{c, k} x[b, t S + k - P, 4 g + c] w[g N + n, c, k]
//
// A group's 4 input channels are one float4 a row, so every kernel reads
// and writes the (B, T, C) layout directly.  In the discriminators' layers
// (MSD: K = 41, MFD: K = 25, both S = 4) a group's product is small (16
// outputs, a reduction of 4 K) and each input row feeds about K / S outputs.
//
// Bound: operations on the CUDA cores.  A GAN step runs each of the 18
// layers 4 times forward, 3 times backward to the input and twice to the
// weights: 297 GFLOP, 4.4 ms at 67 TFLOP/s, against about 8 GB of rows
// (2.4 ms at 3.35 TB/s).  Float32 FFMA throughout, each output summed by one
// thread or in a fixed order: float32 accuracy, and two runs give the same
// bits.  What the designs do:
//   * forward: a persistent block (as many as fit at once) stages the
//     weights of kGroups groups once (10.5 KB a group at N = 16, K = 41,
//     laid out [k][c][n]) and, tile after tile of 32 R output rows of one
//     sequence, their input rows with the halo by cp.async, split by phase
//     (row mod S) so that a tap's rows for consecutive outputs are
//     consecutive float4s.  A warp owns a group, a lane R output rows (32
//     apart) x all N outputs: a tap costs R float4 loads of rows and N float4
//     broadcasts of weights for 4 R N FMAs.  R is the least power of two
//     whose tile holds T_out, up to 4 (N = 16) or 8, so that the short late
//     layers (33 rows at the MSD's third scale) compute no empty rows;
//   * input gradient: the same block shape over input rows u S + q (a lane R
//     values of u, every phase q in turn): input row u S + q takes the taps
//     k = (q + P) mod S + S j from output rows u + (q + P) / S - j, so a tap
//     costs R N / 4 float4 loads of upstream gradient and N broadcasts of
//     weights (laid out [k][n][c]) for 4 R N FMAs;
//   * weight gradient: a lane owns 4 outputs x 4 channels x kTapsPerThread
//     taps of one phase of one group (32 lanes: at N = 16, K = 41 the 4 x 8
//     tasks of one group), a warp a slice of a tile's output rows; it slides
//     along the rows keeping the taps' input rows in registers, so a row
//     costs one float4 of input and one of upstream gradient for 96 FMAs.
//     Blocks take tiles of (b, t) rows in turn and write each warp's partial
//     sums to a scratch; a second pass adds the partials in a fixed order
//     (no atomics), the bias gradient with them.
// Grids are sized from the tiles and the groups, so that the short late
// layers (9 x 1024 at the MFD's coarsest) still spread over the SMs.  A tile
// stages and computes only the rows its valid outputs need.
//
// Measured on an H100 at 700 W (bin/kernel_times.py --only disc, the GAN
// cell's 18 layers): a step's 4 forward, 3 input-gradient and 2
// weight-gradient passes summed to 28.2 ms in the first design (one tile a
// block, rows staged by plain loads, R fixed), against 383.5 ms through
// cuDNN; its short layers ran at 3-12 % of their bound.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "cp_async.cuh"
#include "smem_attr.cuh"

namespace {

using fvt_async::cp_async16_zfill;
using fvt_async::cp_async_commit;
using fvt_async::cp_async_wait;

constexpr int kWarp = 32;
constexpr int kGroups = 4;          // forward and input gradient: a warp a group
constexpr int kTapsPerThread = 6;   // weight gradient: taps of one phase a thread
constexpr int kWgradWarps = 4;
constexpr int kSliceRows = 36;      // a weight-gradient warp's rows a tile: a multiple of kTapsPerThread
constexpr int kWgradRows = kWgradWarps * kSliceRows;
constexpr int kReduceThreads = 256;
constexpr int kStageUnroll = 8;     // weight loads a thread keeps in flight while staging

static_assert(kSliceRows % kTapsPerThread == 0, "a slice slides in whole windows");

struct Dims {
  int B, T, Cin, Cout, K, S, P, T_out;
};

// The most rows a lane owns in the forward and the input gradient.
__host__ __device__ constexpr int max_lane_rows(int N) { return N == 16 ? 4 : 8; }

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& w) {
  acc.x = fmaf(s, w.x, acc.x);
  acc.y = fmaf(s, w.y, acc.y);
  acc.z = fmaf(s, w.z, acc.z);
  acc.w = fmaf(s, w.w, acc.w);
}

// Copies the float4 `col4` of row `row` of a (rows, stride) matrix into dst,
// or zeros for a row outside [0, rows); asynchronous (cp.async).
__device__ __forceinline__ void stage_row(float4* dst, const float* base, int row, int rows,
                                          size_t stride, int col4) {
  const bool valid = row >= 0 && row < rows;
  cp_async16_zfill(dst, reinterpret_cast<const float4*>(base + (valid ? row * stride : 0)) + col4,
                   valid);
}

// Stages the weights of groups g0 .. g0 + ng - 1 of w (Cout, 4, K) into ws
// with element (n, c, k) of group g at ws[g * N 4 K + at(n, c, k)], reading
// w in order (coalesced) with kStageUnroll loads in flight a thread.
template <int N, class At>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w, int g0,
                                              int ng, int K, At at) {
  const int wsize = N * 4 * K, total = ng * wsize;
  const float* src = w + static_cast<size_t>(g0) * wsize;
  for (int i0 = threadIdx.x; i0 < total; i0 += blockDim.x * kStageUnroll) {
    float v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < total ? __ldg(src + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) {
        const int k = i % K, c = i / K % 4, n = i / (4 * K) % N, g = i / wsize;
        ws[g * wsize + at(n, c, k)] = v[u];
      }
    }
  }
}

// ---- forward ----------------------------------------------------------------------------

template <int N, int R>
__global__ void __launch_bounds__(kGroups * kWarp)
grouped_conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y, Dims d,
                        int tiles_per_seq) {
  constexpr int kTile = kWarp * R;
  constexpr int NQ = N / 4;
  extern __shared__ float4 smem[];
  const int G = d.Cin / 4;
  const int rows = kTile + cdiv(d.K, d.S);  // staged input rows a phase
  const int g0 = blockIdx.y * kGroups;
  const int ng = min(kGroups, G - g0);
  float4* xs = smem;                                                     // [group][phase][rows]
  float* ws = reinterpret_cast<float*>(smem + kGroups * d.S * rows);    // [group][k][c][n]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  stage_weights<N>(ws, w, g0, ng, d.K, [](int n, int c, int k) { return (k * 4 + c) * N + n; });
  float4 bv[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    bv[q] = bias != nullptr && warp < ng
                ? __ldg(reinterpret_cast<const float4*>(bias + (g0 + warp) * N) + q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int tile = blockIdx.x; tile < d.B * tiles_per_seq; tile += gridDim.x) {
    const int b = tile / tiles_per_seq;
    const int t0 = (tile - b * tiles_per_seq) * kTile;
    const int row0 = t0 * d.S - d.P;
    const int need = (min(kTile, d.T_out - t0) - 1) * d.S + d.K;  // input rows the tile reads
    const float* xb = x + static_cast<size_t>(b) * d.T * d.Cin;
    __syncthreads();  // the weights are staged, the last tile's rows read
    for (int e = threadIdx.x; e < ng * need; e += blockDim.x) {
      const int gl = e % ng, r = e / ng;
      stage_row(xs + (gl * d.S + r % d.S) * rows + r / d.S, xb, row0 + r, d.T, d.Cin, g0 + gl);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp >= ng) continue;
    float4 acc[R][NQ];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[r][q] = bv[q];
    }
    const float4* xg = xs + warp * d.S * rows + lane;
    const float4* wg = reinterpret_cast<const float4*>(ws + warp * d.K * 4 * N);
    for (int p = 0; p < d.S; ++p) {
      for (int k = p, j = 0; k < d.K; k += d.S, ++j) {
        float4 xv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) xv[r] = xg[p * rows + kWarp * r + j];
        const float4* wk = wg + k * 4 * NQ;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 wv = wk[c * NQ + q];
#pragma unroll
            for (int r = 0; r < R; ++r) fma4(acc[r][q], part(xv[r], c), wv);
          }
        }
      }
    }
    float* yb = y + static_cast<size_t>(b) * d.T_out * d.Cout + (g0 + warp) * N;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + lane + kWarp * r;
      if (t < d.T_out) {
        float4* out = reinterpret_cast<float4*>(yb + static_cast<size_t>(t) * d.Cout);
#pragma unroll
        for (int q = 0; q < NQ; ++q) out[q] = acc[r][q];
      }
    }
  }
}

// ---- input gradient ---------------------------------------------------------------------

template <int N, int R>
__global__ void __launch_bounds__(kGroups * kWarp)
grouped_conv_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                          float* __restrict__ dx, Dims d, int tiles_per_seq) {
  constexpr int kTile = kWarp * R;  // values of u a tile: input rows u S .. u S + S - 1
  constexpr int NQ = N / 4;
  extern __shared__ float4 smem[];
  const int G = d.Cin / 4;
  const int J = cdiv(d.K, d.S);
  const int a_min = d.P / d.S;
  const int rows = kTile + J;  // staged upstream rows
  const int g0 = blockIdx.y * kGroups;
  const int ng = min(kGroups, G - g0);
  float4* dys = smem;                          // [group][n / 4][rows]
  float4* ws = smem + kGroups * NQ * rows;     // [group][k][n], a float4 over c
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  stage_weights<N>(reinterpret_cast<float*>(ws), w, g0, ng, d.K,
                   [](int n, int c, int k) { return (k * N + n) * 4 + c; });
  const int u_count = cdiv(d.T, d.S);
  for (int tile = blockIdx.x; tile < d.B * tiles_per_seq; tile += gridDim.x) {
    const int b = tile / tiles_per_seq;
    const int u0 = (tile - b * tiles_per_seq) * kTile;
    // staged row i is upstream row dy0 + i; input row u S + q reads staged
    // rows u - u0 + (q + P) / S - a_min + J - 1 - j for its taps j
    const int dy0 = u0 + a_min - (J - 1);
    const int need = min(kTile, u_count - u0) + J;
    const float* dyb = dy + static_cast<size_t>(b) * d.T_out * d.Cout + g0 * N;
    __syncthreads();
    for (int e = threadIdx.x; e < ng * NQ * need; e += blockDim.x) {
      const int col = e % (ng * NQ), i = e / (ng * NQ);
      stage_row(dys + col * rows + i, dyb, dy0 + i, d.T_out, d.Cout, col);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp >= ng) continue;
    const float4* dg = dys + warp * NQ * rows + lane;
    const float4* wg = ws + warp * d.K * N;
    float* dxb = dx + static_cast<size_t>(b) * d.T * d.Cin + 4 * (g0 + warp);
    for (int q = 0; q < d.S; ++q) {
      const int shift = (q + d.P) / d.S - a_min + J - 1;
      float4 acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = (q + d.P) % d.S, j = 0; k < d.K; k += d.S, ++j) {
        const float4* wk = wg + k * N;
#pragma unroll
        for (int q4 = 0; q4 < NQ; ++q4) {
          float4 dv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) dv[r] = dg[q4 * rows + shift - j + kWarp * r];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float4 wv = wk[4 * q4 + m];
#pragma unroll
            for (int r = 0; r < R; ++r) fma4(acc[r], part(dv[r], m), wv);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = (u0 + lane + kWarp * r) * d.S + q;
        if (row < d.T) *reinterpret_cast<float4*>(dxb + static_cast<size_t>(row) * d.Cin) = acc[r];
      }
    }
  }
}

// ---- weight and bias gradients ----------------------------------------------------------

struct Task {
  int phase, j0, taps;  // taps k = phase + S (j0 + j), j < taps
};

__host__ __device__ inline int tap_sets(int K, int S, int* first_phase_sets) {
  int sets = 0;
  for (int p = 0; p < S && p < K; ++p) {
    const int s = cdiv(cdiv(K - p, S), kTapsPerThread);
    if (p == 0 && first_phase_sets != nullptr) *first_phase_sets = s;
    sets += s;
  }
  return sets;
}

__device__ inline Task task_of(int set, int K, int S) {
  for (int p = 0; p < S && p < K; ++p) {
    const int taps = cdiv(K - p, S);
    const int sets = cdiv(taps, kTapsPerThread);
    if (set < sets) return {p, set * kTapsPerThread, min(kTapsPerThread, taps - set * kTapsPerThread)};
    set -= sets;
  }
  return {0, 0, 0};
}

template <int N>
__global__ void __launch_bounds__(kWgradWarps * kWarp)
grouped_conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ partial, Dims d, int tiles_per_seq,
                          int groups_per_block, int sets, int xrows) {
  constexpr int NQ = N / 4;
  constexpr int JT = kTapsPerThread;
  extern __shared__ float4 smem[];
  const int G = d.Cin / 4;
  const int g0 = blockIdx.y * groups_per_block;
  const int ng = min(groups_per_block, G - g0);
  float4* xs = smem;                                       // [group][phase][xrows]
  float4* dys = smem + groups_per_block * d.S * xrows;     // [group][n / 4][kWgradRows]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int per_group = NQ * sets;
  const int gl = lane / per_group;
  const int q4 = lane % per_group % NQ;
  const int set = lane % per_group / NQ;
  const Task task = task_of(set, d.K, d.S);
  const bool active = gl < ng;
  float acc[JT][4][4];
  float accb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < JT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[j][c][n] = 0.f;
    }
  }
  const int tt0 = warp * kSliceRows;
  for (int tile = blockIdx.x; tile < d.B * tiles_per_seq; tile += gridDim.x) {
    const int b = tile / tiles_per_seq;
    const int t0 = (tile - b * tiles_per_seq) * kWgradRows;
    const int row0 = t0 * d.S - d.P;
    const int valid = min(kWgradRows, d.T_out - t0);
    // rows in whole windows past the last valid one read staged zeros of dy
    const int span = min(kWgradRows, cdiv(valid, JT) * JT);
    const int need = d.S * (span + xrows - kWgradRows);  // the window reads past its taps
    const float* xb = x + static_cast<size_t>(b) * d.T * d.Cin;
    const float* dyb = dy + static_cast<size_t>(b) * d.T_out * d.Cout + g0 * N;
    __syncthreads();
    for (int e = threadIdx.x; e < ng * need; e += blockDim.x) {
      const int g = e % ng, r = e / ng;
      stage_row(xs + (g * d.S + r % d.S) * xrows + r / d.S, xb, row0 + r, d.T, d.Cin, g0 + g);
    }
    for (int e = threadIdx.x; e < ng * NQ * span; e += blockDim.x) {
      const int col = e % (ng * NQ), i = e / (ng * NQ);
      stage_row(dys + col * kWgradRows + i, dyb, t0 + i, d.T_out, d.Cout, col);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active || tt0 >= span) continue;
    // row tt of the tile reads input rows tt + j0 + j of its phase for its taps j
    const float4* xp = xs + (gl * d.S + task.phase) * xrows + task.j0;
    const float4* dp = dys + (gl * NQ + q4) * kWgradRows;
    const int tt1 = min(tt0 + kSliceRows, span);
    float4 win[JT];  // at row tt + s, win[(s + j) % JT] holds input row tt + s + j
#pragma unroll
    for (int j = 0; j < JT - 1; ++j) win[j] = xp[tt0 + j];
    for (int tt = tt0; tt < tt1; tt += JT) {
#pragma unroll
      for (int s = 0; s < JT; ++s) {
        win[(s + JT - 1) % JT] = xp[tt + s + JT - 1];
        const float4 dv = dp[tt + s];
        accb[0] += dv.x;
        accb[1] += dv.y;
        accb[2] += dv.z;
        accb[3] += dv.w;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          const float4 xv = win[(s + j) % JT];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float xc = part(xv, c);
            acc[j][c][0] = fmaf(xc, dv.x, acc[j][c][0]);
            acc[j][c][1] = fmaf(xc, dv.y, acc[j][c][1]);
            acc[j][c][2] = fmaf(xc, dv.z, acc[j][c][2]);
            acc[j][c][3] = fmaf(xc, dv.w, acc[j][c][3]);
          }
        }
      }
    }
  }
  if (!active) return;
  // partial m = (split, warp): [Cout][4][K] weight sums, then [Cout] bias sums
  const size_t E = static_cast<size_t>(d.Cout) * 4 * d.K + d.Cout;
  float* pm = partial + (static_cast<size_t>(blockIdx.x) * kWgradWarps + warp) * E;
  const int o = (g0 + gl) * N + 4 * q4;
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    if (j < task.taps) {
      const int k = task.phase + d.S * (task.j0 + j);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) pm[(static_cast<size_t>(o + n) * 4 + c) * d.K + k] = acc[j][c][n];
      }
    }
  }
  if (set == 0) {
#pragma unroll
    for (int n = 0; n < 4; ++n) pm[static_cast<size_t>(d.Cout) * 4 * d.K + o + n] = accb[n];
  }
}

__global__ void __launch_bounds__(kReduceThreads)
grouped_conv_wgrad_reduce_kernel(const float* __restrict__ partial, int M, int E_w, int E,
                                 float* __restrict__ dw, float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
#pragma unroll 8
  for (int m = 0; m < M; ++m) s += partial[static_cast<size_t>(m) * E + e];
  if (e < E_w) {
    dw[e] = s;
  } else {
    db[e - E_w] = s;
  }
}

// ---- plans and launches -----------------------------------------------------------------

bool valid(const Dims& d) {
  if (d.B < 1 || d.T < 1 || d.Cin < 4 || d.Cin % 4 != 0 || d.K < 1 || d.S < 1 || d.P < 0) {
    return false;
  }
  const int G = d.Cin / 4;
  if (d.Cout % G != 0) return false;
  const int N = d.Cout / G;
  if (N != 4 && N != 16) return false;
  return d.T_out >= 1 && d.T_out == (d.T + 2 * d.P - d.K) / d.S + 1;
}

// Rows a lane owns: the least power of two whose tile of 32 R rows holds
// `rows`, at most max_lane_rows(N).
int lane_rows(int N, int rows) {
  int r = 1;
  while (r < max_lane_rows(N) && kWarp * r < rows) r *= 2;
  return r;
}

// Blocks along x of a persistent grid of `resident` blocks over grid_y rows,
// no more than there are tiles.
int grid_x(int tiles, int grid_y, int resident) {
  return std::max(1, std::min(tiles, cdiv(resident, grid_y)));
}

size_t fwd_smem(const Dims& d, int N, int R) {
  const int rows = kWarp * R + cdiv(d.K, d.S);
  return static_cast<size_t>(kGroups) * (d.S * rows * 16 + d.K * 4 * N * 4);
}

size_t dgrad_smem(const Dims& d, int N, int R) {
  const int rows = kWarp * R + cdiv(d.K, d.S);
  return static_cast<size_t>(kGroups) * (N / 4 * rows * 16 + d.K * N * 16);
}

// Launches a persistent grid of `kernel` over (tiles, groups / kGroups).
template <class Kernel, class... Args>
int launch_persistent(Kernel kernel, size_t smem, int tiles, int grid_y, cudaStream_t st,
                      Args... args) {
  if (smem > static_cast<size_t>(fvt_smem::kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const void* k = reinterpret_cast<const void*>(kernel);
  cudaError_t err = fvt_smem::allow_max_smem(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = fvt_smem::grid_blocks(k, kGroups * kWarp, static_cast<int>(smem), &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x(tiles, grid_y, resident), grid_y), kGroups * kWarp, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int R>
int launch_fwd_rows(const float* x, const float* w, const float* b, float* y, const Dims& d,
               cudaStream_t st) {
  const int tiles_per_seq = cdiv(d.T_out, kWarp * R);
  return launch_persistent(grouped_conv_fwd_kernel<N, R>, fwd_smem(d, N, R), d.B * tiles_per_seq,
                           cdiv(d.Cin / 4, kGroups), st, x, w, b, y, d, tiles_per_seq);
}

template <int N>
int launch_fwd(const float* x, const float* w, const float* b, float* y, const Dims& d,
               cudaStream_t st) {
  switch (lane_rows(N, d.T_out)) {
    case 1: return launch_fwd_rows<N, 1>(x, w, b, y, d, st);
    case 2: return launch_fwd_rows<N, 2>(x, w, b, y, d, st);
    case 4: return launch_fwd_rows<N, 4>(x, w, b, y, d, st);
    default:
      if constexpr (max_lane_rows(N) == 8) return launch_fwd_rows<N, 8>(x, w, b, y, d, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int N, int R>
int launch_dgrad_rows(const float* dy, const float* w, float* dx, const Dims& d, cudaStream_t st) {
  const int tiles_per_seq = cdiv(cdiv(d.T, d.S), kWarp * R);
  return launch_persistent(grouped_conv_dgrad_kernel<N, R>, dgrad_smem(d, N, R),
                           d.B * tiles_per_seq, cdiv(d.Cin / 4, kGroups), st, dy, w, dx, d,
                           tiles_per_seq);
}

template <int N>
int launch_dgrad(const float* dy, const float* w, float* dx, const Dims& d, cudaStream_t st) {
  switch (lane_rows(N, cdiv(d.T, d.S))) {
    case 1: return launch_dgrad_rows<N, 1>(dy, w, dx, d, st);
    case 2: return launch_dgrad_rows<N, 2>(dy, w, dx, d, st);
    case 4: return launch_dgrad_rows<N, 4>(dy, w, dx, d, st);
    default:
      if constexpr (max_lane_rows(N) == 8) return launch_dgrad_rows<N, 8>(dy, w, dx, d, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct WgradPlan {
  int sets, xrows, groups_per_block, grid_y, tiles_per_seq, splits;
  size_t smem, E;
};

template <int N>
cudaError_t wgrad_plan(const Dims& d, WgradPlan* plan) {
  int first = 0;
  plan->sets = tap_sets(d.K, d.S, &first);
  const int per_group = N / 4 * plan->sets;
  if (per_group > kWarp) return cudaErrorInvalidValue;
  plan->xrows = kWgradRows + first * kTapsPerThread;
  plan->groups_per_block = kWarp / per_group;
  plan->grid_y = cdiv(d.Cin / 4, plan->groups_per_block);
  plan->tiles_per_seq = cdiv(d.T_out, kWgradRows);
  plan->smem = static_cast<size_t>(plan->groups_per_block) *
               (d.S * plan->xrows + N / 4 * kWgradRows) * 16;
  plan->E = static_cast<size_t>(d.Cout) * 4 * d.K + d.Cout;
  if (plan->smem > static_cast<size_t>(fvt_smem::kMaxSmem)) return cudaErrorInvalidValue;
  const void* k = reinterpret_cast<const void*>(grouped_conv_wgrad_kernel<N>);
  cudaError_t err = fvt_smem::allow_max_smem(k);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = fvt_smem::grid_blocks(k, kWgradWarps * kWarp, static_cast<int>(plan->smem), &resident);
  if (err != cudaSuccess) return err;
  plan->splits = grid_x(d.B * plan->tiles_per_seq, plan->grid_y, resident);
  return cudaSuccess;
}

template <int N>
int launch_wgrad(const float* x, const float* dy, float* dw, float* db, float* scratch,
                 const Dims& d, cudaStream_t st) {
  WgradPlan plan;
  cudaError_t err = wgrad_plan<N>(d, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_conv_wgrad_kernel<N><<<dim3(plan.splits, plan.grid_y), kWgradWarps * kWarp, plan.smem, st>>>(
      x, dy, scratch, d, plan.tiles_per_seq, plan.groups_per_block, plan.sets, plan.xrows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int E = static_cast<int>(plan.E);
  grouped_conv_wgrad_reduce_kernel<<<cdiv(E, kReduceThreads), kReduceThreads, 0, st>>>(
      scratch, plan.splits * kWgradWarps, d.Cout * 4 * d.K, E, dw, db);
  return static_cast<int>(cudaGetLastError());
}

Dims dims(int B, int T, int Cin, int Cout, int K, int S, int P, int T_out) {
  return Dims{B, T, Cin, Cout, K, S, P, T_out};
}

}  // namespace

// All pointers float32, contiguous, 16-byte aligned, on the current device:
// x (B, T, Cin), w (Cout, 4, K), bias (Cout,) or null, y (B, T_out, Cout);
// Cin = 4 G, Cout = N G with N in {4, 16}, T_out = (T + 2 P - K) / S + 1.
// Each returns the CUDA error of its launches (0 = ok; cudaErrorInvalidValue
// for a geometry the kernels do not take).
extern "C" int fvt_grouped_conv_fwd(const float* x, const float* w, const float* bias, float* y,
                                    int B, int T, int Cin, int Cout, int K, int S, int P,
                                    int T_out, void* stream) {
  const Dims d = dims(B, T, Cin, Cout, K, S, P, T_out);
  if (!valid(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Cout / (Cin / 4)) {
    case 4: return launch_fwd<4>(x, w, bias, y, d, st);
    default: return launch_fwd<16>(x, w, bias, y, d, st);
  }
}

// dy (B, T_out, Cout), w (Cout, 4, K) -> dx (B, T, Cin).
extern "C" int fvt_grouped_conv_dgrad(const float* dy, const float* w, float* dx, int B, int T,
                                      int Cin, int Cout, int K, int S, int P, int T_out,
                                      void* stream) {
  const Dims d = dims(B, T, Cin, Cout, K, S, P, T_out);
  if (!valid(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Cout / (Cin / 4)) {
    case 4: return launch_dgrad<4>(dy, w, dx, d, st);
    default: return launch_dgrad<16>(dy, w, dx, d, st);
  }
}

// Floats of scratch `fvt_grouped_conv_wgrad` takes for these dims on the
// current device (-1 for a geometry it does not take).
extern "C" long long fvt_grouped_conv_wgrad_scratch(int B, int T, int Cin, int Cout, int K, int S,
                                                    int P, int T_out) {
  const Dims d = dims(B, T, Cin, Cout, K, S, P, T_out);
  if (!valid(d)) return -1;
  WgradPlan plan;
  cudaError_t err;
  switch (Cout / (Cin / 4)) {
    case 4: err = wgrad_plan<4>(d, &plan); break;
    default: err = wgrad_plan<16>(d, &plan); break;
  }
  if (err != cudaSuccess) return -1;
  return static_cast<long long>(plan.splits) * kWgradWarps * static_cast<long long>(plan.E);
}

// x (B, T, Cin), dy (B, T_out, Cout) -> dw (Cout, 4, K), db (Cout,), through
// `scratch` of `fvt_grouped_conv_wgrad_scratch` floats.
extern "C" int fvt_grouped_conv_wgrad(const float* x, const float* dy, float* dw, float* db,
                                      float* scratch, int B, int T, int Cin, int Cout, int K,
                                      int S, int P, int T_out, void* stream) {
  const Dims d = dims(B, T, Cin, Cout, K, S, P, T_out);
  if (!valid(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Cout / (Cin / 4)) {
    case 4: return launch_wgrad<4>(x, dy, dw, db, scratch, d, st);
    default: return launch_wgrad<16>(x, dy, dw, db, scratch, d, st);
  }
}
