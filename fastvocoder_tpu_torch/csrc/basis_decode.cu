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
// Bound on an H100: bytes, closely followed by operations.  At F = 9360,
// C = 256 it reads 9.6 MB of weights and writes 0.56 MB (3.0 us at 3.35
// TB/s) for 0.14 GFLOP (2.1 us on the CUDA cores).  A batch-1 call leaves
// each SM about 70 frames, so what sets its time is latency: how soon every
// SM has its rows in flight, and how little it waits between them.  Hence:
//   * a persistent grid, as many blocks as fit on the card at once (two an
//     SM at C = 256, 99 KB of shared memory each; `fvt_smem::grid_blocks`), each
//     taking the tiles of kRows frames blockIdx.x, + gridDim.x, ... in turn;
//   * the basis staged once a block, and the weight rows of its tiles
//     streamed through a ring of kStages tiles by cp.async (16-byte copies,
//     zero-filled for the rows f = -1 and f = F), so that the reads of the
//     next kStages - 1 tiles are in flight while one tile is computed;
//   * a register tile: a thread owns kFT frames x kHT samples of one tile
//     over a slice of the channels, so each 16-byte shared load of a weight
//     row feeds 2 kHT dot steps and each of a basis row kFT: 15 loads for
//     160 FMAs, against 7 for 32 in the first version; the kSlices slices
//     of a tile's outputs are summed through shared memory.  A slice owns
//     the 16-byte chunks s, s + kSlices, ... of a row, so the 8 lanes of a
//     load phase read 128 consecutive bytes: no bank conflict;
//   * rows padded to C + 4 floats, 16-byte aligned.
// Measured on an H100 at 700 W (device time, bin/tile_variants.py): 11.5-
// 13.8 us at (1, 9360, 256) and 60-64 us at (32, 2240, 256), against 14.6-
// 14.7 and 76 us for tiles of 32 frames and 8 frames a thread (one block an
// SM), 13.7-13.8 and 67-68 us for those with 32 slices, 14.9-15.0 and 91 us
// for a 4-tile ring.
// Each thread of a block: slice tid % kSlices, frame group tid / kSlices %
// kFrameGroups, sample group tid / (kSlices kFrameGroups); 64 threads a
// sample group, ceil(hop / kHT) groups (192 threads at hop = 15).
//
// The bf16 form (`fvt_basis_decode_bf16`, `basis_decode_wgmma_bf16_kernel`),
// the Pallas kernel's bf16 instantiation: weights and the basis in bf16, the
// products and both sums in float32, the waveform float32.  Its bound is
// bytes too (4.8 MB in at (1, 9360, 256): 1.6 us), but on the CUDA cores
// its 0.14 GFLOP take 2.1 us, and the float32 design run over bf16 rows
// measured 0.0129 ms against float32's 0.0137.  A bf16 x bf16 product is
// exact in float32, so the decode is a GEMM on the tensor cores, (frames x
// C) . (C x L), then the overlap-add:
//   * a tile is 63 output frames f0 .. f0 + 62 of one sequence: its A
//     operand the 64 weight rows f0 - 1 .. f0 + 62 (zeros outside [0, F));
//     a persistent block (one warpgroup, two an SM) stages the basis (L
//     rows, zeros up to N = 16, 32 or 64) once and its tiles through a ring
//     of two, each tile in kGroups cp.async commit groups along the
//     channels, so that the next tile lands while one is computed and a
//     group's products run while the next group lands;
//   * both operands K-major in shared memory, in columns of 8 channels
//     (core matrices of 8 rows x 16 bytes, contiguous; a last column of
//     zeros when C / 8 is odd), one wgmma m64nNk16 a depth step of 16
//     channels, each group's steps summed in the tensor core from zero and
//     the groups' sums added on the CUDA cores;
//   * the overlap-add through shared memory: P (float32), then out[f hop +
//     h] = P[f][h] + P[f - 1][hop + h], written coalesced.
// The checks hold it to the float32 form's summation bound, 4 C eps (|w| .
// |b|).  Four sums of four steps each came closer to float64 than the
// CUDA-core design (1.27e-7 of the peak against 1.75e-7 at (1, 9360, 256));
// one sum over all sixteen did not (2.68e-7).  Measured on an H100 at 700 W
// (PERF.md): 0.0118 ms device at (1, 9360, 256), 0.0409 at (32,
// 2240, 256), against 0.0131 and 0.0627 for the CUDA-core design; without
// its products 0.0104 and 0.0361, without the weight rows' copies 0.0070
// and 0.0191: the copies, not the products, set its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kRows = 16;                    // frames of a tile
constexpr int kFT = 4;                       // frames a thread
constexpr int kHT = 5;                       // samples a thread
constexpr int kSlices = 16;                  // threads over a tile's channels
constexpr int kStages = 3;                   // tiles in the ring
constexpr int kFrameGroups = kRows / kFT;    // 4
constexpr int kGroupThreads = kSlices * kFrameGroups;  // threads of a sample group

using bf16 = __nv_bfloat16;
using fvt_mma::cp_async16_zfill;
using fvt_mma::cp_async_commit;
using fvt_mma::cp_async_wait;

// Shared memory of a float32 block: the basis halves (2 Hp rows, rows h >=
// hop zero) and the ring (kStages tiles of kRows + 1 rows), rows padded by
// 16 bytes, then the partial sums (kSlices x (kRows Hp + 1): an odd stride,
// so the slices of one output fall into different banks); in floats.
struct Layout {
  int hp, sa, basis, ring, partial_stride, bytes;
  __host__ __device__ Layout(int C, int hop) {
    hp = (hop + kHT - 1) / kHT * kHT;
    sa = C + 4;
    basis = 2 * hp * sa;
    ring = kStages * (kRows + 1) * sa;
    partial_stride = kRows * hp + 1;
    bytes = 4 * (basis + ring + kSlices * partial_stride);
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows f0 - 1 .. f0 + kRows - 1 of sequence b into one ring slot, zeros
// outside [0, F); then closes the thread's copy group (empty past the last
// tile, so that the group count stays the same in every block).
__device__ __forceinline__ void load_tile(float* slot, const float* __restrict__ w, int tile,
                                          int n_tiles, int tiles_per_seq, int F, int C, int sa) {
  constexpr int kVec = 4;
  if (tile < n_tiles) {
    const int b = tile / tiles_per_seq, f0 = tile % tiles_per_seq * kRows;
    const int CV = C / kVec;
    for (int i = threadIdx.x; i < (kRows + 1) * CV; i += blockDim.x) {
      const int j = i / CV, cv = i % CV;
      const int f = f0 - 1 + j;
      const bool valid = f >= 0 && f < F;
      const float* src = w + (static_cast<size_t>(b) * F + (valid ? f : 0)) * C + kVec * cv;
      cp_async16_zfill(slot + j * sa + kVec * cv, src, valid);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void decode_body(const float* __restrict__ w,
                                            const float* __restrict__ basis,
                                            float* __restrict__ out, int F, int C, int hop,
                                            int tiles_per_seq, int n_tiles,
                                            unsigned char* smem) {
  constexpr int kVec = 4;
  const Layout lay(C, hop);
  const int sa = lay.sa, hp = lay.hp, C4 = C / 4, CV = C / kVec;
  float* bs = reinterpret_cast<float*>(smem);
  float* ring = bs + lay.basis;
  float* part = reinterpret_cast<float*>(ring + lay.ring);

  // the basis, halves at rows [0, hp) and [hp, 2 hp); it joins tile 0's group
  for (int i = threadIdx.x; i < 2 * hp * CV; i += blockDim.x) {
    const int row = i / CV, cv = i % CV;
    const int half = row / hp, h = row % hp;
    const float* src = basis + static_cast<size_t>(half * hop + (h < hop ? h : 0)) * C + kVec * cv;
    cp_async16_zfill(bs + row * sa + kVec * cv, src, h < hop);
  }
  const int first = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    load_tile(ring + k * (kRows + 1) * sa, w, first + k * step, n_tiles, tiles_per_seq, F, C,
              sa);
  }

  const int s = threadIdx.x % kSlices;
  const int fg = threadIdx.x / kSlices % kFrameGroups;
  const int hg = threadIdx.x / kGroupThreads;
  const float* b_lo = bs + hg * kHT * sa;         // basis[h], h = hg kHT + i
  const float* b_hi = bs + (hp + hg * kHT) * sa;  // basis[hop + h]
  float* my_part = part + s * lay.partial_stride + fg * kFT * hp + hg * kHT;

  for (int k = 0; first + k * step < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k has landed; every thread is done with tile k - 1
    load_tile(ring + (k + kStages - 1) % kStages * (kRows + 1) * sa, w,
              first + (k + kStages - 1) * step, n_tiles, tiles_per_seq, F, C, sa);

    // staged row j holds frame f0 + j - 1: frame fg kFT + i reads rows
    // fg kFT + i + 1 (W[f]) and fg kFT + i (W[f - 1])
    const float* rows = ring + k % kStages * (kRows + 1) * sa + fg * kFT * sa;
    float acc[kFT][kHT];
#pragma unroll
    for (int i = 0; i < kFT; ++i) {
#pragma unroll
      for (int h = 0; h < kHT; ++h) acc[i][h] = 0.0f;
    }
    for (int c4 = s; c4 < C4; c4 += kSlices) {
      float4 r[kFT + 1];
#pragma unroll
      for (int j = 0; j <= kFT; ++j) r[j] = load4(rows + j * sa + 4 * c4);
#pragma unroll
      for (int h = 0; h < kHT; ++h) {
        const float4 p = load4(b_lo + h * sa + 4 * c4);
        const float4 q = load4(b_hi + h * sa + 4 * c4);
#pragma unroll
        for (int i = 0; i < kFT; ++i) acc[i][h] = dot4(r[i], q, dot4(r[i + 1], p, acc[i][h]));
      }
    }
#pragma unroll
    for (int i = 0; i < kFT; ++i) {
#pragma unroll
      for (int h = 0; h < kHT; ++h) my_part[i * hp + h] = acc[i][h];
    }
    __syncthreads();  // every slice's partial sums are in

    const int tile = first + k * step;
    const int b = tile / tiles_per_seq, f0 = tile % tiles_per_seq * kRows;
    float* ob = out + static_cast<size_t>(b) * (F + 1) * hop;
    for (int o = threadIdx.x; o < kRows * hp; o += blockDim.x) {
      const int f = f0 + o / hp, h = o % hp;
      float sum = 0.0f;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) sum += part[sl * lay.partial_stride + o];
      if (h < hop && f <= F) ob[static_cast<size_t>(f) * hop + h] = sum;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

__global__ void __launch_bounds__(kGroupThreads * 4)
basis_decode_kernel(const float* __restrict__ w, const float* __restrict__ basis,
                    float* __restrict__ out, int F, int C, int hop, int tiles_per_seq,
                    int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  decode_body(w, basis, out, F, C, hop, tiles_per_seq, n_tiles, smem);
}

namespace wg {

constexpr int kRowsA = 64;           // rows of an A tile
constexpr int kFrames = kRowsA - 1;  // output frames of a tile
constexpr int kThreads = 128;        // one warpgroup
constexpr int kGroups = 4;           // copy groups of a tile, along the channels

// Shared memory of a block (bf16 elements): two A tiles (kRowsA rows in
// `cols` columns of 8 channels each: the ring), the basis (`cols` columns
// of N rows), then P (float32, kRowsA x (N + 1)).
struct Layout {
  int cols, per_group, rsa, rsb, basis, p, bytes;
  __host__ __device__ Layout(int C, int N) {
    cols = (C / 8 + 1) / 2 * 2;
    per_group = (cols / 2 + kGroups - 1) / kGroups * 2;  // columns of a copy group
    rsa = 8 * kRowsA;
    rsb = 8 * N;
    basis = 2 * cols * rsa;
    p = basis + cols * rsb;
    bytes = 2 * p + 4 * kRowsA * (N + 1);
  }
};

// Rows [0, rows) of a tile in columns [c_lo, c_hi) (of 8 channels, rs
// elements apart): row j is source row g_lo + j of a (n_src, C) matrix,
// zeros outside [0, n_src) and for columns past C / 8.  A warp takes 8 rows
// of 4 neighbouring columns: 64 contiguous bytes a row in, a column's 8
// rows (128 contiguous bytes) out a quarter-warp.  The columns are taken
// from `rot` on, round: blocks that copy the same rows (the basis) ask
// for different lines of it at a time.
__device__ __forceinline__ void stage_cols(bf16* tile, int rs, const bf16* __restrict__ src,
                                           int n_src, int g_lo, int rows, int C, int c_lo,
                                           int c_hi, int rot = 0) {
  const int nc = c_hi - c_lo;
  for (int i = threadIdx.x; i < (rows + 7) / 8 * 8 * nc; i += kThreads) {
    const int row = i / (8 * nc) * 8 + i % 8, cv = c_lo + (i / 8 + rot) % nc;
    if (row >= rows) continue;
    const int g = g_lo + row;
    const bool valid = g >= 0 && g < n_src && cv < C / 8;
    fvt_mma::cp_async16_zfill(tile + cv * rs + 8 * row,
                              src + static_cast<size_t>(valid ? g : 0) * C + 8 * (valid ? cv : 0),
                              valid);
  }
}

// waits until at most n (a constant after unrolling) of the thread's copy
// groups are in flight
__device__ __forceinline__ void wait_groups(int n) {
  static_assert(2 * kGroups <= 8, "a wait for each group of two tiles");
  if (n == 0) fvt_mma::cp_async_wait<0>();
  if (n == 1) fvt_mma::cp_async_wait<1>();
  if (n == 2) fvt_mma::cp_async_wait<2>();
  if (n == 3) fvt_mma::cp_async_wait<3>();
  if (n == 4) fvt_mma::cp_async_wait<4>();
  if (n == 5) fvt_mma::cp_async_wait<5>();
  if (n == 6) fvt_mma::cp_async_wait<6>();
  if (n == 7) fvt_mma::cp_async_wait<7>();
}

// part += the products of depth steps [s0, s1) (columns 2 s, 2 s + 1 of
// both operands), issued and committed without waiting: part's chain runs
// while the next group's rows land.  part enters at zero (a chain of a few
// exact sums from zero, added to the others on the CUDA cores, as float32
// sums of partial dot products).
template <int N>
__device__ __forceinline__ void issue_products(float (&part)[N / 8][4], uint64_t a0, uint64_t b0,
                                               int rsa, int rsb, int s0, int s1) {
  fvt_mma::wgmma_fence();
  for (int s = s0; s < s1; ++s) {
    fvt_mma::WgmmaBf16<N>::run(part, a0 + static_cast<uint64_t>(2 * s * (rsa / 8)),
                               b0 + static_cast<uint64_t>(2 * s * (rsb / 8)));
  }
  fvt_mma::wgmma_commit();
}

// A persistent block: the basis staged once, then its tiles blockIdx.x,
// + gridDim.x, ... in turn, each in kGroups copy groups along the channels
// into the ring's two slots, the next tile landing while one is computed
// and a tile's last channels while its first are.
template <int N>
__global__ void __launch_bounds__(kThreads)
basis_decode_wgmma_bf16_kernel(const bf16* __restrict__ w, const bf16* __restrict__ basis,
                               float* __restrict__ out, int F, int C, int L, int tiles_per_seq,
                               int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(C, N);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* bs = ring + lay.basis;
  float* p = reinterpret_cast<float*>(ring + lay.p);
  const int hop = L / 2;
  // tile t into slot q, its columns [c_lo, c_hi): one commit group, empty past the last tile
  auto stage = [&](int q, int t, int c_lo, int c_hi) {
    if (t < n_tiles) {
      const int b = t / tiles_per_seq, f0 = t % tiles_per_seq * kFrames;
      stage_cols(ring + q * lay.cols * lay.rsa, lay.rsa, w + static_cast<size_t>(b) * F * C, F,
                 f0 - 1, kRowsA, C, c_lo, c_hi);
    }
    fvt_mma::cp_async_commit();
  };
  const int first = blockIdx.x, step = gridDim.x;
  // a tile's kGroups copy groups; the first tile's also bring the basis's
  // columns, rotated by block (blocks that copy the same rows ask for
  // different lines of them at a time)
  auto stage_tile = [&](int q, int t, bool with_basis) {
    for (int g = 0; g < kGroups; ++g) {
      const int c_lo = min(g * lay.per_group, lay.cols), c_hi = min(c_lo + lay.per_group, lay.cols);
      if (with_basis && c_hi > c_lo) {
        stage_cols(bs, lay.rsb, basis, L, 0, N, C, c_lo, c_hi, blockIdx.x % (c_hi - c_lo));
      }
      stage(q, t, c_lo, c_hi);
    }
  };
  stage_tile(0, first, true);
  stage_tile(1, first + step, false);
  const uint64_t b0 = fvt_mma::wgmma_desc(bs, 2 * lay.rsb, 128);
  const int lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int row0 = threadIdx.x / 32 * 16 + gq;  // P rows row0 and row0 + 8 of the lane
  for (int k = 0, tile = first; tile < n_tiles; ++k, tile += step) {
    const int q = k % 2;
    const uint64_t a0 = fvt_mma::wgmma_desc(ring + q * lay.cols * lay.rsa, 2 * lay.rsa, 128);
    float part[kGroups][N / 8][4];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[g][j][e] = 0.0f;
      }
      fvt_mma::fence_regs(part[g]);  // zeroed before the fence, not among the products
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      wait_groups(2 * kGroups - 1 - g);  // group g of the tile (the next tile's may fly)
      fvt_mma::fence_smem_for_wgmma();
      __syncthreads();
      const int c_lo = min(g * lay.per_group, lay.cols);
      issue_products<N>(part[g], a0, b0, lay.rsa, lay.rsb, c_lo / 2,
                        min(c_lo + lay.per_group, lay.cols) / 2);
    }
    fvt_mma::wgmma_wait<0>();
    float acc[N / 8][4];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      fvt_mma::fence_regs(part[g]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = g == 0 ? part[0][j][e] : acc[j][e] + part[g][j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * t;
      p[row0 * (N + 1) + col] = acc[j][0];
      p[row0 * (N + 1) + col + 1] = acc[j][1];
      p[(row0 + 8) * (N + 1) + col] = acc[j][2];
      p[(row0 + 8) * (N + 1) + col + 1] = acc[j][3];
    }
    __syncthreads();  // P is whole; every warp is done with the slot
    stage_tile(q, tile + 2 * step, false);
    // frame f0 + i: row i + 1 (W[f]) on basis[h], row i (W[f - 1]) on basis[hop + h]
    const int b = tile / tiles_per_seq, f0 = tile % tiles_per_seq * kFrames;
    const int frames = min(kFrames, F + 1 - f0);
    float* ob = out + (static_cast<size_t>(b) * (F + 1) + f0) * hop;
    for (int o = threadIdx.x; o < frames * hop; o += kThreads) {
      const int i = o / hop, h = o % hop;
      ob[o] = p[(i + 1) * (N + 1) + h] + p[i * (N + 1) + hop + h];
    }
  }
  fvt_mma::cp_async_wait<0>();  // no copy outlives the block
}

template <int N>
int launch(const bf16* w, const bf16* basis, float* out, int B, int F, int C, int L,
           cudaStream_t stream) {
  const int smem = Layout(C, N).bytes;
  if (smem > fvt_smem::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* k = reinterpret_cast<const void*>(basis_decode_wgmma_bf16_kernel<N>);
  cudaError_t err = fvt_smem::allow_max_smem(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = fvt_smem::grid_blocks(k, kThreads, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_seq = (F + 1 + kFrames - 1) / kFrames;
  const long long n_tiles = static_cast<long long>(B) * tiles_per_seq;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > n_tiles) blocks = static_cast<int>(n_tiles);
  basis_decode_wgmma_bf16_kernel<N><<<blocks, kThreads, smem, stream>>>(
      w, basis, out, F, C, L, tiles_per_seq, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// One launch of basis_decode_kernel.
int launch(const float* w, const float* basis, float* out, int B, int F, int C, int L,
           void* stream) {
  if (B < 1 || F < 1 || C < 4 || C % 4 != 0 || L < 2 || L % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hop = L / 2;
  const int threads = kGroupThreads * ((hop + kHT - 1) / kHT);
  const long long smem = Layout(C, hop).bytes;
  if (threads > kGroupThreads * 4 || smem > fvt_smem::kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* k = reinterpret_cast<const void*>(basis_decode_kernel);
  cudaError_t err = fvt_smem::allow_max_smem(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = fvt_smem::grid_blocks(k, threads, static_cast<int>(smem), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_seq = (F + 1 + kRows - 1) / kRows;
  const long long n_tiles = static_cast<long long>(B) * tiles_per_seq;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > n_tiles) blocks = static_cast<int>(n_tiles);
  basis_decode_kernel<<<blocks, threads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(w, basis, out, F, C, hop,
                                                             tiles_per_seq,
                                                             static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the largest hop (L / 2) either form takes: four sample groups a float32 block
extern "C" int fvt_basis_decode_max_hop() { return 4 * kHT; }

// w (B, F, C), basis (L, C), out (B, (F+1) * L/2); all float32, contiguous,
// 16-byte aligned, on the current device; C a multiple of 4, L even, F >= 1.
// Returns the CUDA error of the launch (0 = ok; cudaErrorInvalidValue for a
// shape whose block does not fit in shared memory).
extern "C" int fvt_basis_decode(const float* w, const float* basis, float* out, int B, int F,
                                int C, int L, void* stream) {
  return launch(w, basis, out, B, F, C, L, stream);
}

// The bf16 form: w (B, F, C) and basis (L, C) bf16, out float32; C a
// multiple of 8; otherwise as `fvt_basis_decode`.
extern "C" int fvt_basis_decode_bf16(const bf16* w, const bf16* basis, float* out, int B, int F,
                                     int C, int L, void* stream) {
  if (B < 1 || F < 1 || C < 8 || C % 8 != 0 || L < 2 || L % 2 != 0 || L / 2 > 4 * kHT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 16) return wg::launch<16>(w, basis, out, B, F, C, L, s);
  if (L <= 32) return wg::launch<32>(w, basis, out, B, F, C, L, s);
  return wg::launch<64>(w, basis, out, B, F, C, L, s);
}
