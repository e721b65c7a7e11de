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
//     SM at C = 256, 99 KB of shared memory each; `grid_blocks`), each
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
// The bf16 form (`fvt_basis_decode_bf16`, `basis_decode_bf16_kernel`), the
// Pallas kernel's bf16 instantiation: weights and the basis in bf16, the
// products and both sums in float32, the waveform float32.  The same grid,
// ring and register tile over bf16 rows (padded to C + 8): half the bytes
// in, so its bound (bytes) falls by nearly half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

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

// Shared memory of a block: the basis halves (2 Hp rows, rows h >= hop
// zero) and the ring (kStages tiles of kRows + 1 rows), in elements of the
// input's type (rows padded by 16 bytes), then the partial sums in floats
// (kSlices x (kRows Hp + 1): an odd stride, so the slices of one output fall
// into different banks).
struct Layout {
  int hp, sa, basis, ring, partial_stride, bytes;
  __host__ __device__ Layout(int C, int hop, int esize) {
    hp = (hop + kHT - 1) / kHT * kHT;
    sa = C + 16 / esize;
    basis = 2 * hp * sa;
    ring = kStages * (kRows + 1) * sa;
    partial_stride = kRows * hp + 1;
    bytes = (basis + ring) * esize + 4 * kSlices * partial_stride;
  }
};

// four channels as floats (float32 or bf16 rows, 16- or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
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
template <typename E>
__device__ __forceinline__ void load_tile(E* slot, const E* __restrict__ w, int tile,
                                          int n_tiles, int tiles_per_seq, int F, int C, int sa) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  if (tile < n_tiles) {
    const int b = tile / tiles_per_seq, f0 = tile % tiles_per_seq * kRows;
    const int CV = C / kVec;
    for (int i = threadIdx.x; i < (kRows + 1) * CV; i += blockDim.x) {
      const int j = i / CV, cv = i % CV;
      const int f = f0 - 1 + j;
      const bool valid = f >= 0 && f < F;
      const E* src = w + (static_cast<size_t>(b) * F + (valid ? f : 0)) * C + kVec * cv;
      cp_async16_zfill(slot + j * sa + kVec * cv, src, valid);
    }
  }
  cp_async_commit();
}

template <typename E>
__device__ __forceinline__ void decode_body(const E* __restrict__ w, const E* __restrict__ basis,
                                            float* __restrict__ out, int F, int C, int hop,
                                            int tiles_per_seq, int n_tiles,
                                            unsigned char* smem) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  const Layout lay(C, hop, static_cast<int>(sizeof(E)));
  const int sa = lay.sa, hp = lay.hp, C4 = C / 4, CV = C / kVec;
  E* bs = reinterpret_cast<E*>(smem);
  E* ring = bs + lay.basis;
  float* part = reinterpret_cast<float*>(ring + lay.ring);

  // the basis, halves at rows [0, hp) and [hp, 2 hp); it joins tile 0's group
  for (int i = threadIdx.x; i < 2 * hp * CV; i += blockDim.x) {
    const int row = i / CV, cv = i % CV;
    const int half = row / hp, h = row % hp;
    const E* src = basis + static_cast<size_t>(half * hop + (h < hop ? h : 0)) * C + kVec * cv;
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
  const E* b_lo = bs + hg * kHT * sa;         // basis[h], h = hg kHT + i
  const E* b_hi = bs + (hp + hg * kHT) * sa;  // basis[hop + h]
  float* my_part = part + s * lay.partial_stride + fg * kFT * hp + hg * kHT;

  for (int k = 0; first + k * step < n_tiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k has landed; every thread is done with tile k - 1
    load_tile(ring + (k + kStages - 1) % kStages * (kRows + 1) * sa, w,
              first + (k + kStages - 1) * step, n_tiles, tiles_per_seq, F, C, sa);

    // staged row j holds frame f0 + j - 1: frame fg kFT + i reads rows
    // fg kFT + i + 1 (W[f]) and fg kFT + i (W[f - 1])
    const E* rows = ring + k % kStages * (kRows + 1) * sa + fg * kFT * sa;
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

__global__ void __launch_bounds__(kGroupThreads * 4)
basis_decode_bf16_kernel(const bf16* __restrict__ w, const bf16* __restrict__ basis,
                         float* __restrict__ out, int F, int C, int hop, int tiles_per_seq,
                         int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  decode_body(w, basis, out, F, C, hop, tiles_per_seq, n_tiles, smem);
}

// Blocks of the persistent grid of `kernel` on the current device: as many
// as fit at once, cached per device, kernel and shape (the occupancy query
// costs host time).
cudaError_t grid_blocks(const void* kernel, int threads, int smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = known[key] = sms * per_sm;
  return cudaSuccess;
}

// One launch of `kernel` (basis_decode_kernel, or its bf16 form for E =
// bf16) on w and basis of type E.
template <typename E>
int launch(void (*kernel)(const E*, const E*, float*, int, int, int, int, int), const E* w,
           const E* basis, float* out, int B, int F, int C, int L, void* stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  if (B < 1 || F < 1 || C < kVec || C % kVec != 0 || L < 2 || L % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hop = L / 2;
  const int threads = kGroupThreads * ((hop + kHT - 1) / kHT);
  const long long smem = Layout(C, hop, static_cast<int>(sizeof(E))).bytes;
  if (threads > kGroupThreads * 4 || smem > fvt_smem::kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* k = reinterpret_cast<const void*>(kernel);
  cudaError_t err = fvt_smem::allow_max_smem(k);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = grid_blocks(k, threads, static_cast<int>(smem), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_seq = (F + 1 + kRows - 1) / kRows;
  const long long n_tiles = static_cast<long long>(B) * tiles_per_seq;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > n_tiles) blocks = static_cast<int>(n_tiles);
  kernel<<<blocks, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      w, basis, out, F, C, hop, tiles_per_seq, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the largest hop (L / 2) the kernel takes: four sample groups a block
extern "C" int fvt_basis_decode_max_hop() { return 4 * kHT; }

// w (B, F, C), basis (L, C), out (B, (F+1) * L/2); all float32, contiguous,
// 16-byte aligned, on the current device; C a multiple of 4, L even, F >= 1.
// Returns the CUDA error of the launch (0 = ok; cudaErrorInvalidValue for a
// shape whose block does not fit in shared memory).
extern "C" int fvt_basis_decode(const float* w, const float* basis, float* out, int B, int F,
                                int C, int L, void* stream) {
  return launch(basis_decode_kernel, w, basis, out, B, F, C, L, stream);
}

// The bf16 form: w (B, F, C) and basis (L, C) bf16, out float32; C a
// multiple of 8; otherwise as `fvt_basis_decode`.
extern "C" int fvt_basis_decode_bf16(const bf16* w, const bf16* basis, float* out, int B, int F,
                                     int C, int L, void* stream) {
  return launch(basis_decode_bf16_kernel, w, basis, out, B, F, C, L, stream);
}
