// The tensor-core contraction core of the MRF stage's kernels, forward
// (fused_mrf.cu) and backward (fused_mrf_bwd.cu), of the HiFiGAN tail's MRF
// (fused_tail.cu), and of the residual-stack chain's, forward
// (fused_resstack.cu) and backward (fused_resstack_bwd.cu).
//
// Replaces, as the inner loop of all five: the float32 CUDA-core
// contraction of the MRF and tail kernels' first versions and of the chain
// kernels'.  The TPU kernels these serve are
// fastvocoder_tpu/ops/fused_mrf.py::_mrf_kernel and ::_mrf_bwd_kernel,
// fastvocoder_tpu/ops/fused_tail.py::_tail_kernel, and
// fastvocoder_tpu/ops/fused_resstack.py::_chain_kernel and
// ::_chain_bwd_kernel.
//
// Every conv of a stage is out[r] (+)= sum_k in[r + off_k] W[k] over a tile
// of rows staged in shared memory: an implicit GEMM with M = rows, N = C,
// depth = taps x C, whose A operand for tap k is the same staged tile
// shifted by off_k rows.  No im2col copy exists: a shift is an address
// offset.
//
// Bound on an H100: operations.  On the CUDA cores the ceiling was the 67
// TFLOP/s float32 rate; the tensor cores do 495 TFLOP/s in TF32, but TF32
// keeps 10 mantissa bits and a stage must agree with float32 to 1e-5.  So:
//
//   * Arithmetic: 3xTF32 with float32 accumulation.  Each operand is split
//     a = hi + lo, hi = cvt.rna.tf32(a), lo = a - hi (read as TF32), and the
//     product is summed as lo hi + hi lo + hi hi (small terms first); lo lo
//     (2^-22 of the product) is dropped.  The products of one weight unit
//     (16 or 32 contracted channels of one tap) are summed in the tensor
//     core from zero and added to the float32 accumulator on the CUDA cores
//     (`conv_core` says why).  Ceiling: a third of the TF32 rate, 165
//     TFLOP/s.
//   * Instruction: wgmma.mma_async.m64nNk8.f32.tf32.tf32 with A from
//     registers and B from shared memory.  The taps shift the A tile by k d
//     rows with d = 1, 3, 5; a shared-memory A descriptor would have to
//     follow that shift through its swizzle, which repeats every 8 rows.
//     With A in registers a lane loads its fragment (rows g and g + 8 of its
//     warp's 16, channels t and t + 4 of the step's 8) from the padded
//     row-major tile, where a shift is a plain address offset, and splits it
//     there.  A first version on mma.sync.m16n8k8 ran 24 products and 16
//     fragment loads a warp and step where this runs 3 and 4; it stood at
//     0.27 of the 3xTF32 bound, held back by its instruction count.
//   * Weights through shared memory, split ahead of time: `pack_kernel`
//     writes every kernel of a stage once per call as hi and lo halves in
//     the order wgmma reads a K-major B operand without swizzle (core
//     matrices of 8 produced x 4 contracted channels, 128 contiguous
//     bytes), unit by unit.  A block streams the units through a cp.async
//     ring, one flat copy each, and every warpgroup reads them through a
//     descriptor: no weight passes through a register.
//   * Bank conflicts: rows of the staged tile are padded to C + 4 floats, so
//     that the 8 x 4 (row, channel) addresses of an A fragment load fall
//     into 32 different banks.
//   * No fixed rows a thread: a warpgroup owns 64 rows and sits a conv out
//     when they lie beyond the rows the conv needs.
//
// Geometry of a block at width C: kGroupsN warpgroups side by side over the
// channels (128 each, all of them below that) times WM warpgroups over the
// rows; 64 WM rows a pass.
//
// The bf16 forms (E = __nv_bfloat16: activations bf16 in device and shared
// memory, float32 parameters packed as bf16; the inference of a model
// served with compute_dtype bf16) have a core of their own
// (`conv_core_bf16`) on wgmma.mma_async.m64nNk16.f32.bf16.bf16 with both
// operands in shared memory: one product a depth step of 16, so their bound
// is the operation count at 989 TFLOP/s.
//   * The tensor core sums a whole conv: the accumulator starts at the
//     rounded bias and every product adds into it.  Its truncation moves a
//     stage's output by about 1e-5 of its size, 1/400 of a bf16 ulp, where
//     the float32 forms' 1e-4 parity forbids it.
//   * A slab's units are issued back to back, committed once, and waited on
//     with one slab left in flight; 32 KB slabs in a ring of 4 at C >= 128
//     (`TileBf16Pair`, `TileBf16Stack`).  A unit's wait, its sum on the CUDA
//     cores and its fragment loads are gone from the critical path.
//   * A from shared memory: a tap's shift of the tile is the descriptor's
//     start address.  At C >= 64 tile and weights lie in wgmma's 128-byte
//     swizzle (its phase follows the address bits, so any row may start a
//     tap); below, core matrices of 8 rows x 16 bytes, their columns padded
//     apart (`tile_at`, `Geo::kSwz`).
//   * The tile is staged by cp.async and the leaky-relu applied in place
//     while the first slabs land.
// The forms round to bf16 where the JAX package's Pallas bodies round
// (`fit`): the bias before it is added, every conv's output, every
// leaky-relu, every residual sum.  Their kernels have names of their own
// (`FVT_MMA_BF16_*_KERNEL`), so that a profile tells the forms apart.
//
// The bf16 backward forms (kernels 3b and 5b, template flag W16) compute
// in float32 as the TF32 forms do, on bf16 weights and bf16 x and g:
//   * A bf16 weight is a TF32 value: the lo half of its split is zero, so
//     `pack_kernel` packs its hi half alone (a unit is half the bytes, a
//     slab holds twice the units) and a depth step runs two products,
//     lo hi + hi hi, where the TF32 forms run three.  The dropped product
//     adds +0.0: the sums are the three-product sums bit for bit.  The
//     weight gradient contracts two float32 intermediates and keeps three.
//   * An operand flagged bf16 (`kBf16*`: x, g, a bias, dx; its pointer
//     then points at bf16) is widened where it is read (as a row is staged,
//     as a fragment or a mask is loaded) and rounded to bf16 once where it
//     is written (dx, and every dW and db in `fvt_bwd::wgrad_reduce_kernel`).
//     Every intermediate stays float32.
// Their kernels have names of their own (`FVT_MMA_W16_*_KERNEL`).
//
// Units in flight in the float32 and W16 forms: at C >= 128 the weight
// gradient issues a depth step's products before it waits on the last
// one's, and unit k + 1's before unit k's sum is added (two register sets
// of partial sums take turns, so each unit's sum still starts at zero);
// elsewhere, the convs at every width and the weight gradient at C <= 64, a
// unit is waited on before the next is issued, which measured faster there
// (`conv_core`, `WGeo::kPipe`).  The bf16 forward forms keep a slab in
// flight (`conv_core_bf16`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bwd_common.cuh"
#include "cp_async.cuh"
#include "smem_attr.cuh"

namespace fvt_mma {

constexpr int kMaxZ = 4;          // convs (branches) of one launch: blockIdx.z
constexpr int kMaxSmem = fvt_smem::kMaxSmem;  // dynamic shared memory a block may use

using bf16 = __nv_bfloat16;

// What a form's element type E sets: the padding of a staged row (16
// bytes), the halves of a packed weight (TF32 hi and lo; bf16 one) and the
// depth of one wgmma.
template <typename E>
struct Form;
template <>
struct Form<float> {
  static constexpr int kPad = 4, kHalves = 2, kDepth = 8;
};
template <>
struct Form<bf16> {
  static constexpr int kPad = 0, kHalves = 1, kDepth = 16;  // the tile: `tile_at`
};

template <typename E>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<E, bf16>::value;
}

// v as the form stores it: bf16 rounds to nearest, float32 keeps it
template <typename E>
__device__ __forceinline__ float fit(float v) {
  if constexpr (is_bf16<E>()) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two neighbouring elements (8-byte or 4-byte aligned) as floats, and back
template <typename E>
__device__ __forceinline__ float2 load2(const E* p) {
  if constexpr (is_bf16<E>()) {
    return unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(p)));
  } else {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
}
template <typename E>
__device__ __forceinline__ void store2(E* p, float2 v) {
  if constexpr (is_bf16<E>()) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v.x, v.y);
  } else {
    *reinterpret_cast<float2*>(p) = v;
  }
}
// four neighbouring elements (16-byte or 8-byte aligned)
template <typename E>
__device__ __forceinline__ float4 load4(const E* p) {
  if constexpr (is_bf16<E>()) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = unpack_bf16x2(v.x), b = unpack_bf16x2(v.y);
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}
template <typename E>
__device__ __forceinline__ void store4(E* p, float4 v) {
  if constexpr (is_bf16<E>()) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  } else {
    *reinterpret_cast<float4*>(p) = v;
  }
}

// Operands of the bf16 backward forms' passes that hold bf16 (the float*
// field then points at bf16): bits of the `bf16` field of an argument block
enum : int { kBf16Src = 1, kBf16Src2 = 2, kBf16Sgn = 4, kBf16Dst = 8, kBf16Bias = 16 };

// p + i elements of an operand that holds float32, or bf16 where b16
__device__ __forceinline__ const float* elem(const float* p, size_t i, bool b16) {
  return b16 ? reinterpret_cast<const float*>(reinterpret_cast<const bf16*>(p) + i) : p + i;
}
// two neighbouring elements there as floats (widened), and back (rounded)
__device__ __forceinline__ float2 load2_at(const float* p, size_t i, bool b16) {
  return b16 ? load2(reinterpret_cast<const bf16*>(p) + i) : load2(p + i);
}
__device__ __forceinline__ void store2_at(float* p, size_t i, float2 v, bool b16) {
  if (b16) {
    store2(reinterpret_cast<bf16*>(p) + i, v);
  } else {
    store2(p + i, v);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo exactly, hi TF32.  lo keeps up to 13 significant bits, of
// which the tensor core reads the upper 11 (it ignores the 13 low mantissa
// bits of an operand): what it drops is below 2^-22 |v|, so lo needs no
// conversion of its own.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d (64 x N) (+)= a (64 x 8, from registers) b (N x 8, K-major in shared
// memory behind `desc`), TF32 operands, one warpgroup; asynchronous.  Warp w
// of the group holds rows 16 w .. 16 w + 15 of a and d; there lane l = 4 g + t
// holds a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) and, of
// the 8-channel tile j of d, d[j][0] (g, 2 t), d[j][1] (g, 2 t + 1),
// d[j][2] (g + 8, 2 t), d[j][3] (g + 8, 2 t + 1).  With scale_d = 0 d is
// overwritten, not added to.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[2][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// d (64 x N) += a (64 x 16) b (N x 16), both K-major in shared memory
// behind their descriptors (`wgmma_desc`), bf16 operands, float32 sums, one
// warpgroup; asynchronous.  Warp w of the group holds rows 16 w .. 16 w + 15
// of d, as `Wgmma` does.  d is always added to (scale-d 1): the bf16 forms
// start it at the bias and let every product of a conv add into it.
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<16> {
  static __device__ __forceinline__ void run(float (&d)[2][4], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

// The descriptor of a K-major operand without swizzle: core matrices (8 rows
// of 16 bytes, contiguous) `k_stride` bytes apart along the depth and
// `n_stride` bytes apart along the rows.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t k_stride,
                                               uint32_t n_stride) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(k_stride >> 4) << 16) |
         (static_cast<uint64_t>(n_stride >> 4) << 32);
}

// registers written by ordinary instructions may be read by the wgmmas after
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// what this thread wrote to shared memory becomes visible to the wgmmas
// (which read it through the asynchronous proxy) that follow a barrier
__device__ __forceinline__ void fence_smem_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// waits until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators of an asynchronous wgmma to this point of the
// program (after its wait): a read of them cannot move above it.  No memory
// clobber, so that loads may still be scheduled across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]));
  }
}

using fvt_async::cp_async16;
using fvt_async::cp_async16_zfill;
using fvt_async::cp_async_commit;
using fvt_async::cp_async_wait;

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

__device__ __forceinline__ float4 leaky4(float4 v, float slope) {
  return make_float4(leaky(v.x, slope), leaky(v.y, slope), leaky(v.z, slope),
                     leaky(v.w, slope));
}

// numpy / torch "reflect" extension of [0, T) to any index
__device__ __forceinline__ int reflect_index(int i, int T) {
  if (T == 1) return 0;
  const int p = 2 * (T - 1);
  i %= p;
  if (i < 0) i += p;
  return i >= T ? p - i : i;
}

// ---------------------------------------------------------------------------
// geometry
// ---------------------------------------------------------------------------

// The blocks of the bf16 forward launches at width C, the pair kernels'
// (4b, 6b) and the stack kernels' (2b): warpgroups over the rows (WM),
// slabs of the weight ring (ST, at least 3: a slab on the tensor cores
// while a warpgroup waits, one waited on, the rest landing) and the bytes
// of a slab (rounded to whole weight units).  Chosen by `bin/tile_variants.py --bf16-forward` on
// an H100 (PERF.md section 6, PR 14).
template <int C>
struct TileBf16Pair;
template <>
struct TileBf16Pair<16> { static constexpr int kWM = 2, kST = 4, kSlabBytes = 8192; };
template <>
struct TileBf16Pair<32> { static constexpr int kWM = 4, kST = 4, kSlabBytes = 16384; };
template <>
struct TileBf16Pair<64> { static constexpr int kWM = 4, kST = 4, kSlabBytes = 16384; };
template <>
struct TileBf16Pair<128> { static constexpr int kWM = 2, kST = 4, kSlabBytes = 32768; };
template <>
struct TileBf16Pair<256> { static constexpr int kWM = 1, kST = 4, kSlabBytes = 32768; };
template <int C>
struct TileBf16Stack;
template <>
struct TileBf16Stack<32> { static constexpr int kWM = 2, kST = 4, kSlabBytes = 8192; };
template <>
struct TileBf16Stack<64> { static constexpr int kWM = 2, kST = 4, kSlabBytes = 16384; };
template <>
struct TileBf16Stack<128> { static constexpr int kWM = 2, kST = 4, kSlabBytes = 32768; };
template <>
struct TileBf16Stack<256> { static constexpr int kWM = 1, kST = 4, kSlabBytes = 32768; };
// and its 128-row block at C = 256, for grids of several waves
// (`run_chain`): a block takes kCost / 3 the time of a 64-row one
struct TileBf16StackWide { static constexpr int kWM = 2, kST = 4, kSlabBytes = 32768, kCost = 5; };

template <int C, typename E = float, bool W16 = false>
struct Geo {
  static constexpr int kNW = C < 128 ? C : 128;  // channels a warpgroup produces
  static constexpr int kGroupsN = C / kNW;       // warpgroups side by side
  static constexpr int kNT = kNW / 8;            // 8-channel tiles of a warpgroup
  static constexpr int kSA = C + Form<E>::kPad;  // elements a staged row (bf16: `tile_at`)
  // a weight unit: the kKC contracted channels [c kKC, (c + 1) kKC) of one
  // tap for all C produced channels, as kHalves halves (TF32: hi, then lo;
  // W16 and bf16: one), each in core matrices of 128 bytes, [kKC / kCK][C /
  // 8][8 produced][kCK contracted], kCK = 16 bytes of E.  The bf16 form at
  // C >= 64 (kSwz) lays a unit out as wgmma's 128-byte swizzle does
  // instead: 64 contracted channels, a 128-byte row a produced channel, its
  // 16-byte pieces in the order (piece ^ row % 8) (`swz`)
  static constexpr bool kSwz = is_bf16<E>() && C >= 64;
  static constexpr int kKC = kSwz ? 64 : (C == 16 || C >= 256 ? 16 : 32);
  static constexpr int kChunks = C / kKC;
  static constexpr int kCK = 16 / static_cast<int>(sizeof(E));
  static constexpr int kCoreElems = 8 * kCK;
  static constexpr int kHalfElems = C * kKC;
  static constexpr int kHalves = W16 ? 1 : Form<E>::kHalves;
  static constexpr int kUnitElems = kHalves * kHalfElems;
  static constexpr int kUnitBytes = kUnitElems * static_cast<int>(sizeof(E));
  // W16: twice the TF32 form's units, so that a slab has its bytes and the
  // launches size shared memory alike (a W16 slab of the TF32 form's units
  // measured 2-6 % slower on an H100: PERF.md section 6)
  static constexpr int kUnitsPerSlab =
      W16 ? 2 * Geo<C, E>::kUnitsPerSlab : (18432 / kUnitBytes > 0 ? 18432 / kUnitBytes : 1);
  static constexpr int kSlabElems = kUnitsPerSlab * kUnitElems;
  // the bf16 forms' units a slab of about `bytes` (`TileBf16Pair`)
  __host__ __device__ static constexpr int units_in(int bytes) {
    return (bytes + kUnitBytes / 2) / kUnitBytes > 0 ? (bytes + kUnitBytes / 2) / kUnitBytes : 1;
  }
  static constexpr uint32_t kStrideK = C / 8 * 128;  // bytes between core matrices in depth
  static constexpr uint32_t kStrideN = 128;          // and along the produced channels
};

// elements of the packed form of a kernel of K taps (`pack_kernel`)
template <int C, typename E = float, bool W16 = false>
__host__ __device__ constexpr size_t packed_elems(int K) {
  return static_cast<size_t>(Geo<C, E, W16>::kHalves) * K * C * C;
}
template <int C>
__host__ __device__ constexpr size_t packed_floats(int K) {
  return packed_elems<C, float>(K);
}

template <int C, int WM>
__host__ __device__ constexpr int block_threads() {
  return 128 * WM * Geo<C>::kGroupsN;
}

// The warp's place in its block and the lane's in its fragments.
template <int C, int WM>
struct Lane {
  int g, t;      // lane = 4 g + t
  int group_m;   // the warpgroup owns rows 64 group_m .. 64 group_m + 63
  int row0;      // first row of the warp: the lane holds rows row0 + g (+ 8)
  int n0;        // first channel of the warpgroup
  __device__ Lane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    g = lane / 4;
    t = lane % 4;
    group_m = warp / 4 / Geo<C>::kGroupsN;
    row0 = group_m * 64 + warp % 4 * 16;
    n0 = warp / 4 % Geo<C>::kGroupsN * Geo<C>::kNW;
  }
};

// ---------------------------------------------------------------------------
// the core
// ---------------------------------------------------------------------------

// Slab s of a packed kernel of K taps into one stage of the ring, by all
// threads of the block: a flat copy.
template <int C, int THREADS, typename E, bool W16 = false, int U = Geo<C, E, W16>::kUnitsPerSlab>
__device__ __forceinline__ void load_slab(E* stage, const E* __restrict__ W, int K, int s) {
  using G = Geo<C, E, W16>;
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  const int first = s * U;
  const int units = min(U, K * G::kChunks - first);
  const E* src = W + static_cast<size_t>(first) * G::kUnitElems;
  for (int i = threadIdx.x; i < units * (G::kUnitElems / kVec); i += THREADS) {
    cp_async16(stage + kVec * i, src + kVec * i);
  }
  cp_async_commit();  // a group per call, empty past the last slab
}

// acc += p on the CUDA cores, once p's group has completed
template <int NT>
__device__ __forceinline__ void add_partial(float (&acc)[NT][4], const float (&p)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
  }
}

// acc[j] += sum_{k < K} sum_c tile[row + off0 + k step][c] W[k][n_j][c] for
// the warpgroup's 64 rows and its channel tiles j, where `active`: the
// float32 forms' contraction (3xTF32; W16: two products against a bf16
// weight).  `tile` is the staged tile (rows of kSA elements), `off0` and
// `step` are in rows (step may be negative: an adjoint walks the taps
// backwards); W is the packed kernel; `ring` holds ST slabs, of which ST - 1
// are in flight ahead of the one in use.  Starts with a __syncthreads():
// what the block staged before the call is visible, and the ring is free.
//
// The tensor core adds into its accumulator with truncation, which over the
// hundreds of steps of a conv drifts by more than float32's rounding
// (measured on the mma.sync version: 1e-5 of a stage's output).  So the
// products of one unit are summed in the tensor core from zero, where a
// truncation is relative to that small partial sum, and the partial sum is
// added to acc on the CUDA cores, rounded to nearest.
//
// Two units in flight (the next unit's products issued before the last
// one's sum is waited on, two register sets in turn) measured 1-55 %
// slower at N <= 64 on an H100 (PERF.md section 6): a block shares its SM with
// others whose units fill the wait, and the second set cost registers;
// wider, it does not fit beside the accumulators.  So a unit is waited on
// before the next is issued.
template <int C, int WM, int ST, typename E, bool W16 = false>
__device__ __forceinline__ void conv_core(float (&acc)[Geo<C>::kNT][4], const E* tile, int off0,
                                          int step, const E* __restrict__ W, int K, E* ring,
                                          const Lane<C, WM>& ln, bool active) {
  static_assert(!is_bf16<E>(), "the bf16 forms contract in conv_core_bf16");
  using G = Geo<C, E, W16>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int kSteps = G::kKC / Form<E>::kDepth;
  const int n_slabs = (K * G::kChunks + G::kUnitsPerSlab - 1) / G::kUnitsPerSlab;
  // the lane's first element: row g, channel t
  const E* a_lane = tile + (ln.row0 + ln.g) * G::kSA + ln.t;
  const int b_group = ln.n0 / 8 * G::kCoreElems;  // to the warpgroup's first core matrix

  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load_slab<C, THREADS, E, W16>(ring + s * G::kSlabElems, W, K, s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<ST - 2>();
    fence_smem_for_wgmma();
    __syncthreads();  // slab s has landed; every warp is done with slab s - 1
    load_slab<C, THREADS, E, W16>(ring + (s + ST - 1) % ST * G::kSlabElems, W, K, s + ST - 1);
    if (!active) continue;
    const E* slab = ring + s % ST * G::kSlabElems;
    const int first = s * G::kUnitsPerSlab;
    const int units = min(G::kUnitsPerSlab, K * G::kChunks - first);
    for (int u = 0; u < units; ++u) {
      const int q = first + u;
      const int tap = q / G::kChunks, chunk = q % G::kChunks;
      const E* ap = a_lane + (off0 + tap * step) * G::kSA + chunk * G::kKC;
      const E* hi = slab + u * G::kUnitElems + b_group;
      float p[G::kNT][4];
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        split_tf32(ap[ks * 8], a_hi[ks][0], a_lo[ks][0]);
        split_tf32(ap[ks * 8 + 8 * G::kSA], a_hi[ks][1], a_lo[ks][1]);
        split_tf32(ap[ks * 8 + 4], a_hi[ks][2], a_lo[ks][2]);
        split_tf32(ap[ks * 8 + 8 * G::kSA + 4], a_hi[ks][3], a_lo[ks][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        // depth step ks: the core matrices 2 ks and 2 ks + 1 of each half;
        // W16 has no lo half (hi lo would add +0.0)
        const uint64_t d_hi =
            wgmma_desc(hi + 2 * ks * (C / 8) * G::kCoreElems, G::kStrideK, G::kStrideN);
        Wgmma<G::kNW>::run(p, a_lo[ks], d_hi, ks > 0);
        if constexpr (!W16) {
          const uint64_t d_lo = wgmma_desc(hi + G::kHalfElems + 2 * ks * (C / 8) * G::kCoreElems,
                                           G::kStrideK, G::kStrideN);
          Wgmma<G::kNW>::run(p, a_hi[ks], d_lo, 1);
        }
        Wgmma<G::kNW>::run(p, a_hi[ks], d_hi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      add_partial(acc, p);
    }
  }
}

// The 16-byte piece of a 128-byte row that holds piece `piece` in wgmma's
// 128-byte swizzle, for row `row` of its 8-row pattern
__host__ __device__ __forceinline__ int swz(int piece, int row) { return piece ^ (row & 7); }

// The bf16 forms' staged tile.  At C >= 64 (Geo::kSwz), rows of 128 bytes
// in 64-channel blocks, swizzled as wgmma's 128-byte mode reads them:
// element (r, c) at tile[(c / 64) rs + 64 r + 8 swz(c % 64 / 8, r) + c % 8],
// rs = 64 x its rows (a multiple of 8; the tile starts on 1024 bytes).
// Below, column-major in 8-channel columns: element (r, c) at tile[(c / 8)
// rs + 8 r + c % 8], rs = 8 x its rows; eight rows of a column are the 128
// contiguous bytes of a core matrix.  Either way a tap's shift of the A
// operand is a descriptor's start address, and no fragment passes through a
// register.
template <int C>
__device__ __forceinline__ bf16* tile_at(bf16* tile, int rs, int r, int c) {
  if constexpr (C >= 64) {
    return tile + (c >> 6) * rs + 64 * r + (swz((c >> 3) & 7, r) << 3) + (c & 7);
  } else {
    return tile + (c >> 3) * rs + 8 * r + (c & 7);
  }
}

// the stride rs of a bf16 tile of `rows` rows (`tile_at`)
template <int C>
__host__ __device__ __forceinline__ int tile_stride(int rows) {
  return (C >= 64 ? 64 : 8) * rows;
}

// The descriptor of a K-major bf16 operand in wgmma's 128-byte swizzle at
// `smem`: 8-row groups 1024 bytes apart.  The swizzle follows the address
// bits (found on an H100: a base offset of the pattern's phase at the start
// breaks the products), so a tap's shift of the tile by any number of rows
// is its start address alone.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint32_t leaky_bf16x2(uint32_t v, float slope) {
  const float2 f = unpack_bf16x2(v);
  return pack_bf16x2(leaky(f.x, slope), leaky(f.y, slope));
}

// Stages src[g_lo .. g_lo + n) of one sequence (T rows of C bf16; zeros
// outside [0, T), or mirrored) into a tile laid out as `tile_at` says (rs
// its column stride), asynchronously: by cp.async, one commit group.  The
// leaky-relu is applied once the rows have landed (`conv_core_bf16`), its
// products rounded to bf16 as the Pallas bodies round them.  A warp takes 8
// rows of 4 neighbouring 8-channel columns: its loads are 64 contiguous
// bytes a row, and each quarter of it stores a column's 8 rows, 128
// contiguous bytes.
template <int C, int THREADS>
__device__ __forceinline__ void stage_rows_bf16(bf16* tile, int rs, const bf16* __restrict__ src,
                                                int T, int g_lo, int n, bool mirror = false) {
  constexpr int CV = C / 8;  // columns
  const int groups = (n + 7) / 8;
  for (int i = threadIdx.x; i < groups * 8 * CV; i += THREADS) {
    const int row = i / (8 * CV) * 8 + i % 8, cv = i / 8 % CV;
    if (row >= n) continue;
    int g = mirror ? reflect_index(g_lo + row, T) : g_lo + row;
    const bool inside = g >= 0 && g < T;
    g = inside ? g : 0;
    cp_async16_zfill(tile_at<C>(tile, rs, row, 8 * cv), src + static_cast<size_t>(g) * C + 8 * cv,
                     inside);
  }
  cp_async_commit();
}

// leaky(v, slope) in place on the first n rows of a bf16 tile (`tile_at`)
template <int C, int THREADS>
__device__ __forceinline__ void leaky_rows_bf16(bf16* tile, int rs, int n, float slope) {
  constexpr int CV = C / 8;
  for (int i = threadIdx.x; i < n * CV; i += THREADS) {
    const int row = i % n, cv = i / n;
    uint4* at = reinterpret_cast<uint4*>(tile_at<C>(tile, rs, row, 8 * cv));
    const uint4 v = *at;
    *at = make_uint4(leaky_bf16x2(v.x, slope), leaky_bf16x2(v.y, slope),
                     leaky_bf16x2(v.z, slope), leaky_bf16x2(v.w, slope));
  }
}

// acc[j] += sum_{k < K} sum_c tile[row + off0 + k step][c] W[k][n_j][c], the
// bf16 forms' contraction (step > 0; `tile` as `tile_at` lays it out, rs its
// stride): A and B both from shared memory, one wgmma m64nNk16 a depth
// step, every product of the conv summed into acc by the tensor core (acc
// starts at the bias: `init_acc`).  The truncation that makes the float32
// forms sum a unit apart moves a stage's output by about 1e-5 of its size,
// 1/400 of a bf16 ulp, and the sums are rounded to bf16 where the Pallas
// bodies round.  A slab's units are issued back to back and committed
// once; the warpgroup then waits until one slab is left in flight, so that
// it runs on the tensor cores while the next lands and the ones after are
// copied (ST - 2 slabs ahead of the one in use).  A copy into the stage of
// slab s - 2 waits for the barrier at the top of the iteration of slab s,
// when every warpgroup has waited on it.  Every warpgroup runs every
// product, also one whose rows lie past the conv's (its sums are not
// stored): ptxas serializes the wgmmas of a path that depends on the
// thread.  Starts with a __syncthreads(), as `conv_core`; the rows a
// `stage_rows_bf16` copies before the call land with the first slab, and
// where `leaky_n` > 0 their first leaky_n rows take the leaky-relu once
// they have landed, while the first slabs are on their way.  Returns with
// the products done.
template <int C, int WM, int ST, int SLAB>
__device__ __forceinline__ void conv_core_bf16(float (&acc)[Geo<C>::kNT][4], bf16* tile, int rs,
                                               int off0, int step, const bf16* __restrict__ W,
                                               int K, bf16* ring, const Lane<C, WM>& ln,
                                               int leaky_n = 0, float slope = 1.0f) {
  static_assert(ST >= 3, "a slab on the tensor cores, one waited on, one landing");
  using G = Geo<C, bf16>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int kU = G::units_in(SLAB);
  constexpr int kSlabElems = kU * G::kUnitElems;
  constexpr int kSteps = G::kKC / Form<bf16>::kDepth;
  const int total = K * G::kChunks;
  const int n_slabs = (total + kU - 1) / kU;
  // descriptors (in 16-byte steps from these): A at the warpgroup's first
  // row of channel column 0, B at its first core matrix of stage 0 (the
  // swizzled layout: addresses, its descriptors made at each product)
  const uint64_t a0 = wgmma_desc(tile + (ln.group_m * 64 + off0) * 8, 2 * rs, 128);
  const uint64_t b0 = wgmma_desc(ring + ln.n0 / 8 * G::kCoreElems, G::kStrideK, G::kStrideN);
  const bf16* a_rows = tile + (ln.group_m * 64 + off0) * 64;

  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST - 2; ++s) {
    load_slab<C, THREADS, bf16, false, kU>(ring + s * kSlabElems, W, K, s);
  }
  if (leaky_n > 0) {
    cp_async_wait<ST - 2>();  // the staged rows
    __syncthreads();
    leaky_rows_bf16<C, THREADS>(tile, rs, leaky_n, slope);
  }
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<ST - 3>();
    fence_smem_for_wgmma();
    __syncthreads();  // slab s has landed; every warpgroup is done with slab s - 2
    load_slab<C, THREADS, bf16, false, kU>(ring + (s + ST - 2) % ST * kSlabElems, W, K,
                                           s + ST - 2);
    const uint64_t b_slab = b0 + static_cast<uint64_t>(s % ST * (kSlabElems / 8));
    const bf16* slab = ring + s % ST * kSlabElems + ln.n0 * G::kKC;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = s * kU + u;
      if (q < total) {
        const int tap = q / G::kChunks, chunk = q % G::kChunks;
        if constexpr (G::kSwz) {
          // depth step ks: 32 bytes into the rows of the unit's 64 channels
          const bf16* a = a_rows + chunk * rs + tap * step * 64;
          const bf16* b = slab + u * G::kUnitElems;
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            WgmmaBf16<G::kNW>::run(acc, wgmma_desc_sw128(a + 16 * ks),
                                   wgmma_desc_sw128(b + 16 * ks));
          }
        } else {
          const uint64_t a =
              a0 + static_cast<uint64_t>(chunk * G::kKC / 8 * (rs / 8) + tap * step);
          const uint64_t b = b_slab + static_cast<uint64_t>(u * (G::kUnitElems / 8));
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks) {
            // depth step ks: channel columns (and core matrices) 2 ks, 2 ks + 1
            WgmmaBf16<G::kNW>::run(acc, a + static_cast<uint64_t>(2 * ks * (rs / 8)),
                                   b + static_cast<uint64_t>(2 * ks * (C / 8) * (G::kCoreElems / 8)));
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc[j] = bias[channel] (+ bias2[channel]; zeros without a bias), each
// bias as the form E stores it (rounded to bf16 in the bf16 forms, as the
// JAX package casts a bias to the compute type before it is added); with
// `b16` both biases hold bf16 (the bf16 backward forms), widened
template <int C, int WM, typename E = float>
__device__ __forceinline__ void init_acc(float (&acc)[Geo<C>::kNT][4],
                                         const float* __restrict__ bias,
                                         const Lane<C, WM>& ln,
                                         const float* __restrict__ bias2 = nullptr,
                                         bool b16 = false) {
#pragma unroll
  for (int j = 0; j < Geo<C>::kNT; ++j) {
    const int col = ln.n0 + j * 8 + 2 * ln.t;
    float2 b = make_float2(0.f, 0.f);
    if (bias != nullptr) {
      b = load2_at(bias, col, b16);
      b = make_float2(fit<E>(b.x), fit<E>(b.y));
    }
    if (bias2 != nullptr) {
      const float2 b2 = load2_at(bias2, col, b16);
      b = make_float2(b.x + fit<E>(b2.x), b.y + fit<E>(b2.y));
    }
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
}

// leaky(v, slope) as the form E stores it
template <typename E>
__device__ __forceinline__ float leaky_fit(float v, float slope) {
  return v >= 0.0f ? v : fit<E>(v * slope);
}

// Stages leaky(src[g_lo .. g_lo + n), slope) of one sequence (T rows of C
// elements) into `tile`, zeros outside [0, T): every conv's zero padding; or,
// with `mirror`, the mirrored rows there: a residual stack's reflect pad
// (any number of folds, down to T = 1).  With `b16` the float32 tile takes
// a bf16 source (src points at bf16), widened as it is staged.
template <int C, int THREADS>
__device__ __forceinline__ void stage_rows(float* tile, const float* __restrict__ src, int T,
                                           int g_lo, int n, float slope, bool mirror = false,
                                           bool b16 = false) {
  constexpr int CV = C / 4;  // 16-byte stores a row
  if (b16) {
    // 4 bf16 (8 bytes) in, a float4 out a thread: neighbouring threads
    // store neighbouring 16 bytes, as the float32 staging does
    const bf16* s16 = reinterpret_cast<const bf16*>(src);
    for (int i = threadIdx.x; i < n * CV; i += THREADS) {
      const int row = i / CV, cv = i % CV;
      const int g = mirror ? reflect_index(g_lo + row, T) : g_lo + row;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T) {
        const uint2 u =
            __ldg(reinterpret_cast<const uint2*>(s16 + static_cast<size_t>(g) * C) + cv);
        const float2 a = unpack_bf16x2(u.x), b = unpack_bf16x2(u.y);
        v = leaky4(make_float4(a.x, a.y, b.x, b.y), slope);
      }
      *reinterpret_cast<float4*>(tile + row * Geo<C>::kSA + 4 * cv) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < n * CV; i += THREADS) {
    const int row = i / CV, cv = i % CV;
    const int g = mirror ? reflect_index(g_lo + row, T) : g_lo + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < T) {
      v = leaky4(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * C) + cv),
                 slope);
    }
    *reinterpret_cast<float4*>(tile + row * Geo<C>::kSA + 4 * cv) = v;
  }
}

// A form's staging, contraction and tile addressing: the float32 forms'
// row-major tile (`stage_rows`, `conv_core`), the bf16 forms' column-major
// one (`stage_rows_bf16`, `conv_core_bf16`, `tile_at`; rs its column
// stride, 8 x its rows).  Every conv of the pair and stack bodies reads its
// tile from row 0, tap k at row k step.
// `stage` the rows of `conv`'s first call, which applies the leaky-relu to
// the first `leaky_n` of them in the bf16 forms (`stage_rows_bf16`).
template <int C, int THREADS, typename E>
__device__ __forceinline__ void stage(E* tile, int rs, const E* __restrict__ src, int T, int g_lo,
                                      int n, float slope, bool mirror, bool b16) {
  if constexpr (is_bf16<E>()) {
    stage_rows_bf16<C, THREADS>(tile, rs, src, T, g_lo, n, mirror);
  } else {
    stage_rows<C, THREADS>(tile, src, T, g_lo, n, slope, mirror, b16);
  }
}

template <int C, int WM, int ST, typename E, bool W16, int SLAB>
__device__ __forceinline__ void conv(float (&acc)[Geo<C>::kNT][4], E* tile, int rs, int step,
                                     const E* __restrict__ W, int K, E* ring,
                                     const Lane<C, WM>& ln, bool active, int leaky_n = 0,
                                     float slope = 1.0f) {
  if constexpr (is_bf16<E>()) {
    // every warpgroup
    conv_core_bf16<C, WM, ST, SLAB>(acc, tile, rs, 0, step, W, K, ring, ln, leaky_n, slope);
  } else {
    conv_core<C, WM, ST, E, W16>(acc, tile, 0, step, W, K, ring, ln, active);
  }
}

// the first element of a pair or stack body's shared memory: the swizzled
// bf16 tile starts on 1024 bytes (launches ask for them more)
template <int C, typename E>
__device__ __forceinline__ E* smem_base(E* smem) {
  if constexpr (Geo<C, E>::kSwz) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    return smem + ((1024 - (a & 1023)) & 1023) / sizeof(E);
  } else {
    return smem;
  }
}

template <int C, typename E>
__device__ __forceinline__ E* tile_elem(E* tile, int rs, int r, int c) {
  if constexpr (is_bf16<E>()) {
    return tile_at<C>(tile, rs, r, c);
  } else {
    return tile + r * Geo<C, E>::kSA + c;
  }
}

// ---------------------------------------------------------------------------
// packing the kernels
// ---------------------------------------------------------------------------

constexpr int kMaxPack = 64;

// Up to kMaxPack kernels: src (K, C, C) of type S as (tap, produced,
// contracted), or with `swap` as (tap, contracted, produced); dst
// `packed_elems<C, E, W16>(K)` elements.
template <typename E, typename S = float>
struct PackArgsT {
  const S* src[kMaxPack];
  E* dst[kMaxPack];
  int K[kMaxPack];
  int swap[kMaxPack];
};
using PackArgs = PackArgsT<float>;
// the bf16 backward forms': bf16 kernels packed for the W16 passes
using PackArgsW16 = PackArgsT<float, bf16>;

// dst = src in the order `conv_core` reads it: per unit (tap, chunk of kKC
// contracted channels) the core matrices [kKC / kCK][C / 8][8 produced][kCK
// contracted]; the TF32 form split into its hi half, then its lo half, the
// bf16 form rounded to nearest; from bf16 kernels into a TF32 packing (W16)
// the hi half alone: a bf16 value is a TF32 value, its lo half zero.
template <int C, typename E, typename S>
__global__ void __launch_bounds__(256) pack_kernel(PackArgsT<E, S> a) {
  constexpr bool kW16 = is_bf16<S>() && !is_bf16<E>();
  using G = Geo<C, E, kW16>;
  constexpr int kCK = G::kCK;
  const int conv = blockIdx.y;
  const S* __restrict__ src = a.src[conv];
  E* __restrict__ dst = a.dst[conv];
  const int total = a.K[conv] * C * C;
  const bool swap = a.swap[conv] != 0;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int unit = i / G::kHalfElems, within = i % G::kHalfElems;
    const int kk = within % kCK, r8 = within / kCK % 8, ng = within / (8 * kCK) % (C / 8);
    const int kg = within / (8 * kCK * (C / 8));
    const int tap = unit / G::kChunks, chunk = unit % G::kChunks;
    const int produced = ng * 8 + r8, contracted = chunk * G::kKC + kg * kCK + kk;
    const S* from = src + (static_cast<size_t>(tap) * C + (swap ? contracted : produced)) * C +
                    (swap ? produced : contracted);
    float v;
    if constexpr (is_bf16<S>()) {
      v = __bfloat162float(__ldg(from));
    } else {
      v = __ldg(from);
    }
    E* at = dst + static_cast<size_t>(unit) * G::kUnitElems;
    if constexpr (G::kSwz) {
      at += produced * G::kKC + (swz(kg, produced) << 3) + kk;
    } else {
      at += within;
    }
    if constexpr (is_bf16<E>()) {
      *at = __float2bfloat16_rn(v);
    } else if constexpr (kW16) {
      *at = v;
    } else {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      at[0] = __uint_as_float(hi);
      at[G::kHalfElems] = __uint_as_float(lo);
    }
  }
}

template <int C, typename E, typename S>
cudaError_t launch_pack(const PackArgsT<E, S>& a, int n, cudaStream_t stream) {
  int max_K = 1;
  for (int i = 0; i < n; ++i) max_K = max_K > a.K[i] ? max_K : a.K[i];
  const int blocks = (max_K * C * C + 255) / 256;
  pack_kernel<C, E, S><<<dim3(blocks < 64 ? blocks : 64, n), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// one pair of an MRF branch: h' = h + conv2(leaky(conv1(leaky(h)) + b1)) + b2
// ---------------------------------------------------------------------------

// One pair position of up to kMaxZ branches.  Kernels packed from
// (tap, c_out, c_in); activations of the form's type E.
template <typename E>
struct PairArgsT {
  const E* src[kMaxZ];        // (B, T, C): the pair's input h
  E* dst[kMaxZ];              // (B, T, C): h', or null: conv2 is not run
  E* u_dst[kMaxZ];            // (B, T, C): u = leaky(conv1 + b1), or null
  const E* w1[kMaxZ];         // packed (K1, C, C)
  const float* b1[kMaxZ];     // (C,)
  const E* w2[kMaxZ];         // packed (K2, C, C)
  const float* b2[kMaxZ];     // (C,)
  int k1[kMaxZ];
  int dil[kMaxZ];
  int k2[kMaxZ];
  float slope;                // the leaky-relu's, before both convs
  int bf16 = 0;               // W16: kBf16Src (every src is bf16 x), kBf16Bias
};
using PairArgs = PairArgsT<float>;

// Block x owns rows [x R, x R + R) of sequence blockIdx.y in branch
// blockIdx.z.  It stages leaky(h) over the R + 2 (m1 + m2) rows the pair
// reads (m1 = (K1 - 1) / 2 d, m2 = (K2 - 1) / 2), zeros outside [0, T);
// computes u over R + 2 m2 rows, zeroed outside [0, T), into the same
// shared-memory rows once every warp has read the tile for the last time;
// computes conv2 over its R rows and adds the residual h from device
// memory.  R + 2 m2 <= 64 WM.  Shared memory: `tile_rows` rows of kSA
// elements, then the weight ring.  The bf16 form rounds u's conv and its
// leaky-relu, conv2 and the residual sum, as fused_mrf.py's Pallas body
// does.  The body of each library's pair kernel (`FVT_MMA_PAIR_KERNEL`,
// `FVT_MMA_BF16_PAIR_KERNEL`, `FVT_MMA_W16_PAIR_KERNEL`), which names it
// after its library and form, so that a profile tells the forward's
// launches from the backward's recompute.
template <int C, int WM, int ST, typename E, bool W16 = false, int SLAB = 0>
__device__ __forceinline__ void pair_body(const PairArgsT<E>& a, int T, int R, int tile_rows,
                                          E* smem) {
  using G = Geo<C, E>;
  constexpr int THREADS = block_threads<C, WM>();
  const Lane<C, WM> ln;
  const int z = gridDim.z - 1 - blockIdx.z, b = blockIdx.y;  // see launch_pair
  const int q0 = blockIdx.x * R;
  const int no = min(R, T - q0);
  const int K1 = a.k1[z], d = a.dil[z], K2 = a.k2[z];
  const int m1 = (K1 - 1) / 2 * d, m2 = (K2 - 1) / 2;
  const int nu = no + 2 * m2, u_lo = q0 - m2;
  const size_t base = static_cast<size_t>(b) * T * C;
  E* tile = smem_base<C>(smem);
  E* ring = tile + tile_rows * G::kSA;
  float acc[G::kNT][4];
  const bool sb = W16 && (a.bf16 & kBf16Src) != 0, bb = W16 && (a.bf16 & kBf16Bias) != 0;
  const E* src = a.src[z] + base;
  if constexpr (W16) src = elem(a.src[z], base, sb);
  const int rs = tile_stride<C>(tile_rows);  // the bf16 tile's (`tile_at`)

  stage<C, THREADS>(tile, rs, src, T, u_lo - m1, nu + 2 * m1, a.slope, false, sb);

  // u row i reads the staged rows i + k d
  const bool active_u = ln.group_m * 64 < nu;
  init_acc<C, WM, E>(acc, a.b1[z], ln, nullptr, bb);
  conv<C, WM, ST, E, W16, SLAB>(acc, tile, rs, d, a.w1[z], K1, ring, ln, active_u, nu + 2 * m1,
                                a.slope);
  __syncthreads();  // the tile is read no more: u takes its rows
  E* u_out = a.u_dst[z];
  if (active_u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row0 + ln.g + 8 * half;
      const int gr = u_lo + r;
      const bool inside = r < nu && gr >= 0 && gr < T;
      const bool owned = inside && u_out != nullptr && r >= m2 && r < m2 + no;
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        const int col = ln.n0 + j * 8 + 2 * ln.t;
        float2 v = make_float2(0.f, 0.f);
        if (inside) {
          v = make_float2(leaky_fit<E>(fit<E>(acc[j][2 * half]), a.slope),
                          leaky_fit<E>(fit<E>(acc[j][2 * half + 1]), a.slope));
        }
        store2(tile_elem<C>(tile, rs, r, col), v);
        if (owned) store2(u_out + base + static_cast<size_t>(gr) * C + col, v);
      }
    }
  }
  if (a.dst[z] == nullptr) return;

  // output row i reads u rows i + k
  const bool active_o = ln.group_m * 64 < no;
  init_acc<C, WM, E>(acc, a.b2[z], ln, nullptr, bb);
  conv<C, WM, ST, E, W16, SLAB>(acc, tile, rs, 1, a.w2[z], K2, ring, ln, active_o);
  if (!active_o) return;
  auto store = [&](auto src_bf16) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row0 + ln.g + 8 * half;
      if (r >= no) continue;
      const size_t row = base + static_cast<size_t>(q0 + r) * C;
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        const size_t at = row + ln.n0 + j * 8 + 2 * ln.t;
        float2 h;
        if constexpr (W16) {
          h = load2_at(a.src[z], at, decltype(src_bf16)::value);
        } else {
          h = load2(a.src[z] + at);
        }
        store2(a.dst[z] + at, make_float2(fit<E>(h.x + fit<E>(acc[j][2 * half])),
                                          fit<E>(h.y + fit<E>(acc[j][2 * half + 1]))));
      }
    }
  };
  if (sb) {
    store(std::true_type{});
  } else {
    store(std::false_type{});
  }
}

template <typename E>
using PairKernelT = void (*)(PairArgsT<E>, int, int, int);
typedef PairKernelT<float> PairKernel;

#define FVT_MMA_PAIR_KERNEL(name)                                               \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::PairArgs a, int T, int R, int tile_rows) {                      \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::pair_body<C, WM, ST, float>(a, T, R, tile_rows, smem);             \
  }

#define FVT_MMA_BF16_PAIR_KERNEL(name)                                          \
  template <int C, int WM, int ST, int SLAB>                                    \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::PairArgsT<fvt_mma::bf16> a, int T, int R, int tile_rows) {      \
    extern __shared__ __align__(16) unsigned char smem_raw[];                  \
    fvt_mma::pair_body<C, WM, ST, fvt_mma::bf16, false, SLAB>(                  \
        a, T, R, tile_rows, reinterpret_cast<fvt_mma::bf16*>(smem_raw));        \
  }

#define FVT_MMA_W16_PAIR_KERNEL(name)                                           \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::PairArgs a, int T, int R, int tile_rows) {                      \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::pair_body<C, WM, ST, float, true>(a, T, R, tile_rows, smem);       \
  }

// One launch of `kernel` (a FVT_MMA_PAIR_KERNEL or FVT_MMA_BF16_PAIR_KERNEL
// at C, WM, ST) with `a` over nz branches of (B, T, C).  The grid starts its
// blocks in the order of blockIdx.z, and the kernels read it backwards:
// HiFiGAN lists its branches by rising kernel size, so the longest blocks
// start first and the short ones fill the launch's tail.
// elements of the weight ring of ST slabs: the float32 forms' Geo slabs, or
// the bf16 forms' of about SLAB bytes
template <int C, typename E, int ST, int SLAB>
__host__ __device__ constexpr int ring_elems() {
  using G = Geo<C, E>;
  return ST * (is_bf16<E>() ? G::units_in(SLAB) * G::kUnitElems : G::kSlabElems);
}

// the rows of a tile of `rows` rows as the form lays it out: the swizzled
// bf16 tile a multiple of its 8-row pattern
template <int C, typename E>
int tile_rows_of(int rows) {
  return Geo<C, E>::kSwz ? (rows + 7) / 8 * 8 : rows;
}

// bytes of shared memory a pair or stack launch asks for
template <int C, typename E, int ST, int SLAB>
int body_smem(int tile_rows) {
  return static_cast<int>(sizeof(E)) * (tile_rows * Geo<C, E>::kSA + ring_elems<C, E, ST, SLAB>()) +
         (Geo<C, E>::kSwz ? 1024 : 0);
}

template <int C, int WM, int ST, typename E, int SLAB = 0>
cudaError_t launch_pair(PairKernelT<E> kernel, const PairArgsT<E>& a, int nz, int B, int T,
                        cudaStream_t stream) {
  constexpr int kRows = 64 * WM;
  int max_m1 = 0, max_m2 = 0;
  for (int z = 0; z < nz; ++z) {
    if (a.k1[z] < 1 || a.k1[z] % 2 == 0 || a.dil[z] < 1 || a.k2[z] < 1 || a.k2[z] % 2 == 0) {
      return cudaErrorInvalidValue;
    }
    const int m1 = (a.k1[z] - 1) / 2 * a.dil[z], m2 = (a.k2[z] - 1) / 2;
    max_m1 = max_m1 > m1 ? max_m1 : m1;
    max_m2 = max_m2 > m2 ? max_m2 : m2;
  }
  const int R = kRows - 2 * max_m2;
  // conv1 reads up to row kRows - 1 + 2 m1 of the tile, conv2 up to
  // kRows - 1 + 2 m2 of u (a warpgroup computes its 64 rows whole, so its
  // last rows may read past the rows staged; what they produce is never
  // stored)
  const int tile_rows = tile_rows_of<C, E>(kRows + 2 * (max_m1 > max_m2 ? max_m1 : max_m2));
  const int smem = body_smem<C, E, ST, SLAB>(tile_rows);
  if (R < 1 || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B, nz);
  kernel<<<grid, block_threads<C, WM>(), smem, stream>>>(a, T, R, tile_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// one residual stack of a MelGAN-family chain:
// h' = conv_1x1(leaky(conv_K,d(reflect_pad(leaky(h), m)) + bd)) + b1
//      + conv_1x1_skip(h) + bs
// ---------------------------------------------------------------------------

// One stack.  Kernels packed from (tap, c_out, c_in); activations of the
// form's type E.
template <typename E>
struct StackArgsT {
  const E* src;      // (B, T, C): the stack's input h
  E* dst;            // (B, T, C): h', or null: the 1x1 convs are not run
  E* u_dst;          // (B, T, C): u = leaky(conv_d + bd), or null
  const E* wd;       // packed (K, C, C)
  const float* bd;   // (C,)
  const E* w1;       // packed (1, C, C)
  const float* b1;   // (C,)
  const E* ws;       // packed (1, C, C): the skip conv
  const float* bs;   // (C,)
  int K;
  int dil;
  float slope;  // the leaky-relu's, before both convs
  int bf16 = 0;  // W16: kBf16Src (src is bf16 x), kBf16Bias
};
using StackArgs = StackArgsT<float>;

// Block x owns rows [x R, x R + R) of sequence blockIdx.y, R = 64 WM.  A
// 1x1 conv needs no halo, so a stack a launch recomputes nothing: the block
// stages leaky(h) over its R + 2 m rows (m = (K - 1) / 2 d), mirrored at the
// sequence's edges as the stack's reflect pad is; computes u over its rows
// into the same shared-memory rows once every warp has read the tile for the
// last time; then acc = b1 + bs + W1 u and, with the raw h of its rows
// staged over u, acc += Ws h.  One tile and the weight ring: 150 KB at
// C = 256, m = 9.  The bf16 form rounds where fused_resstack.py's Pallas
// body does: u's conv and its leaky-relu, t = W1 u + b1 and the skip
// Ws h + bs apart (t is kept in registers as bf16 pairs meanwhile), and
// their sum.  The body of each library's stack kernel
// (`FVT_MMA_STACK_KERNEL`, `FVT_MMA_BF16_STACK_KERNEL`,
// `FVT_MMA_W16_STACK_KERNEL`), which names it after its library and form,
// so that a profile tells the forward's launches from the backward's
// recompute.
template <int C, int WM, int ST, typename E, bool W16 = false, int SLAB = 0>
__device__ __forceinline__ void stack_body(const StackArgsT<E>& a, int T, int tile_rows,
                                           E* smem) {
  using G = Geo<C, E>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int R = 64 * WM;
  const Lane<C, WM> ln;
  const int q0 = blockIdx.x * R;
  const int no = min(R, T - q0);
  const int d = a.dil, m = (a.K - 1) / 2 * d;
  const size_t base = static_cast<size_t>(blockIdx.y) * T * C;
  const bool sb = W16 && (a.bf16 & kBf16Src) != 0, bb = W16 && (a.bf16 & kBf16Bias) != 0;
  const E* src = a.src + base;
  if constexpr (W16) src = elem(a.src, base, sb);
  E* tile = smem_base<C>(smem);
  E* ring = tile + tile_rows * G::kSA;
  const int rs = tile_stride<C>(tile_rows);  // the bf16 tile's (`tile_at`)
  float acc[G::kNT][4];

  stage<C, THREADS>(tile, rs, src, T, q0 - m, no + 2 * m, a.slope, true, sb);
  // u row i reads the staged rows i + k d
  const bool active = ln.group_m * 64 < no;
  init_acc<C, WM, E>(acc, a.bd, ln, nullptr, bb);
  conv<C, WM, ST, E, W16, SLAB>(acc, tile, rs, d, a.wd, a.K, ring, ln, active, no + 2 * m,
                                a.slope);
  __syncthreads();  // the tile is read no more: u takes its rows
  if (active) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row0 + ln.g + 8 * half;
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        const int col = ln.n0 + j * 8 + 2 * ln.t;
        const float2 v = make_float2(leaky_fit<E>(fit<E>(acc[j][2 * half]), a.slope),
                                     leaky_fit<E>(fit<E>(acc[j][2 * half + 1]), a.slope));
        store2(tile_elem<C>(tile, rs, r, col), v);
        if (a.u_dst != nullptr && r < no) {
          store2(a.u_dst + base + static_cast<size_t>(q0 + r) * C + col, v);
        }
      }
    }
  }
  if (a.dst == nullptr) return;

  uint32_t t_kept[G::kNT][2];  // the bf16 form's t, rows g and g + 8
  if constexpr (is_bf16<E>()) {
    init_acc<C, WM, E>(acc, a.b1, ln);
    conv<C, WM, ST, E, W16, SLAB>(acc, tile, rs, 1, a.w1, 1, ring, ln, active);
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      t_kept[j][0] = pack_bf16x2(acc[j][0], acc[j][1]);
      t_kept[j][1] = pack_bf16x2(acc[j][2], acc[j][3]);
    }
    init_acc<C, WM, E>(acc, a.bs, ln);
  } else {
    init_acc<C, WM, E>(acc, a.b1, ln, a.bs, bb);
    conv<C, WM, ST, E, W16, SLAB>(acc, tile, rs, 1, a.w1, 1, ring, ln, active);
  }
  __syncthreads();  // u is read no more: the raw rows of h take its place
  stage<C, THREADS>(tile, rs, src, T, q0, no, 1.0f, false, sb);
  conv<C, WM, ST, E, W16, SLAB>(acc, tile, rs, 1, a.ws, 1, ring, ln, active);
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.row0 + ln.g + 8 * half;
    if (r >= no) continue;
    E* row = a.dst + base + static_cast<size_t>(q0 + r) * C;
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      float2 v = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      if constexpr (is_bf16<E>()) {
        const float2 t = unpack_bf16x2(t_kept[j][half]);
        v = make_float2(fit<E>(t.x + fit<E>(v.x)), fit<E>(t.y + fit<E>(v.y)));
      }
      store2(row + ln.n0 + j * 8 + 2 * ln.t, v);
    }
  }
}

template <typename E>
using StackKernelT = void (*)(StackArgsT<E>, int, int);
typedef StackKernelT<float> StackKernel;

#define FVT_MMA_STACK_KERNEL(name)                                              \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::StackArgs a, int T, int tile_rows) {                            \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::stack_body<C, WM, ST, float>(a, T, tile_rows, smem);               \
  }

#define FVT_MMA_BF16_STACK_KERNEL(name)                                         \
  template <int C, int WM, int ST, int SLAB>                                    \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::StackArgsT<fvt_mma::bf16> a, int T, int tile_rows) {            \
    extern __shared__ __align__(16) unsigned char smem_raw[];                  \
    fvt_mma::stack_body<C, WM, ST, fvt_mma::bf16, false, SLAB>(                 \
        a, T, tile_rows, reinterpret_cast<fvt_mma::bf16*>(smem_raw));           \
  }

#define FVT_MMA_W16_STACK_KERNEL(name)                                          \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::StackArgs a, int T, int tile_rows) {                            \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::stack_body<C, WM, ST, float, true>(a, T, tile_rows, smem);         \
  }

// One launch of `kernel` (a FVT_MMA_STACK_KERNEL or FVT_MMA_BF16_STACK_KERNEL
// at C, WM, ST) with `a` over (B, T, C).
template <int C, int WM, int ST, typename E, int SLAB = 0>
cudaError_t launch_stack(StackKernelT<E> kernel, const StackArgsT<E>& a, int B, int T,
                         cudaStream_t stream) {
  constexpr int R = 64 * WM;
  if (a.K < 1 || a.K % 2 == 0 || a.dil < 1) return cudaErrorInvalidValue;
  // conv_d reads up to row R - 1 + 2 m of the tile
  const int tile_rows = tile_rows_of<C, E>(R + 2 * ((a.K - 1) / 2 * a.dil));
  const int smem = body_smem<C, E, ST, SLAB>(tile_rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B);
  kernel<<<grid, block_threads<C, WM>(), smem, stream>>>(a, T, tile_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// one conv with an epilogue, forwards or as its own adjoint
// ---------------------------------------------------------------------------

// Up to kMaxZ convs of one launch.  For conv z and every row r in [0, T):
//
//   s      = bias + sum_k in(r + sign (k - half) dil) W[k]
//   s      = leaky(s, out_slope)
//   s     *= sgn[r] >= 0 ? 1 : sgn_slope          (where sgn is given)
//   s     += src2[r] W2                           (where src2 is given)
//   s     += edge[0][m - r]   (1 <= r <= m)       (conv 0, where edge is given)
//   s     += edge[1][T - 2 - r]   (T - 1 - m <= r <= T - 2)
//   dst[r] = s + res[r]                           (where res is given)
//
// in(g) = leaky(src[g], in_slope) inside [0, T), zero outside.  sign is +1
// for a forward conv and -1 with `flip`, the adjoint, whose W is the forward
// weight with its two channel axes swapped.  Every W is packed from
// (taps, C, C): produced channel, then contracted channel; W2 has one tap.
// edge (B, 2, m, C), m = (K[0] - 1) / 2 dil[0]: the reflect pad's folds of
// conv 0 (`fold_body`).  `bf16` (W16 only): which of src, src2, sgn, dst
// hold bf16 (kBf16Src, ...), the same for every conv.
struct ConvArgs {
  const float* src[kMaxZ];
  const float* w[kMaxZ];
  const float* bias[kMaxZ];  // (C,) or null
  const float* sgn[kMaxZ];   // (B, T, C) or null
  const float* src2[kMaxZ];  // (B, T, C) or null
  const float* w2[kMaxZ];    // packed (1, C, C), with src2
  const float* res[kMaxZ];   // (B, T, C) or null
  float* dst[kMaxZ];
  float* edge;               // conv 0's folds: written by a fold launch, read by a conv launch
  int K[kMaxZ];
  int dil[kMaxZ];
  float in_slope;   // 1 = no activation
  float out_slope;  // 1 = no activation
  float sgn_slope;
  int flip;
  int bf16;
};

inline void clear(ConvArgs& a) {
  for (int z = 0; z < kMaxZ; ++z) {
    a.src[z] = a.w[z] = a.bias[z] = a.sgn[z] = a.src2[z] = a.w2[z] = a.res[z] = nullptr;
    a.dst[z] = nullptr;
    a.K[z] = 1;
    a.dil[z] = 1;
  }
  a.edge = nullptr;
  a.in_slope = a.out_slope = a.sgn_slope = 1.0f;
  a.flip = 0;
  a.bf16 = 0;
}

// acc = leaky(acc, out_slope) * (sgn >= 0 ? 1 : sgn_slope) on the lane's two
// rows, which are rows gr[0] and gr[1] of the sequence at `base` (-1: none);
// sgn holds bf16 where b16
template <int C, int WM>
__device__ __forceinline__ void mask_rows(float (&acc)[Geo<C>::kNT][4], const int (&gr)[2],
                                          const float* sgn, float sgn_slope, float out_slope,
                                          size_t base, const Lane<C, WM>& ln, bool b16 = false) {
  const bool act = out_slope != 1.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (gr[half] < 0) continue;
    const size_t row = base + static_cast<size_t>(gr[half]) * C;
#pragma unroll
    for (int j = 0; j < Geo<C>::kNT; ++j) {
      float& x = acc[j][2 * half];
      float& y = acc[j][2 * half + 1];
      if (act) {
        x = leaky(x, out_slope);
        y = leaky(y, out_slope);
      }
      if (sgn != nullptr) {
        const float2 s = load2_at(sgn, row + ln.n0 + j * 8 + 2 * ln.t, b16);
        x *= s.x >= 0.0f ? 1.0f : sgn_slope;
        y *= s.y >= 0.0f ? 1.0f : sgn_slope;
      }
    }
  }
}

// Block x owns rows [x R, x R + R) of sequence blockIdx.y, R = 64 WM.
// Shared memory: R + 2 max m staged rows, then the weight ring.  With src2
// its R rows are staged over the tile once the conv has read it.  The body
// of each library's conv kernel (`FVT_MMA_CONV_KERNEL`,
// `FVT_MMA_W16_CONV_KERNEL`).
template <int C, int WM, int ST, bool W16 = false>
__device__ __forceinline__ void conv_body(const ConvArgs& a, int T, int tile_rows, float* smem) {
  using G = Geo<C>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int R = 64 * WM;
  const Lane<C, WM> ln;
  const int z = gridDim.z - 1 - blockIdx.z, b = blockIdx.y;  // see launch_pair
  const int q0 = blockIdx.x * R;
  const int no = min(R, T - q0);
  const int K = a.K[z], d = a.dil[z];
  const int m = (K - 1) / 2 * d;
  const size_t base = static_cast<size_t>(b) * T * C;
  const int f = W16 ? a.bf16 : 0;
  float* tile = smem;
  float* ring = smem + tile_rows * G::kSA;
  float acc[G::kNT][4];

  stage_rows<C, THREADS>(tile, elem(a.src[z], base, f & kBf16Src), T, q0 - m, no + 2 * m,
                         a.in_slope, false, f & kBf16Src);
  const bool active = ln.group_m * 64 < no;
  init_acc<C, WM>(acc, a.bias[z], ln);
  // forwards row i reads staged rows i + k d; the adjoint i + (K - 1 - k) d
  conv_core<C, WM, ST, float, W16>(acc, tile, a.flip ? (K - 1) * d : 0, a.flip ? -d : d, a.w[z],
                                   K, ring, ln, active);
  int gr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.row0 + ln.g + 8 * half;
    gr[half] = r < no ? q0 + r : -1;
  }
  // a bf16 operand's flag is passed as a constant at each call of an
  // inlined helper, so that no element of the epilogue tests it
  if (active) {
    if (f & kBf16Sgn) {
      mask_rows<C, WM>(acc, gr, a.sgn[z], a.sgn_slope, a.out_slope, base, ln, true);
    } else {
      mask_rows<C, WM>(acc, gr, a.sgn[z], a.sgn_slope, a.out_slope, base, ln, false);
    }
  }
  if (a.src2[z] != nullptr) {
    __syncthreads();  // the tile is read no more: src2's rows take its place
    stage_rows<C, THREADS>(tile, elem(a.src2[z], base, f & kBf16Src2), T, q0, no, 1.0f, false,
                           f & kBf16Src2);
    conv_core<C, WM, ST, float, W16>(acc, tile, 0, 1, a.w2[z], 1, ring, ln, active);
  }
  if (!active) return;

  const float* res = a.res[z];
  const float* edge = z == 0 && m > 0 ? a.edge : nullptr;
  auto store = [&](auto dst_bf16) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (gr[half] < 0) continue;
      const size_t row = base + static_cast<size_t>(gr[half]) * C;
      // the row's folds from the edges (edge[side][i], 0 <= i < m), or null
      const float* folds[2] = {nullptr, nullptr};
      if (edge != nullptr) {
        const int i[2] = {m - gr[half], T - 2 - gr[half]};
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (i[side] >= 0 && i[side] < m) {
            folds[side] = edge + ((static_cast<size_t>(b) * 2 + side) * m + i[side]) * C;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        const int col = ln.n0 + j * 8 + 2 * ln.t;
        float2 v = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        // the left edge's fold, then the right's
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (folds[side] != nullptr) {
            const float2 e = __ldg(reinterpret_cast<const float2*>(folds[side] + col));
            v.x += e.x;
            v.y += e.y;
          }
        }
        if (res != nullptr) {
          const float2 h = __ldg(reinterpret_cast<const float2*>(res + row + col));
          v.x += h.x;
          v.y += h.y;
        }
        store2_at(a.dst[z], row + col, v, decltype(dst_bf16)::value);
      }
    }
  };
  if (f & kBf16Dst) {
    store(std::true_type{});
  } else {
    store(std::false_type{});
  }
}

typedef void (*ConvKernel)(ConvArgs, int, int);

#define FVT_MMA_CONV_KERNEL(name)                                               \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::ConvArgs a, int T, int tile_rows) {                             \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::conv_body<C, WM, ST>(a, T, tile_rows, smem);                       \
  }

#define FVT_MMA_W16_CONV_KERNEL(name)                                           \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::ConvArgs a, int T, int tile_rows) {                             \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::conv_body<C, WM, ST, true>(a, T, tile_rows, smem);                 \
  }

// shared memory of a launch of the convs of `a` whose tile has `rows` rows
template <int C, int ST>
inline int conv_smem(int rows) {
  return static_cast<int>(sizeof(float)) * (rows * Geo<C>::kSA + ST * Geo<C>::kSlabElems);
}

// the largest margin of nz convs of `a`, -1 for a conv no launch takes
inline int max_margin(const ConvArgs& a, int nz) {
  int max_m = 0;
  for (int z = 0; z < nz; ++z) {
    if (a.K[z] < 1 || a.K[z] % 2 == 0 || a.dil[z] < 1) return -1;
    const int m = (a.K[z] - 1) / 2 * a.dil[z];
    max_m = max_m > m ? max_m : m;
  }
  return max_m;
}

// One launch of `kernel` (a FVT_MMA_CONV_KERNEL or FVT_MMA_W16_CONV_KERNEL at
// C, WM, ST) with nz convs of `a` over (B, T, C).
template <int C, int WM, int ST>
cudaError_t launch_conv(ConvKernel kernel, const ConvArgs& a, int nz, int B, int T,
                        cudaStream_t stream) {
  constexpr int R = 64 * WM;
  const int max_m = max_margin(a, nz);
  if (max_m < 0) return cudaErrorInvalidValue;
  const int tile_rows = R + 2 * max_m;
  const int smem = conv_smem<C, ST>(tile_rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + R - 1) / R, B, nz);
  kernel<<<grid, block_threads<C, WM>(), smem, stream>>>(a, T, tile_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the adjoint of a reflect pad
// ---------------------------------------------------------------------------

// Before the adjoint of a conv of a reflect-padded input (conv 0 of `a`,
// flip set, m = (K - 1) / 2 dil <= T - 1): the padded position -j
// (1 <= j <= m) was a copy of row j, and position 2 (T - 1) - j of row j
// (T - 1 - m <= j <= T - 2).  The adjoint conv evaluated at those positions
// flows back onto the rows they were copied from:
//
//   edge[0][m - j]     = (sum_k in(-j + (half - k) dil) W[k]) * (sgn[j] >= 0 ? 1 : sgn_slope)
//   edge[1][T - 2 - j] = the same at position 2 (T - 1) - j
//
// which the conv launch of the same arguments adds to its rows, the left
// edge's first (the mask distributes over the sum).  Two blocks a sequence,
// an edge each, R rows at a time.  Along each edge the positions rise with
// the block's rows (left: row i at p = i - m; right: p = T + i), so a pass is
// the conv pass's own over shifted rows.  The body of each library's fold
// kernel (`FVT_MMA_FOLD_KERNEL`, `FVT_MMA_W16_FOLD_KERNEL`).
template <int C, int WM, int ST, bool W16 = false>
__device__ __forceinline__ void fold_body(const ConvArgs& a, int T, int tile_rows, float* smem) {
  using G = Geo<C>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int R = 64 * WM;
  const Lane<C, WM> ln;
  const int K = a.K[0], d = a.dil[0];
  const int m = (K - 1) / 2 * d;
  const int side = blockIdx.x, b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * T * C;
  const int f = W16 ? a.bf16 : 0;
  float* tile = smem;
  float* ring = smem + tile_rows * G::kSA;
  float acc[G::kNT][4];
  for (int c0 = 0; c0 < m; c0 += R) {
    const int nv = min(R, m - c0);
    const int p0 = side == 0 ? c0 - m : T + c0;
    __syncthreads();  // every warp is done with the tile
    stage_rows<C, THREADS>(tile, elem(a.src[0], base, f & kBf16Src), T, p0 - m, nv + 2 * m,
                           a.in_slope, false, f & kBf16Src);
    const bool active = ln.group_m * 64 < nv;
    init_acc<C, WM>(acc, nullptr, ln);
    conv_core<C, WM, ST, float, W16>(acc, tile, (K - 1) * d, -d, a.w[0], K, ring, ln, active);
    if (!active) continue;
    int gr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row0 + ln.g + 8 * half, i = c0 + r;
      gr[half] = r < nv ? (side == 0 ? m - i : T - 2 - i) : -1;
    }
    if (f & kBf16Sgn) {
      mask_rows<C, WM>(acc, gr, a.sgn[0], a.sgn_slope, 1.0f, base, ln, true);
    } else {
      mask_rows<C, WM>(acc, gr, a.sgn[0], a.sgn_slope, 1.0f, base, ln, false);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (gr[half] < 0) continue;
      float* row = a.edge + ((static_cast<size_t>(b) * 2 + side) * m + c0 + ln.row0 + ln.g +
                             8 * half) * C;
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
        *reinterpret_cast<float2*>(row + ln.n0 + j * 8 + 2 * ln.t) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      }
    }
  }
}

#define FVT_MMA_FOLD_KERNEL(name)                                               \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::ConvArgs a, int T, int tile_rows) {                             \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::fold_body<C, WM, ST>(a, T, tile_rows, smem);                       \
  }

#define FVT_MMA_W16_FOLD_KERNEL(name)                                           \
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::ConvArgs a, int T, int tile_rows) {                             \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::fold_body<C, WM, ST, true>(a, T, tile_rows, smem);                 \
  }

// floats of the folds of a launch over B sequences whose conv 0 has margin m
inline size_t edge_floats(int B, int C, int m) { return static_cast<size_t>(B) * 2 * m * C; }

// One launch of `kernel` (a FVT_MMA_FOLD_KERNEL or FVT_MMA_W16_FOLD_KERNEL
// at C, WM, ST) for conv 0 of `a` over B sequences of T rows, into a.edge
// (`edge_floats`); nothing to do without a margin.
template <int C, int WM, int ST>
cudaError_t launch_fold(ConvKernel kernel, const ConvArgs& a, int B, int T,
                        cudaStream_t stream) {
  const int m = max_margin(a, 1);
  if (m < 0 || m > T - 1 || !a.flip || (m > 0 && a.edge == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const int tile_rows = 64 * WM + 2 * m;
  const int smem = conv_smem<C, ST>(tile_rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(2, B), block_threads<C, WM>(), smem, stream>>>(a, T, tile_rows);
  return cudaGetLastError();
}

// The block of a launch at width C: (WM, ST) = warpgroups over the rows,
// slabs of the weight ring.  Measured on an H100 at 700 W, forward stage of
// 3 branches x 3 pairs, against 4 warpgroups over the rows where the grid
// has four waves of them, 3 slabs and 16-channel units at C = 128: 2.04
// against 2.27 ms at (32, 1120, 128), 2.30 against 2.53 at (32, 5600, 64),
// 2.63 against 2.97 at (32, 16800, 32), 2.31 against 3.03 at (32, 33600, 16);
// one warpgroup a block at batch 1 changed nothing (0.45 against 0.47 ms at
// (1, 4680, 128)).
template <int C>
struct Tile {
  static constexpr int kWM = C >= 256 ? 1 : 2, kST = 2;
};

// the block of a form's pair launches: Tile, or TileBf16Pair for the bf16 forms
template <int C, typename E>
struct PairTile : Tile<C> {
  static constexpr int kSlabBytes = 0;
};
template <int C>
struct PairTile<C, bf16> : TileBf16Pair<C> {};

// `name`: a FVT_MMA_PAIR_KERNEL or a FVT_MMA_W16_PAIR_KERNEL
#define FVT_MMA_LAUNCH_PAIR(name, C, a, nz, B, T, stream)                    \
  fvt_mma::launch_pair<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>(     \
      name<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>, a, nz, B, T, stream)

// `name`: a FVT_MMA_STACK_KERNEL or a FVT_MMA_W16_STACK_KERNEL
#define FVT_MMA_LAUNCH_STACK(name, C, a, B, T, stream)                       \
  fvt_mma::launch_stack<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>(    \
      name<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>, a, B, T, stream)

// `name`: a FVT_MMA_BF16_STACK_KERNEL
#define FVT_MMA_LAUNCH_BF16_STACK(name, C, a, B, T, stream)                              \
  fvt_mma::launch_stack<C, fvt_mma::TileBf16Stack<C>::kWM, fvt_mma::TileBf16Stack<C>::kST,  \
                        fvt_mma::bf16, fvt_mma::TileBf16Stack<C>::kSlabBytes>(             \
      name<C, fvt_mma::TileBf16Stack<C>::kWM, fvt_mma::TileBf16Stack<C>::kST,              \
           fvt_mma::TileBf16Stack<C>::kSlabBytes>,                                         \
      a, B, T, stream)

// `name`: a FVT_MMA_CONV_KERNEL
#define FVT_MMA_LAUNCH_CONV(name, C, a, nz, B, T, stream)                    \
  fvt_mma::launch_conv<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>(     \
      name<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>, a, nz, B, T, stream)

// `name`: a FVT_MMA_FOLD_KERNEL
#define FVT_MMA_LAUNCH_FOLD(name, C, a, B, T, stream)                        \
  fvt_mma::launch_fold<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>(     \
      name<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>, a, B, T, stream)

// ---------------------------------------------------------------------------
// the weight gradient
// ---------------------------------------------------------------------------

// A weight gradient is a split-K GEMM, dW[k] = in_k^T dy with M = c_in,
// N = c_out and the B T rows as depth, on wgmma: a block stages a chunk of
// rows of `in` row-major (rows padded by 8, so that the transposed A
// fragment, read into registers, meets 32 different banks; the activation is
// applied as a fragment is read), and of dy, which it then transposes and
// splits into TF32 halves in shared memory, as the K-major B operand.  The
// next chunk's rows are on their way (`cp.async`; `in` in two stages, dy in
// one, free once transposed) while the block multiplies the current one;
// each warpgroup owns the accumulators of one 64-row group of dW (several
// taps x c_in below C = 64, so that no thread idles) across all the block's
// chunks.  A block's two groups share their output channels: at C = 256
// (two 128-channel halves of the output, four 64-row blocks of the input)
// it stages the 128 channels of `in` and of dy that they read, and takes 64
// rows a chunk, as at C = 128 (32 when it staged all 256 of both: 174 KB).
// Where a conv has fewer groups than a block has warpgroups they share one
// and split each chunk's rows, and add their sums through shared memory in a
// fixed order.  The sum over blocks is taken in two stages (partials per
// block, then `fvt_bwd::wgrad_reduce_kernel` in a fixed order): no atomics,
// the same bits from run to run.  db rides along in the blocks that hold
// the first 64-row block of a conv's first tap.

constexpr int kWgradThreads = fvt_bwd::kThreads;
constexpr int kGroupsPerBlock = kWgradThreads / 128;  // warpgroups of a block

// A warpgroup's group of dW: 64 rows (kTaps taps x C input channels below
// C = 64, 64 input channels of one tap from there) x kNW output channels.
// Group r of a tap group is its output half r / kBlocksM, its input block
// r % kBlocksM.  kRows rows a chunk.
template <int C>
struct WGeo {
  static constexpr int kNW = C < 128 ? C : 128;
  static constexpr int kGroupsN = C / kNW;
  static constexpr int kNT = kNW / 8;
  static constexpr int kTaps = C >= 64 ? 1 : 64 / C;
  static constexpr int kBlocksM = C >= 64 ? C / 64 : 1;
  static constexpr int kGroupsPerTapGroup = kBlocksM * kGroupsN;
  static constexpr int kAcc = kNT * 4;  // accumulators a thread
  static constexpr int kInW = C < 128 ? C : 128;  // channels of `in` a block stages
  static constexpr int kDyW = kNW;                // and of dy
  static constexpr int kRows = C <= 16 ? 256 : (C <= 32 ? 128 : 64);
  // C >= 128: a depth step in flight while the next is read, and two sets
  // of partial sums, so that the next unit is issued before a unit's sum is
  // added; narrower, a unit at a time (in flight, units measured slower:
  // PERF.md section 6)
  static constexpr bool kPipe = C >= 128;
  static constexpr int kS = kInW + 8;  // elements a staged row of `in`
  // dy is staged as the K-major B operand: hi and lo halves of core matrices
  // [kRows / 4][kDyW / 8][8 channels][4 rows], kCore floats apart (32 and 4
  // of padding, so that the staging's 16-byte stores fall into different
  // banks)
  static constexpr int kCore = 36;
  static constexpr int kDyHalf = kRows / 4 * (kDyW / 8) * kCore;
  static constexpr uint32_t kStrideK = kDyW / 8 * kCore * 4;  // bytes, along the rows
  static constexpr uint32_t kStrideN = kCore * 4;             // bytes, along the channels
};

template <int C>
__host__ __device__ inline int wgrad_groups(int K) {
  return (K + WGeo<C>::kTaps - 1) / WGeo<C>::kTaps * WGeo<C>::kGroupsPerTapGroup;
}

// For conv z of `w` (fvt_bwd::WgradArgs: dW[k][ci][co] = sum in_z(r + (k -
// half) dil)[ci] dy[r][co], db = sum dy; in_z = leaky(a, slope), zero
// outside [0, T) or, with `reflect`, the mirrored rows): block (x, y) holds
// the groups [2 x, 2 x + 2) of dW, sums over the row chunks y, y + S, ...
// and writes partial y.  in_rows: the rows of `in` a chunk stages,
// `wgrad_in_rows`.  The product is in^T dy on wgmma: A = in^T from
// registers (a lane reads its (channel, row) elements from the row-major
// staged tile), B = dy from shared memory, split into TF32 halves when it is
// staged; the products of 32 rows (a unit: four depth steps of 8) are summed
// in the tensor core from zero and added to the accumulators on the CUDA
// cores (`conv_core`).  Each depth step is a commit group, waited on once
// the next is issued: its fragment is read and split while the tensor cores
// multiply, and two register sets of partial sums take turns so that the
// next unit is issued before a unit's sum is added.  W16: `in` or dy may
// hold bf16 (fvt_bwd::kBf16In, kBf16Dy), staged as bf16 and widened as a
// fragment is read or dy is transposed.  The body of each library's
// weight-gradient kernel (`FVT_MMA_WGRAD_KERNEL`, `FVT_MMA_W16_WGRAD_KERNEL`).
template <int C, bool W16 = false>
__device__ __forceinline__ void wgrad_body(const fvt_bwd::WgradArgs& w, int B, int T, int in_rows,
                                           float* smem) {
  using G = WGeo<C>;
  constexpr int RC = G::kRows;
  const int z = gridDim.z - 1 - blockIdx.z;  // the longest blocks first (launch_pair)
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
  const int m_block = group % G::kGroupsPerTapGroup % G::kBlocksM;
  const int n0 = group % G::kGroupsPerTapGroup / G::kBlocksM * G::kNW;
  // the channels of `in` and dy the block stages
  const int r_first = g_first % G::kGroupsPerTapGroup;
  const int in_c0 = C >= 64 ? r_first % G::kBlocksM * 64 : 0;
  const int dy_c0 = r_first / G::kBlocksM * G::kNW;
  // the lane's rows of dW: m = 16 w4 + g and m + 8, (tap, channel) = (m / C, m % C)
  const int tap_l = C >= 64 ? 0 : 16 * w4 / C;
  const int ci0 = (C >= 64 ? m_block * 64 + 16 * w4 : 16 * w4 % C) + g;
  // the taps the block's groups reach, and the rows of `in` they read
  const int k_lo = g_first / G::kGroupsPerTapGroup * G::kTaps;
  const int k_hi = min(K, (g_first + here - 1) / G::kGroupsPerTapGroup * G::kTaps + G::kTaps) - 1;
  const int lo = (k_lo - half_k) * d, span = (k_hi - k_lo) * d;
  const int k_mine = min(k_first + tap_l, K - 1);
  const bool in16 = W16 && (w.bf16[z] & fvt_bwd::kBf16In) != 0;
  const bool dy16 = W16 && (w.bf16[z] & fvt_bwd::kBf16Dy) != 0;

  // two stages of in_rows rows of `in`, one of RC rows of dy, then dy split
  float* as = smem;
  float* dyr = smem + 2 * in_rows * G::kS;
  float* dyh = dyr + RC * G::kDyW;  // dy's hi half, then its lo half
  const int chunks_per_seq = (T + RC - 1) / RC;
  const int n_chunks = B * chunks_per_seq;
  const float slope = w.slope[z];
  const bool mirror = w.reflect[z] != 0;
  const bool sums_bias = g_first < G::kGroupsPerTapGroup && r_first % G::kBlocksM == 0;

  // chunk c's rows, asynchronously: `in` from row r0 + lo (mirrored, or
  // zeros outside [0, T)) into stage st, dy from row r0 (zeros past T); a
  // bf16 operand as bf16, in the same rows (16-byte copies of 8 elements)
  auto load_in = [&](auto in_bf16, int c, int st) {
    using S = std::conditional_t<decltype(in_bf16)::value, bf16, float>;
    constexpr int CI = G::kInW * static_cast<int>(sizeof(S)) / 16;  // copies a row
    const int b = c / chunks_per_seq;
    const int r0 = (c % chunks_per_seq) * RC;
    const S* src = reinterpret_cast<const S*>(w.a[z]) + static_cast<size_t>(b) * T * C + in_c0;
    S* at = reinterpret_cast<S*>(as + st * in_rows * G::kS);
    for (int i = threadIdx.x; i < in_rows * CI; i += kWgradThreads) {
      const int row = i / CI, cv = i % CI;
      int gr = r0 + lo + row;
      bool ok = true;
      if (mirror) {
        gr = reflect_index(gr, T);
      } else if (gr < 0 || gr >= T) {
        ok = false;
        gr = 0;
      }
      cp_async16_zfill(at + row * G::kS + 16 / sizeof(S) * cv,
                       src + static_cast<size_t>(gr) * C + 16 / sizeof(S) * cv, ok);
    }
  };
  auto load_dy = [&](auto dy_bf16, int c) {
    using S = std::conditional_t<decltype(dy_bf16)::value, bf16, float>;
    constexpr int CD = G::kDyW * static_cast<int>(sizeof(S)) / 16;
    const int b = c / chunks_per_seq;
    const int r0 = (c % chunks_per_seq) * RC;
    const S* dy = reinterpret_cast<const S*>(w.dy[z]) + static_cast<size_t>(b) * T * C + dy_c0;
    S* at = reinterpret_cast<S*>(dyr);
    for (int i = threadIdx.x; i < RC * CD; i += kWgradThreads) {
      const int row = i / CD, cv = i % CD;
      const bool ok = r0 + row < T;
      cp_async16_zfill(at + row * G::kDyW + 16 / sizeof(S) * cv,
                       dy + static_cast<size_t>(ok ? r0 + row : 0) * C + 16 / sizeof(S) * cv, ok);
    }
  };
  auto load = [&](int c, int st) {
    if constexpr (W16) {
      if (in16) {
        load_in(std::true_type{}, c, st);
      } else {
        load_in(std::false_type{}, c, st);
      }
      if (dy16) {
        load_dy(std::true_type{}, c);
      } else {
        load_dy(std::false_type{}, c);
      }
    } else {
      load_in(std::false_type{}, c, st);
      load_dy(std::false_type{}, c);
    }
    cp_async_commit();
  };

  float acc[G::kNT][4], p0[G::kNT][4], p1[G::kNT][4];
#pragma unroll
  for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = p0[j][e] = p1[j][e] = 0.0f;
  }
  uint32_t ah[4][4], al[4][4];  // a unit's fragments, a set a depth step (kPipe: two in turn)
  constexpr int C4 = G::kDyW / 4;
  float4 bsum = make_float4(0.f, 0.f, 0.f, 0.f);  // of channels 4 (tid % C4) ..

  load(blockIdx.y, 0);  // S <= the chunks: every block has one
  int it = 0;
  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y, ++it) {
    const int st = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the block is done with dyh
    const int rn = min(RC, T - (c % chunks_per_seq) * RC);
    // dy: a thread takes 4 rows of 4 channels and stores, per channel, the
    // 4 rows side by side: the transpose the K-major operand wants
    auto transpose = [&](auto dy_bf16) {
      for (int i = threadIdx.x; i < RC / 4 * C4; i += kWgradThreads) {
        const int rq = i / C4, c4 = i % C4;
        float v[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e0 = (4 * rq + r) * G::kDyW + 4 * c4;
          float4 x;
          if constexpr (decltype(dy_bf16)::value) {
            const uint2 u =
                *reinterpret_cast<const uint2*>(reinterpret_cast<const bf16*>(dyr) + e0);
            const float2 x0 = unpack_bf16x2(u.x), x1 = unpack_bf16x2(u.y);
            x = make_float4(x0.x, x0.y, x1.x, x1.y);
          } else {
            x = *reinterpret_cast<const float4*>(dyr + e0);
          }
          v[r][0] = x.x, v[r][1] = x.y, v[r][2] = x.z, v[r][3] = x.w;
          if (sums_bias) {
            bsum = make_float4(bsum.x + x.x, bsum.y + x.y, bsum.z + x.z, bsum.w + x.w);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = 4 * c4 + e;
          uint32_t hi[4], lo4[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) split_tf32(v[r][e], hi[r], lo4[r]);
          float* at = dyh + (rq * (G::kDyW / 8) + co / 8) * G::kCore + co % 8 * 4;
          *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(at + G::kDyHalf) = make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
        }
      }
    };
    if constexpr (W16) {
      if (dy16) {
        transpose(std::true_type{});
      } else {
        transpose(std::false_type{});
      }
    } else {
      transpose(std::false_type{});
    }
    fence_smem_for_wgmma();
    __syncthreads();  // dyh is ready; dy's rows and the other stage are free
    if (c + static_cast<int>(gridDim.y) < n_chunks) load(c + gridDim.y, st ^ 1);
    // unit q covers rows 32 q .. 32 q + 31 of the chunk: 4 depth steps
    const float* a32 = as + st * in_rows * G::kS;
    // tap k reads `in` row r + (k - half) d: staged row r + (k - k_lo) d
    const int i_lane = (t + (k_mine - k_lo) * d) * G::kS + ci0 - in_c0;
    auto products = [&](auto in_bf16) {
      auto in_at = [&](int i) -> float {
        if constexpr (decltype(in_bf16)::value) {
          return leaky(__bfloat162float(reinterpret_cast<const bf16*>(a32)[i]), slope);
        } else {
          return leaky(a32[i], slope);
        }
      };
      // depth step ks of unit q into p, its fragment through (fh, fl): one
      // commit group
      auto step = [&](float (&p)[G::kNT][4], uint32_t (&fh)[4], uint32_t (&fl)[4], int q,
                      int ks) {
        const int i = i_lane + (q * 32 + ks * 8) * G::kS;
        split_tf32(in_at(i), fh[0], fl[0]);
        split_tf32(in_at(i + 8), fh[1], fl[1]);
        split_tf32(in_at(i + 4 * G::kS), fh[2], fl[2]);
        split_tf32(in_at(i + 4 * G::kS + 8), fh[3], fl[3]);
        wgmma_fence();
        const float* hi = dyh + ((q * 8 + 2 * ks) * (G::kDyW / 8) + (n0 - dy_c0) / 8) * G::kCore;
        const uint64_t d_hi = wgmma_desc(hi, G::kStrideK, G::kStrideN);
        const uint64_t d_lo = wgmma_desc(hi + G::kDyHalf, G::kStrideK, G::kStrideN);
        Wgmma<G::kNW>::run(p, fl, d_hi, ks > 0);
        Wgmma<G::kNW>::run(p, fh, d_lo, 1);
        Wgmma<G::kNW>::run(p, fh, d_hi, 1);
        wgmma_commit();
      };
      // unit q (four depth steps) into p, its fragment through (fh, fl): one
      // commit group
      auto unit = [&](float (&p)[G::kNT][4], uint32_t (&fh)[4][4], uint32_t (&fl)[4][4],
                      int q) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int i = i_lane + (q * 32 + ks * 8) * G::kS;
          split_tf32(in_at(i), fh[ks][0], fl[ks][0]);
          split_tf32(in_at(i + 8), fh[ks][1], fl[ks][1]);
          split_tf32(in_at(i + 4 * G::kS), fh[ks][2], fl[ks][2]);
          split_tf32(in_at(i + 4 * G::kS + 8), fh[ks][3], fl[ks][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const float* hi =
              dyh + ((q * 8 + 2 * ks) * (G::kDyW / 8) + (n0 - dy_c0) / 8) * G::kCore;
          const uint64_t d_hi = wgmma_desc(hi, G::kStrideK, G::kStrideN);
          const uint64_t d_lo = wgmma_desc(hi + G::kDyHalf, G::kStrideK, G::kStrideN);
          Wgmma<G::kNW>::run(p, fl[ks], d_hi, ks > 0);
          Wgmma<G::kNW>::run(p, fh[ks], d_lo, 1);
          Wgmma<G::kNW>::run(p, fh[ks], d_hi, 1);
        }
        wgmma_commit();
      };
      if constexpr (!G::kPipe) {
        for (int q = split; q * 32 < rn; q += splits) {
          unit(p0, ah, al, q);
          wgmma_wait_all();
          add_partial(acc, p0);
        }
        return;
      }
      // units q, q + splits, ... of the chunk, two at a time: p0, then p1
      for (int q = split; q * 32 < rn; q += 2 * splits) {
        const int q1 = q + splits;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          step(p0, ah[ks & 1], al[ks & 1], q, ks);
          wgmma_wait<1>();  // step ks - 1 is done, and with step 0 the unit before
          if (ks == 0 && q != split) {
            fence_regs(p1);
            add_partial(acc, p1);
          }
        }
        if (q1 * 32 >= rn) {
          wgmma_wait<0>();
          fence_regs(p0);
          add_partial(acc, p0);
          return;
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          step(p1, ah[ks & 1], al[ks & 1], q1, ks);
          wgmma_wait<1>();
          if (ks == 0) {
            fence_regs(p0);
            add_partial(acc, p0);
          }
        }
        if ((q1 + splits) * 32 >= rn) {
          wgmma_wait<0>();
          fence_regs(p1);
          add_partial(acc, p1);
        }
      }
    };
    if constexpr (W16) {
      if (in16) {
        products(std::true_type{});
      } else {
        products(std::false_type{});
      }
    } else {
      products(std::false_type{});
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // shared memory is free for the sums below

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
    // thread t summed channels 4 (t % C4) ..: kWgradThreads / C4 threads a channel
    *reinterpret_cast<float4*>(red + 4 * threadIdx.x) = bsum;
    __syncthreads();
    if (threadIdx.x < G::kDyW) {
      const int c4 = threadIdx.x / 4, e = threadIdx.x % 4;
      float s = 0.0f;
      for (int i = c4; i < kWgradThreads; i += C4) s += red[4 * i + e];
      part[nw + dy_c0 + threadIdx.x] = s;
    }
  }
}

typedef void (*WgradKernel)(fvt_bwd::WgradArgs, int, int, int);

// two blocks an SM where shared memory holds two (C <= 64): at most 128
// registers a thread
template <int C>
__host__ __device__ constexpr int wgrad_min_blocks() {
  return C <= 64 ? 2 : 1;
}

#define FVT_MMA_WGRAD_KERNEL(name)                                              \
  template <int C>                                                              \
  __global__ void __launch_bounds__(fvt_mma::kWgradThreads,                     \
                                    fvt_mma::wgrad_min_blocks<C>())             \
  name(fvt_bwd::WgradArgs w, int B, int T, int in_rows) {                       \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::wgrad_body<C>(w, B, T, in_rows, smem);                             \
  }

#define FVT_MMA_W16_WGRAD_KERNEL(name)                                          \
  template <int C>                                                              \
  __global__ void __launch_bounds__(fvt_mma::kWgradThreads,                     \
                                    fvt_mma::wgrad_min_blocks<C>())             \
  name(fvt_bwd::WgradArgs w, int B, int T, int in_rows) {                       \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::wgrad_body<C, true>(w, B, T, in_rows, smem);                       \
  }

inline int max_of(const int* v, int n) {
  int m = v[0];
  for (int i = 1; i < n; ++i) m = m > v[i] ? m : v[i];
  return m;
}

// Launch geometry of the weight gradients of one launch: the row splits S
// (enough blocks to fill the card, at most one per chunk of rows).
template <int C>
int wgrad_splits(int B, int T, const int* K, int nz) {
  int blocks = 0;
  for (int z = 0; z < nz; ++z) {
    blocks += (wgrad_groups<C>(K[z]) + kGroupsPerBlock - 1) / kGroupsPerBlock;
  }
  const long long chunks =
      static_cast<long long>(B) * ((T + WGeo<C>::kRows - 1) / WGeo<C>::kRows);
  long long s = (fvt_bwd::kTargetBlocks + blocks - 1) / blocks;
  if (s > chunks) s = chunks;
  if (s > fvt_bwd::kMaxSplits) s = fvt_bwd::kMaxSplits;
  return s < 1 ? 1 : static_cast<int>(s);
}

// floats of partials one launch of nz weight gradients needs
template <int C>
size_t wgrad_floats(int B, int T, const int* K, int nz) {
  return static_cast<size_t>(nz) * wgrad_splits<C>(B, T, K, nz) *
         (static_cast<size_t>(max_of(K, nz)) * C * C + C);
}

// The nz weight gradients of `w` by `kernel` (a FVT_MMA_WGRAD_KERNEL at C);
// w.part[z] are set here from `scratch` (wgrad_floats).
// The rows of `in` a chunk of the launch stages: the chunk's rows and the
// taps' reach of the block that reaches farthest (the taps its groups hold).
template <int C>
int wgrad_in_rows(const fvt_bwd::WgradArgs& w, int nz) {
  using G = WGeo<C>;
  int span = 0;
  for (int z = 0; z < nz; ++z) {
    const int groups = wgrad_groups<C>(w.K[z]);
    for (int g_first = 0; g_first < groups; g_first += kGroupsPerBlock) {
      const int here = groups - g_first < kGroupsPerBlock ? groups - g_first : kGroupsPerBlock;
      const int k_lo = g_first / G::kGroupsPerTapGroup * G::kTaps;
      const int k_end = (g_first + here - 1) / G::kGroupsPerTapGroup * G::kTaps + G::kTaps;
      const int k_hi = (k_end < w.K[z] ? k_end : w.K[z]) - 1;
      span = span > (k_hi - k_lo) * w.dil[z] ? span : (k_hi - k_lo) * w.dil[z];
    }
  }
  return G::kRows + span;
}

// The nz weight gradients of `w` by `kernel` (a FVT_MMA_WGRAD_KERNEL at C);
// w.part[z] are set here from `scratch` (wgrad_floats).
template <int C>
cudaError_t launch_wgrad(WgradKernel kernel, fvt_bwd::WgradArgs& w, int nz, int B, int T,
                         float* scratch, cudaStream_t stream) {
  using G = WGeo<C>;
  int max_x = 0;
  for (int z = 0; z < nz; ++z) {
    if (w.K[z] < 1 || w.K[z] % 2 == 0 || w.dil[z] < 1) return cudaErrorInvalidValue;
    const int x = (wgrad_groups<C>(w.K[z]) + kGroupsPerBlock - 1) / kGroupsPerBlock;
    max_x = max_x > x ? max_x : x;
  }
  const int max_K = max_of(w.K, nz);
  const int S = wgrad_splits<C>(B, T, w.K, nz);
  for (int z = 0; z < nz; ++z) {
    w.part[z] = scratch + static_cast<size_t>(z) * S * (static_cast<size_t>(max_K) * C * C + C);
  }
  // two stages of `in`, one of dy, dy split; reused for the sums the
  // warpgroups of a group exchange
  const int in_rows = wgrad_in_rows<C>(w, nz);
  int floats = 2 * in_rows * G::kS + G::kRows * G::kDyW + 2 * G::kDyHalf;
  const int exchange =
      128 * G::kAcc > 4 * kWgradThreads ? 128 * G::kAcc : 4 * kWgradThreads;
  floats = floats > exchange ? floats : exchange;
  const int smem = static_cast<int>(sizeof(float)) * floats;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(max_x, S, nz), kWgradThreads, smem, stream>>>(w, B, T, in_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = max_K * C * C + C;
  const int blocks = (total + kWgradThreads - 1) / kWgradThreads;
  fvt_bwd::wgrad_reduce_kernel<C>
      <<<dim3(blocks < 256 ? blocks : 256, nz), kWgradThreads, 0, stream>>>(w, S);
  return cudaGetLastError();
}

// `name`: a FVT_MMA_WGRAD_KERNEL
#define FVT_MMA_LAUNCH_WGRAD(name, C, w, nz, B, T, scratch, stream) \
  fvt_mma::launch_wgrad<C>(name<C>, w, nz, B, T, scratch, stream)

}  // namespace fvt_mma
