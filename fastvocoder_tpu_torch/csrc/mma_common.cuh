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
// served with compute_dtype bf16) run the same core on
// wgmma.mma_async.m64nNk16.f32.bf16.bf16: one product a depth step of 16
// where 3xTF32 takes three a step of 8, so their bound is the operation
// count at 989 TFLOP/s.  A lane's A fragment of a step holds the pairs of
// channels (2 t, 2 t + 1) and (2 t + 8, 2 t + 9) of rows g and g + 8, two
// bf16 to a register, low half first (mma.m16n8k16's layout), read straight
// from the bf16 tile; a weight core matrix is 8 produced x 8 contracted
// channels, again 128 contiguous bytes, so the descriptor's strides are the
// TF32 form's.  The forms round to bf16 where the JAX package's Pallas
// bodies round (`fit`): the bias before it is added, every conv's output,
// every leaky-relu, every residual sum; products are summed in float32, a
// weight unit in the tensor core and the units on the CUDA cores as in the
// TF32 forms.  Their kernels have names of their own
// (`FVT_MMA_BF16_*_KERNEL`), so that a profile tells the two forms apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bwd_common.cuh"
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
  static constexpr int kPad = 8, kHalves = 1, kDepth = 16;
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

// d (64 x N) (+)= a (64 x 16, from registers) b (N x 16, K-major in shared
// memory behind `desc`), bf16 operands, float32 sums, one warpgroup;
// asynchronous.  Warp w of the group holds rows 16 w .. 16 w + 15 of a and
// d; there lane l = 4 g + t holds, two bf16 a register (the lower channel in
// the low half), a0 (g, 2 t .. 2 t + 1), a1 (g + 8, 2 t ..), a2 (g,
// 2 t + 8 ..), a3 (g + 8, 2 t + 8 ..), and d as `Wgmma` does.  B is not
// transposed (the last immediate).
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<16> {
  static __device__ __forceinline__ void run(float (&d)[2][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<32> {
  static __device__ __forceinline__ void run(float (&d)[4][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
struct WgmmaBf16<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
// the same copy, or 16 bytes of zeros where `valid` is false (gmem is not read)
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
// waits until at most N of the thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

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

template <int C, typename E = float>
struct Geo {
  static constexpr int kNW = C < 128 ? C : 128;  // channels a warpgroup produces
  static constexpr int kGroupsN = C / kNW;       // warpgroups side by side
  static constexpr int kNT = kNW / 8;            // 8-channel tiles of a warpgroup
  static constexpr int kSA = C + Form<E>::kPad;  // elements a staged row
  // a weight unit: the kKC contracted channels [c kKC, (c + 1) kKC) of one
  // tap for all C produced channels, as kHalves halves (TF32: hi, then lo),
  // each in core matrices of 128 bytes, [kKC / kCK][C / 8][8 produced][kCK
  // contracted], kCK = 16 bytes of E
  static constexpr int kKC = C == 16 || C >= 256 ? 16 : 32;
  static constexpr int kChunks = C / kKC;
  static constexpr int kCK = 16 / static_cast<int>(sizeof(E));
  static constexpr int kCoreElems = 8 * kCK;
  static constexpr int kHalfElems = C * kKC;
  static constexpr int kUnitElems = Form<E>::kHalves * kHalfElems;
  static constexpr int kUnitBytes = kUnitElems * static_cast<int>(sizeof(E));
  static constexpr int kUnitsPerSlab = 18432 / kUnitBytes > 0 ? 18432 / kUnitBytes : 1;
  static constexpr int kSlabElems = kUnitsPerSlab * kUnitElems;
  static constexpr uint32_t kStrideK = C / 8 * 128;  // bytes between core matrices in depth
  static constexpr uint32_t kStrideN = 128;          // and along the produced channels
};

// elements of the packed form of a kernel of K taps (`pack_kernel`)
template <int C, typename E = float>
__host__ __device__ constexpr size_t packed_elems(int K) {
  return static_cast<size_t>(Form<E>::kHalves) * K * C * C;
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
template <int C, int THREADS, typename E>
__device__ __forceinline__ void load_slab(E* stage, const E* __restrict__ W, int K, int s) {
  using G = Geo<C, E>;
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  const int first = s * G::kUnitsPerSlab;
  const int units = min(G::kUnitsPerSlab, K * G::kChunks - first);
  const E* src = W + static_cast<size_t>(first) * G::kUnitElems;
  for (int i = threadIdx.x; i < units * (G::kUnitElems / kVec); i += THREADS) {
    cp_async16(stage + kVec * i, src + kVec * i);
  }
  cp_async_commit();  // a group per call, empty past the last slab
}

// acc[j] += sum_{k < K} sum_c tile[row + off0 + k step][c] W[k][n_j][c] for
// the warpgroup's 64 rows and its channel tiles j, where `active`.  `tile` is
// the staged tile (rows of kSA elements), `off0` and `step` are in rows (step
// may be negative: an adjoint walks the taps backwards); W is the packed
// kernel; `ring` holds ST slabs, of which ST - 1 are in flight ahead of the
// one in use.  Starts with a __syncthreads(): what the block staged before
// the call is visible, and the ring is free.
//
// The tensor core adds into its accumulator with truncation, which over the
// hundreds of steps of a conv drifts by more than float32's rounding
// (measured on the mma.sync version: 1e-5 of a stage's output).  So the
// products of one unit are summed in the tensor core from zero, where a
// truncation is relative to that small partial sum, and the partial sum is
// added to acc on the CUDA cores, rounded to nearest.  The bf16 form keeps
// that order: a unit is one or two wgmmas there, and its sums agree with
// the plain float32 sums of bf16 operands to float32's rounding.
template <int C, int WM, int ST, typename E>
__device__ __forceinline__ void conv_core(float (&acc)[Geo<C>::kNT][4], const E* tile, int off0,
                                          int step, const E* __restrict__ W, int K, E* ring,
                                          const Lane<C, WM>& ln, bool active) {
  using G = Geo<C, E>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int kSteps = G::kKC / Form<E>::kDepth;
  const int n_slabs = (K * G::kChunks + G::kUnitsPerSlab - 1) / G::kUnitsPerSlab;
  // the lane's first element: row g, channel t (TF32) or channels 2 t, 2 t + 1 (bf16)
  const E* a_lane = tile + (ln.row0 + ln.g) * G::kSA + (is_bf16<E>() ? 2 : 1) * ln.t;
  const int b_group = ln.n0 / 8 * G::kCoreElems;  // to the warpgroup's first core matrix

  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load_slab<C, THREADS>(ring + s * G::kSlabElems, W, K, s);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<ST - 2>();
    fence_smem_for_wgmma();
    __syncthreads();  // slab s has landed; every warp is done with slab s - 1
    load_slab<C, THREADS>(ring + (s + ST - 1) % ST * G::kSlabElems, W, K, s + ST - 1);
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
      if constexpr (is_bf16<E>()) {
        uint32_t a[kSteps][4];
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const E* at = ap + ks * 16;
          a[ks][0] = *reinterpret_cast<const uint32_t*>(at);
          a[ks][1] = *reinterpret_cast<const uint32_t*>(at + 8 * G::kSA);
          a[ks][2] = *reinterpret_cast<const uint32_t*>(at + 8);
          a[ks][3] = *reinterpret_cast<const uint32_t*>(at + 8 * G::kSA + 8);
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          // depth step ks: the core matrices 2 ks and 2 ks + 1
          WgmmaBf16<G::kNW>::run(
              p, a[ks], wgmma_desc(hi + 2 * ks * (C / 8) * G::kCoreElems, G::kStrideK, G::kStrideN),
              ks > 0);
        }
      } else {
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
          // depth step ks: the core matrices 2 ks and 2 ks + 1 of each half
          const uint64_t d_hi =
              wgmma_desc(hi + 2 * ks * (C / 8) * G::kCoreElems, G::kStrideK, G::kStrideN);
          const uint64_t d_lo = wgmma_desc(hi + G::kHalfElems + 2 * ks * (C / 8) * G::kCoreElems,
                                           G::kStrideK, G::kStrideN);
          Wgmma<G::kNW>::run(p, a_lo[ks], d_hi, ks > 0);
          Wgmma<G::kNW>::run(p, a_hi[ks], d_lo, 1);
          Wgmma<G::kNW>::run(p, a_hi[ks], d_hi, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
      }
    }
  }
}

// acc[j] = bias[channel] (+ bias2[channel]; zeros without a bias), each
// bias as the form E stores it (rounded to bf16 in the bf16 forms, as the
// JAX package casts a bias to the compute type before it is added)
template <int C, int WM, typename E = float>
__device__ __forceinline__ void init_acc(float (&acc)[Geo<C>::kNT][4],
                                         const float* __restrict__ bias,
                                         const Lane<C, WM>& ln,
                                         const float* __restrict__ bias2 = nullptr) {
#pragma unroll
  for (int j = 0; j < Geo<C>::kNT; ++j) {
    const int col = ln.n0 + j * 8 + 2 * ln.t;
    float2 b = make_float2(0.f, 0.f);
    if (bias != nullptr) {
      b = __ldg(reinterpret_cast<const float2*>(bias + col));
      b = make_float2(fit<E>(b.x), fit<E>(b.y));
    }
    if (bias2 != nullptr) {
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias2 + col));
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

__device__ __forceinline__ uint32_t leaky_bf16x2(uint32_t v, float slope) {
  const float2 f = unpack_bf16x2(v);
  return pack_bf16x2(leaky(f.x, slope), leaky(f.y, slope));
}

// Stages leaky(src[g_lo .. g_lo + n), slope) of one sequence (T rows of C
// elements) into `tile`, zeros outside [0, T): every conv's zero padding; or,
// with `mirror`, the mirrored rows there: a residual stack's reflect pad
// (any number of folds, down to T = 1).  The bf16 form rounds the
// leaky-relu's products to bf16, as the Pallas bodies do.
template <int C, int THREADS, typename E>
__device__ __forceinline__ void stage_rows(E* tile, const E* __restrict__ src, int T, int g_lo,
                                           int n, float slope, bool mirror = false) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));  // elements of a 16-byte copy
  constexpr int CV = C / kVec;
  for (int i = threadIdx.x; i < n * CV; i += THREADS) {
    const int row = i / CV, cv = i % CV;
    const int g = mirror ? reflect_index(g_lo + row, T) : g_lo + row;
    if constexpr (is_bf16<E>()) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g >= 0 && g < T) {
        v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(g) * C) + cv);
        v = make_uint4(leaky_bf16x2(v.x, slope), leaky_bf16x2(v.y, slope),
                       leaky_bf16x2(v.z, slope), leaky_bf16x2(v.w, slope));
      }
      *reinterpret_cast<uint4*>(tile + row * Geo<C, E>::kSA + kVec * cv) = v;
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T) {
        v = leaky4(__ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * C) + cv),
                   slope);
      }
      *reinterpret_cast<float4*>(tile + row * Geo<C, E>::kSA + kVec * cv) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// packing the kernels
// ---------------------------------------------------------------------------

constexpr int kMaxPack = 64;

// Up to kMaxPack kernels: src (K, C, C) float32 as (tap, produced,
// contracted), or with `swap` as (tap, contracted, produced); dst
// `packed_elems<C, E>(K)` elements.
template <typename E>
struct PackArgsT {
  const float* src[kMaxPack];
  E* dst[kMaxPack];
  int K[kMaxPack];
  int swap[kMaxPack];
};
using PackArgs = PackArgsT<float>;

// dst = src in the order `conv_core` reads it: per unit (tap, chunk of kKC
// contracted channels) the core matrices [kKC / kCK][C / 8][8 produced][kCK
// contracted]; the TF32 form split into its hi half, then its lo half, the
// bf16 form rounded to nearest.
template <int C, typename E>
__global__ void __launch_bounds__(256) pack_kernel(PackArgsT<E> a) {
  using G = Geo<C, E>;
  constexpr int kCK = G::kCK;
  const int conv = blockIdx.y;
  const float* __restrict__ src = a.src[conv];
  E* __restrict__ dst = a.dst[conv];
  const int total = a.K[conv] * C * C;
  const bool swap = a.swap[conv] != 0;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int unit = i / G::kHalfElems, within = i % G::kHalfElems;
    const int kk = within % kCK, r8 = within / kCK % 8, ng = within / (8 * kCK) % (C / 8);
    const int kg = within / (8 * kCK * (C / 8));
    const int tap = unit / G::kChunks, chunk = unit % G::kChunks;
    const int produced = ng * 8 + r8, contracted = chunk * G::kKC + kg * kCK + kk;
    const float v = __ldg(src + (static_cast<size_t>(tap) * C + (swap ? contracted : produced)) * C +
                          (swap ? produced : contracted));
    E* at = dst + static_cast<size_t>(unit) * G::kUnitElems + within;
    if constexpr (is_bf16<E>()) {
      *at = __float2bfloat16_rn(v);
    } else {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      at[0] = __uint_as_float(hi);
      at[G::kHalfElems] = __uint_as_float(lo);
    }
  }
}

template <int C, typename E>
cudaError_t launch_pack(const PackArgsT<E>& a, int n, cudaStream_t stream) {
  int max_K = 1;
  for (int i = 0; i < n; ++i) max_K = max_K > a.K[i] ? max_K : a.K[i];
  const int blocks = (max_K * C * C + 255) / 256;
  pack_kernel<C, E><<<dim3(blocks < 64 ? blocks : 64, n), 256, 0, stream>>>(a);
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
// `FVT_MMA_BF16_PAIR_KERNEL`), which names it after its library and form,
// so that a profile tells the forward's launches from the backward's
// recompute.
template <int C, int WM, int ST, typename E>
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
  E* tile = smem;
  E* ring = smem + tile_rows * G::kSA;
  float acc[G::kNT][4];

  stage_rows<C, THREADS>(tile, a.src[z] + base, T, u_lo - m1, nu + 2 * m1, a.slope);

  // u row i reads the staged rows i + k d
  const bool active_u = ln.group_m * 64 < nu;
  init_acc<C, WM, E>(acc, a.b1[z], ln);
  conv_core<C, WM, ST>(acc, tile, 0, d, a.w1[z], K1, ring, ln, active_u);
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
        store2(tile + r * G::kSA + col, v);
        if (owned) store2(u_out + base + static_cast<size_t>(gr) * C + col, v);
      }
    }
  }
  if (a.dst[z] == nullptr) return;

  // output row i reads u rows i + k
  const bool active_o = ln.group_m * 64 < no;
  init_acc<C, WM, E>(acc, a.b2[z], ln);
  conv_core<C, WM, ST>(acc, tile, 0, 1, a.w2[z], K2, ring, ln, active_o);
  if (!active_o) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.row0 + ln.g + 8 * half;
    if (r >= no) continue;
    const size_t row = base + static_cast<size_t>(q0 + r) * C;
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      const size_t at = row + ln.n0 + j * 8 + 2 * ln.t;
      const float2 h = load2(a.src[z] + at);
      store2(a.dst[z] + at, make_float2(fit<E>(h.x + fit<E>(acc[j][2 * half])),
                                        fit<E>(h.y + fit<E>(acc[j][2 * half + 1]))));
    }
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
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::PairArgsT<fvt_mma::bf16> a, int T, int R, int tile_rows) {      \
    extern __shared__ __align__(16) unsigned char smem_raw[];                  \
    fvt_mma::pair_body<C, WM, ST, fvt_mma::bf16>(                               \
        a, T, R, tile_rows, reinterpret_cast<fvt_mma::bf16*>(smem_raw));        \
  }

// One launch of `kernel` (a FVT_MMA_PAIR_KERNEL or FVT_MMA_BF16_PAIR_KERNEL
// at C, WM, ST) with `a` over nz branches of (B, T, C).  The grid starts its
// blocks in the order of blockIdx.z, and the kernels read it backwards:
// HiFiGAN lists its branches by rising kernel size, so the longest blocks
// start first and the short ones fill the launch's tail.
template <int C, int WM, int ST, typename E>
cudaError_t launch_pair(PairKernelT<E> kernel, const PairArgsT<E>& a, int nz, int B, int T,
                        cudaStream_t stream) {
  using G = Geo<C, E>;
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
  const int tile_rows = kRows + 2 * (max_m1 > max_m2 ? max_m1 : max_m2);
  const int smem = static_cast<int>(sizeof(E)) * (tile_rows * G::kSA + ST * G::kSlabElems);
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
// (`FVT_MMA_STACK_KERNEL`, `FVT_MMA_BF16_STACK_KERNEL`), which names it
// after its library and form, so that a profile tells the forward's
// launches from the backward's recompute.
template <int C, int WM, int ST, typename E>
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
  const E* src = a.src + base;
  E* tile = smem;
  E* ring = smem + tile_rows * G::kSA;
  float acc[G::kNT][4];

  stage_rows<C, THREADS>(tile, src, T, q0 - m, no + 2 * m, a.slope, true);
  // u row i reads the staged rows i + k d
  const bool active = ln.group_m * 64 < no;
  init_acc<C, WM, E>(acc, a.bd, ln);
  conv_core<C, WM, ST>(acc, tile, 0, d, a.wd, a.K, ring, ln, active);
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
        store2(tile + r * G::kSA + col, v);
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
    conv_core<C, WM, ST>(acc, tile, 0, 1, a.w1, 1, ring, ln, active);
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      t_kept[j][0] = pack_bf16x2(acc[j][0], acc[j][1]);
      t_kept[j][1] = pack_bf16x2(acc[j][2], acc[j][3]);
    }
    init_acc<C, WM, E>(acc, a.bs, ln);
  } else {
    init_acc<C, WM, E>(acc, a.b1, ln, a.bs);
    conv_core<C, WM, ST>(acc, tile, 0, 1, a.w1, 1, ring, ln, active);
  }
  __syncthreads();  // u is read no more: the raw rows of h take its place
  stage_rows<C, THREADS>(tile, src, T, q0, no, 1.0f);
  conv_core<C, WM, ST>(acc, tile, 0, 1, a.ws, 1, ring, ln, active);
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
  template <int C, int WM, int ST>                                              \
  __global__ void __launch_bounds__(fvt_mma::block_threads<C, WM>())            \
  name(fvt_mma::StackArgsT<fvt_mma::bf16> a, int T, int tile_rows) {            \
    extern __shared__ __align__(16) unsigned char smem_raw[];                  \
    fvt_mma::stack_body<C, WM, ST, fvt_mma::bf16>(                              \
        a, T, tile_rows, reinterpret_cast<fvt_mma::bf16*>(smem_raw));           \
  }

// One launch of `kernel` (a FVT_MMA_STACK_KERNEL or FVT_MMA_BF16_STACK_KERNEL
// at C, WM, ST) with `a` over (B, T, C).
template <int C, int WM, int ST, typename E>
cudaError_t launch_stack(StackKernelT<E> kernel, const StackArgsT<E>& a, int B, int T,
                         cudaStream_t stream) {
  using G = Geo<C, E>;
  constexpr int R = 64 * WM;
  if (a.K < 1 || a.K % 2 == 0 || a.dil < 1) return cudaErrorInvalidValue;
  // conv_d reads up to row R - 1 + 2 m of the tile
  const int tile_rows = R + 2 * ((a.K - 1) / 2 * a.dil);
  const int smem = static_cast<int>(sizeof(E)) * (tile_rows * G::kSA + ST * G::kSlabElems);
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
//   dst[r] = s + res[r]                           (where res is given)
//
// in(g) = leaky(src[g], in_slope) inside [0, T), zero outside.  sign is +1
// for a forward conv and -1 with `flip`, the adjoint, whose W is the forward
// weight with its two channel axes swapped.  Every W is packed from
// (taps, C, C): produced channel, then contracted channel; W2 has one tap.
struct ConvArgs {
  const float* src[kMaxZ];
  const float* w[kMaxZ];
  const float* bias[kMaxZ];  // (C,) or null
  const float* sgn[kMaxZ];   // (B, T, C) or null
  const float* src2[kMaxZ];  // (B, T, C) or null
  const float* w2[kMaxZ];    // packed (1, C, C), with src2
  const float* res[kMaxZ];   // (B, T, C) or null
  float* dst[kMaxZ];
  int K[kMaxZ];
  int dil[kMaxZ];
  float in_slope;   // 1 = no activation
  float out_slope;  // 1 = no activation
  float sgn_slope;
  int flip;
};

inline void clear(ConvArgs& a) {
  for (int z = 0; z < kMaxZ; ++z) {
    a.src[z] = a.w[z] = a.bias[z] = a.sgn[z] = a.src2[z] = a.w2[z] = a.res[z] = nullptr;
    a.dst[z] = nullptr;
    a.K[z] = 1;
    a.dil[z] = 1;
  }
  a.in_slope = a.out_slope = a.sgn_slope = 1.0f;
  a.flip = 0;
}

// acc = leaky(acc, out_slope) * (sgn >= 0 ? 1 : sgn_slope) on the lane's two
// rows, which are rows gr[0] and gr[1] of the sequence at `base` (-1: none)
template <int C, int WM>
__device__ __forceinline__ void mask_rows(float (&acc)[Geo<C>::kNT][4], const int (&gr)[2],
                                          const float* sgn, float sgn_slope, float out_slope,
                                          size_t base, const Lane<C, WM>& ln) {
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
        const float2 s =
            __ldg(reinterpret_cast<const float2*>(sgn + row + ln.n0 + j * 8 + 2 * ln.t));
        x *= s.x >= 0.0f ? 1.0f : sgn_slope;
        y *= s.y >= 0.0f ? 1.0f : sgn_slope;
      }
    }
  }
}

// Block x owns rows [x R, x R + R) of sequence blockIdx.y, R = 64 WM.
// Shared memory: R + 2 max m staged rows, then the weight ring.  With src2
// its R rows are staged over the tile once the conv has read it.  The body
// of each library's conv kernel (`FVT_MMA_CONV_KERNEL`).
template <int C, int WM, int ST>
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
  float* tile = smem;
  float* ring = smem + tile_rows * G::kSA;
  float acc[G::kNT][4];

  stage_rows<C, THREADS>(tile, a.src[z] + base, T, q0 - m, no + 2 * m, a.in_slope);
  const bool active = ln.group_m * 64 < no;
  init_acc<C, WM>(acc, a.bias[z], ln);
  // forwards row i reads staged rows i + k d; the adjoint i + (K - 1 - k) d
  conv_core<C, WM, ST>(acc, tile, a.flip ? (K - 1) * d : 0, a.flip ? -d : d, a.w[z], K, ring, ln,
                       active);
  int gr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ln.row0 + ln.g + 8 * half;
    gr[half] = r < no ? q0 + r : -1;
  }
  if (active) mask_rows<C, WM>(acc, gr, a.sgn[z], a.sgn_slope, a.out_slope, base, ln);
  if (a.src2[z] != nullptr) {
    __syncthreads();  // the tile is read no more: src2's rows take its place
    stage_rows<C, THREADS>(tile, a.src2[z] + base, T, q0, no, 1.0f);
    conv_core<C, WM, ST>(acc, tile, 0, 1, a.w2[z], 1, ring, ln, active);
  }
  if (!active) return;

  const float* res = a.res[z];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (gr[half] < 0) continue;
    const size_t row = base + static_cast<size_t>(gr[half]) * C;
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      const size_t at = row + ln.n0 + j * 8 + 2 * ln.t;
      float2 v = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      if (res != nullptr) {
        const float2 h = __ldg(reinterpret_cast<const float2*>(res + at));
        v.x += h.x;
        v.y += h.y;
      }
      *reinterpret_cast<float2*>(a.dst[z] + at) = v;
    }
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

// One launch of `kernel` (a FVT_MMA_CONV_KERNEL at C, WM, ST) with nz convs
// of `a` over (B, T, C).
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

// After the adjoint of a conv of a reflect-padded input (conv 0 of `a`,
// flip set, m = (K - 1) / 2 dil <= T - 1): the padded position -j
// (1 <= j <= m) was a copy of row j, and position 2 (T - 1) - j of row j
// (T - 1 - m <= j <= T - 2).  The adjoint conv evaluated at those positions
// flows back onto the rows they were copied from:
//
//   dst[j] += (sum_k in(p + (half - k) dil) W[k]) * (sgn[j] >= 0 ? 1 : sgn_slope)
//
// for p = -j and p = 2 (T - 1) - j.  The mask distributes over the sum, so
// this runs in a launch of its own after the conv pass that wrote dst: a
// block an edge of a sequence, R rows at a time, or, where the two edges'
// rows overlap (T <= 2 m + 1), one block a sequence, the left edge first.  Along each edge the
// positions rise with the block's rows (left: row i at p = i - m for
// j = m - i; right: p = T + i for j = T - 2 - i), so a pass is the conv
// pass's own over shifted rows.  The body of each library's fold kernel
// (`FVT_MMA_FOLD_KERNEL`).
template <int C, int WM, int ST>
__device__ __forceinline__ void fold_body(const ConvArgs& a, int T, int tile_rows, float* smem) {
  using G = Geo<C>;
  constexpr int THREADS = block_threads<C, WM>();
  constexpr int R = 64 * WM;
  const Lane<C, WM> ln;
  const int K = a.K[0], d = a.dil[0];
  const int m = (K - 1) / 2 * d;
  const size_t base = static_cast<size_t>(blockIdx.y) * T * C;
  float* tile = smem;
  float* ring = smem + tile_rows * G::kSA;
  float acc[G::kNT][4];
  // grid.x = 2: the edges' rows are apart, a block each; 1: both in turn
  for (int side = gridDim.x == 2 ? blockIdx.x : 0; side < (gridDim.x == 2 ? blockIdx.x + 1 : 2);
       ++side) {
    for (int c0 = 0; c0 < m; c0 += R) {
      const int nv = min(R, m - c0);
      const int p0 = side == 0 ? c0 - m : T + c0;
      __syncthreads();  // every warp is done with the tile
      stage_rows<C, THREADS>(tile, a.src[0] + base, T, p0 - m, nv + 2 * m, a.in_slope);
      const bool active = ln.group_m * 64 < nv;
      init_acc<C, WM>(acc, nullptr, ln);
      conv_core<C, WM, ST>(acc, tile, (K - 1) * d, -d, a.w[0], K, ring, ln, active);
      if (!active) continue;
      int gr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ln.row0 + ln.g + 8 * half, i = c0 + r;
        gr[half] = r < nv ? (side == 0 ? m - i : T - 2 - i) : -1;
      }
      mask_rows<C, WM>(acc, gr, a.sgn[0], a.sgn_slope, 1.0f, base, ln);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (gr[half] < 0) continue;
        float* row = a.dst[0] + base + static_cast<size_t>(gr[half]) * C;
#pragma unroll
        for (int j = 0; j < G::kNT; ++j) {
          float2* at = reinterpret_cast<float2*>(row + ln.n0 + j * 8 + 2 * ln.t);
          const float2 v = *at;  // written by the conv pass, or by this block's left edge
          *at = make_float2(v.x + acc[j][2 * half], v.y + acc[j][2 * half + 1]);
        }
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

// One launch of `kernel` (a FVT_MMA_FOLD_KERNEL at C, WM, ST) for conv 0 of
// `a` over B sequences of T rows; nothing to do without a margin.
template <int C, int WM, int ST>
cudaError_t launch_fold(ConvKernel kernel, const ConvArgs& a, int B, int T,
                        cudaStream_t stream) {
  const int m = max_margin(a, 1);
  if (m < 0 || m > T - 1 || !a.flip) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int tile_rows = 64 * WM + 2 * m;
  const int smem = conv_smem<C, ST>(tile_rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = fvt_smem::allow_max_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(T > 2 * m + 1 ? 2 : 1, B), block_threads<C, WM>(), smem, stream>>>(a, T,
                                                                                tile_rows);
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

// `name`: a FVT_MMA_PAIR_KERNEL or a FVT_MMA_BF16_PAIR_KERNEL
#define FVT_MMA_LAUNCH_PAIR(name, C, a, nz, B, T, stream)                    \
  fvt_mma::launch_pair<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>(     \
      name<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>, a, nz, B, T, stream)

// `name`: a FVT_MMA_STACK_KERNEL or a FVT_MMA_BF16_STACK_KERNEL
#define FVT_MMA_LAUNCH_STACK(name, C, a, B, T, stream)                       \
  fvt_mma::launch_stack<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>(    \
      name<C, fvt_mma::Tile<C>::kWM, fvt_mma::Tile<C>::kST>, a, B, T, stream)

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
// rows of `in` row-major (rows padded to C + 8 floats, so that the
// transposed A fragment, read into registers, meets 32 different banks; the
// activation is applied as a fragment is read), and of dy, which it then
// transposes and splits into TF32 halves in shared memory, as the K-major B
// operand.  The next chunk's rows are on their way (`cp.async`; `in` in two
// stages, dy in one, free once transposed) while the block multiplies the
// current one;
// each warpgroup owns the accumulators of one 64-row group of dW (several
// taps x c_in below C = 64, so that no thread idles) across all the block's
// chunks.  Where a conv has fewer groups than a block has warpgroups they
// share one and split each chunk's rows, and add their sums through shared
// memory in a fixed order.  The sum over blocks is taken in two stages
// (partials per block, then `fvt_bwd::wgrad_reduce_kernel` in a fixed
// order): no atomics, the same bits from run to run.  db rides along in the
// blocks that hold a conv's first groups.

constexpr int kWgradThreads = fvt_bwd::kThreads;
constexpr int kGroupsPerBlock = kWgradThreads / 128;  // warpgroups of a block

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
// staged; the products of 32 rows are summed in the tensor core from zero and
// added to the accumulators on the CUDA cores (`conv_core`).  The body of
// each library's weight-gradient kernel (`FVT_MMA_WGRAD_KERNEL`).
template <int C>
__device__ __forceinline__ void wgrad_body(const fvt_bwd::WgradArgs& w, int B, int T, int in_rows,
                                           float* smem) {
  using G = WGeo<C>;
  constexpr int C4 = C / 4;
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

  // two stages of in_rows rows of `in`, one of RC rows of dy, then dy split
  float* as = smem;
  float* dyr = smem + 2 * in_rows * G::kS;
  float* dyh = dyr + RC * C;  // dy's hi half, then its lo half
  const int chunks_per_seq = (T + RC - 1) / RC;
  const int n_chunks = B * chunks_per_seq;
  const float slope = w.slope[z];
  const bool mirror = w.reflect[z] != 0;
  const bool sums_bias = blockIdx.x == 0;

  // chunk c's rows, asynchronously: `in` from row r0 + lo (mirrored, or
  // zeros outside [0, T)) into stage st, dy from row r0 (zeros past T)
  auto load = [&](int c, int st) {
    const int b = c / chunks_per_seq;
    const int r0 = (c % chunks_per_seq) * RC;
    const float* src = w.a[z] + static_cast<size_t>(b) * T * C;
    float* at = as + st * in_rows * G::kS;
    for (int i = threadIdx.x; i < in_rows * C4; i += kWgradThreads) {
      const int row = i / C4, c4 = i % C4;
      int gr = r0 + lo + row;
      bool ok = true;
      if (mirror) {
        gr = reflect_index(gr, T);
      } else if (gr < 0 || gr >= T) {
        ok = false;
        gr = 0;
      }
      cp_async16_zfill(at + row * G::kS + 4 * c4, src + static_cast<size_t>(gr) * C + 4 * c4, ok);
    }
    const float* dy = w.dy[z] + static_cast<size_t>(b) * T * C;
    for (int i = threadIdx.x; i < RC * C4; i += kWgradThreads) {
      const int row = i / C4, c4 = i % C4;
      const bool ok = r0 + row < T;
      cp_async16_zfill(dyr + row * C + 4 * c4,
                       dy + static_cast<size_t>(ok ? r0 + row : 0) * C + 4 * c4, ok);
    }
    cp_async_commit();
  };

  float acc[G::kNT][4];
#pragma unroll
  for (int j = 0; j < G::kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
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
    for (int i = threadIdx.x; i < RC / 4 * C4; i += kWgradThreads) {
      const int rq = i / C4, c4 = i % C4;
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(dyr + (4 * rq + r) * C + 4 * c4);
        v[r][0] = x.x, v[r][1] = x.y, v[r][2] = x.z, v[r][3] = x.w;
        if (sums_bias) bsum = make_float4(bsum.x + x.x, bsum.y + x.y, bsum.z + x.z, bsum.w + x.w);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 4 * c4 + e;
        uint32_t hi[4], lo4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(v[r][e], hi[r], lo4[r]);
        float* at = dyh + (rq * (C / 8) + co / 8) * G::kCore + co % 8 * 4;
        *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(at + G::kDyHalf) = make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
      }
    }
    fence_smem_for_wgmma();
    __syncthreads();  // dyh is ready; dy's rows and the other stage are free
    if (c + static_cast<int>(gridDim.y) < n_chunks) load(c + gridDim.y, st ^ 1);
    // batch q covers rows 32 q .. 32 q + 31 of the chunk: 4 depth steps
    const float* a_st = as + st * in_rows * G::kS;
    for (int q = split; q * 32 < rn; q += splits) {
      uint32_t a_hi[4][4], a_lo[4][4];
      // tap k reads `in` row r + (k - half) d: staged row r + (k - k_lo) d
      const float* ap = a_st + (q * 32 + t + (k_mine - k_lo) * d) * G::kS + ci0;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        split_tf32(leaky(ap[ks * 8 * G::kS], slope), a_hi[ks][0], a_lo[ks][0]);
        split_tf32(leaky(ap[ks * 8 * G::kS + 8], slope), a_hi[ks][1], a_lo[ks][1]);
        split_tf32(leaky(ap[(ks * 8 + 4) * G::kS], slope), a_hi[ks][2], a_lo[ks][2]);
        split_tf32(leaky(ap[(ks * 8 + 4) * G::kS + 8], slope), a_hi[ks][3], a_lo[ks][3]);
      }
      float p[G::kNT][4];
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float* hi = dyh + ((q * 8 + 2 * ks) * (C / 8) + n0 / 8) * G::kCore;
        const uint64_t d_hi = wgmma_desc(hi, G::kStrideK, G::kStrideN);
        const uint64_t d_lo = wgmma_desc(hi + G::kDyHalf, G::kStrideK, G::kStrideN);
        Wgmma<G::kNW>::run(p, a_lo[ks], d_hi, ks > 0);
        Wgmma<G::kNW>::run(p, a_hi[ks], d_lo, 1);
        Wgmma<G::kNW>::run(p, a_hi[ks], d_hi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < G::kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += p[j][e];
      }
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
    if (threadIdx.x < C) {
      const int c4 = threadIdx.x / 4, e = threadIdx.x % 4;
      float s = 0.0f;
      for (int i = c4; i < kWgradThreads; i += C4) s += red[4 * i + e];
      part[nw + threadIdx.x] = s;
    }
  }
}

typedef void (*WgradKernel)(fvt_bwd::WgradArgs, int, int, int);

#define FVT_MMA_WGRAD_KERNEL(name)                                              \
  template <int C>                                                              \
  __global__ void __launch_bounds__(fvt_mma::kWgradThreads)                     \
  name(fvt_bwd::WgradArgs w, int B, int T, int in_rows) {                       \
    extern __shared__ __align__(16) float smem[];                              \
    fvt_mma::wgrad_body<C>(w, B, T, in_rows, smem);                             \
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
  int floats = 2 * in_rows * G::kS + G::kRows * C + 2 * G::kDyHalf;
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
