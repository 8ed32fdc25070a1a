// The epilogue of the quantized dense layers, shared by both GEMM routes
// (quant_matmul.cu's mma.sync kernel and quant_gemm_sm90.cu's wgmma
// kernel), so the two round alike: the GELU on the f32 pre-activation and
// the store of one or two neighbouring columns in the output's dtype; and
// the unpacking of W4A8's biased nibbles, which both routes do alike.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace quant_epilogue {

// four biased nibbles (one per byte, in the low half) -> four int8 in
// [-8, 7]: per byte n + 0x78 stays below 0x100 (no carry into the next
// byte) and has bit 7 set iff n >= 8, so flipping bit 7 gives n - 8 mod
// 256, the two's complement byte
__device__ __forceinline__ uint32_t unbias_nibbles(uint32_t n) {
  return ((n & 0x0f0f0f0fu) + 0x78787878u) ^ 0x80808080u;
}

// erf GELU for f32 outputs, A&S 7.1.26 for bf16 (the reference's
// gelu_f32), with IEEE division and expf on both routes.  Each operation
// is rounded on its own, in the order of the plain version's torch ops
// (ops/norm_act.py::gelu_f32), so no FMA contraction changes a rounding:
// norm_act.cu's GELU is bit-equal to it.
__device__ __forceinline__ float gelu(float x, bool approx) {
  constexpr float kRsqrt2 = 0.70710678118654752f;
  if (!approx)
    return __fmul_rn(__fmul_rn(x, 0.5f),
                     __fadd_rn(1.0f, erff(__fmul_rn(x, kRsqrt2))));
  const float z = __fmul_rn(fabsf(x), kRsqrt2);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, z)));
  float poly = __fmul_rn(t, 1.061405429f);
  poly = __fmul_rn(t, __fadd_rn(-1.453152027f, poly));
  poly = __fmul_rn(t, __fadd_rn(1.421413741f, poly));
  poly = __fmul_rn(t, __fadd_rn(-0.284496736f, poly));
  poly = __fmul_rn(t, __fadd_rn(0.254829592f, poly));
  const float half_erfc =
      __fmul_rn(__fmul_rn(0.5f, poly), expf(__fmul_rn(-z, z)));
  return __fmul_rn(x, x > 0.0f ? __fsub_rn(1.0f, half_erfc) : half_erfc);
}

// ((acc * sx) * sw) + bias without FMA contraction, then the GELU
__device__ __forceinline__ float dequant(int acc, float sx, float sw,
                                         float bias, bool gelu_on,
                                         bool approx) {
  const float y =
      __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), sx), sw), bias);
  return gelu_on ? gelu(y, approx) : y;
}

// columns (col, col + 1): `both` says col + 1 exists, `pair` that the two
// may be written as one aligned vector
__device__ __forceinline__ void store2(float* p, float a, float b, bool both,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (both) p[1] = b;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool both, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (both) p[1] = __float2bfloat16_rn(b);
  }
}

}  // namespace quant_epilogue
