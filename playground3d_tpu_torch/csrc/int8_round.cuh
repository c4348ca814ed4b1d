// float -> int8 at a float32 scale xs, as PyTorch's round and clamp give it:
//   clip(rint(fl(v / xs)), -127, 127), rint to even, a NaN quotient to 0
// (the int8 cast of NaN). Included by qconv.cu's epilogue (requantize) and
// quantize.cu (the activations' quantize step).
//
// The exactly rounded division is a routine of some forty dependent
// instructions; on an H100 quantize.cu reaches 43% of its memory-bound
// rate on layer1's outputs when every value divides, 75-78% with the guess
// below (bfloat16, 199 M elements), so the division is kept for the values
// that need it. With inv_xs = fl(1 / xs) normal, q = fl(v * inv_xs) lies
// within 2^-23 |v / xs| of the true quotient, and t = fl(v / xs) within
// 2^-24 of it: |q - t| < 2.3e-5 wherever |v / xs| <= 128. So if |q| >= 126.75
// then |t| > 126.5 and the clipped result is +-127 (inf included); else if q
// is further than 1e-4 from the nearest half-integer, t lies on the same side
// of it and rint(q) = rint(t). Only about one value in five thousand is
// closer; it, and a NaN, take the division.
//
// requantize_guess returns the result from q and sets `divide` where it must
// come from requantize_exact instead. It has no branch, so a thread's values
// interleave, and no conversion instruction (those issue at a quarter of the
// rate): q is clamped to [-128, 128], and fl(q + 1.5 * 2^23) has a unit last
// bit, so the addition rounds q to the nearest integer, ties to even, and
// that integer is the sum's bits less those of 1.5 * 2^23. A caller whose
// xs or 1 / xs may be subnormal, zero or not finite divides every value.

#pragma once

__device__ __forceinline__ int requantize_guess(float v, float inv_xs, bool& divide) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000
  const float q = __fmul_rn(v, inv_xs);
  const float big = __fadd_rn(fminf(fmaxf(q, -128.0f), 128.0f), kMagic);
  divide = !(fabsf(q) >= 126.75f || fabsf(__fsub_rn(q, __fsub_rn(big, kMagic))) <= 0.4999f);  // NaN compares false
  return min(max(__float_as_int(big) - 0x4B400000, -127), 127);
}

// Clamping before rint is the same as after it, the bounds being integers.
__device__ __forceinline__ int requantize_exact(float v, float xs) {
  const float t = __fdiv_rn(v, xs);
  return t != t ? 0 : static_cast<int>(rintf(fminf(fmaxf(t, -127.0f), 127.0f)));
}
