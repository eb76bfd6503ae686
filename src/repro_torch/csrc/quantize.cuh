// Round-to-format (RNE) on f32 and the power-of-two tile scale, the device
// functions shared by the quantize kernel (K2, quantize.cu), the
// emulated-precision matmul kernels (K1/K3, qmm.cu), the selective scan
// (K5/K6, ssm_scan.cu) and the emulated flash attention (K4, flash_attn.cu).
//
// Mirrors repro/core/formats.py::quantize op for op: exponent from the f32
// bits, clamp to [emin, emax], a scale of 2**(q_exp - man) built from
// exponent bits in two normal halves, x / scale_lo / scale_hi with IEEE
// division, rintf (round half to even, as jnp.round), overflow above
// max_finite to +-inf, then NaN/inf and signed zero passed through.  The
// intrinsics (__fdiv_rn, __fmul_rn) fix the rounding of every step, so the
// result is bitwise that of the plain PyTorch version
// (repro_torch/core/formats.py) on every input, f32 subnormals included.
// Build without --use_fast_math and without -ftz=true.
//
// quantize_rne_mul, which K1/K3 use, is the same rounding with each IEEE
// division x / 2**s replaced by the multiplication x * 2**-s: both are the
// correctly rounded value of one real number, so the two functions agree
// bitwise on every f32 input, subnormal results included (the card check
// enumerates all 2**32 patterns), and a multiplication costs one instruction
// where __fdiv_rn costs a short subroutine.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct QFmt {
  int identity;  // fp32: quantize is the identity
  int man_bits;
  int emin;
  int emax;
  float max_finite;
};

static inline QFmt make_qfmt(int exp_bits, int man_bits) {
  QFmt f;
  int bias = (1 << (exp_bits - 1)) - 1;
  f.identity = (exp_bits == 8 && man_bits == 23);
  f.man_bits = man_bits;
  f.emin = 1 - bias;
  f.emax = bias;
  // (2 - 2**-man) * 2**emax is exact in double and representable in f32
  f.max_finite = (float)((2.0 - ldexp(1.0, -man_bits)) * ldexp(1.0, bias));
  return f;
}

// 2**e as f32 for e in [-126, 127], from exponent bits.
__device__ __forceinline__ float pow2_from_exp(int e) {
  return __uint_as_float((unsigned)(e + 127) << 23);
}

// floor(log2|x|) for normal f32; -127 for zeros and subnormals.
__device__ __forceinline__ int unbiased_exp_f32(float x) {
  return (int)((__float_as_uint(x) >> 23) & 0xFFu) - 127;
}

// The max magnitude of a tile is taken over abs_bits(x) = bits & 0x7fffffff:
// as unsigned integers these order NaN above inf above every finite value,
// so a NaN tile gets the exponent field 255 as jnp.max(jnp.abs(x)) and
// torch's amax give it (fmaxf would drop NaN).
__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// Scale exponent of a tile from the bit pattern of its largest |x|
// (repro/kernels/fused.py::_pow2_scale): the binade clip(e, emin, emax - 1)
// is the target, and the exponent moving e there is clipped to [-126, 126].
__device__ __forceinline__ int tile_scale_exp(unsigned max_bits, const QFmt f) {
  int e = (int)((max_bits >> 23) & 0xFFu) - 127;
  int target = min(max(e, f.emin), f.emax - 1);
  return min(max(e - target, -126), 126);
}

__device__ __forceinline__ float quantize_rne(float x, const QFmt f) {
  if (f.identity) return x;
  int e = unbiased_exp_f32(x);
  int q_exp = min(max(e, f.emin), f.emax);
  int scale_exp = q_exp - f.man_bits;
  int half_lo = min(max(scale_exp, -126), 127);
  int half_hi = scale_exp - half_lo;
  float scale_lo = pow2_from_exp(half_lo);
  float scale_hi = pow2_from_exp(half_hi);
  float q = rintf(__fdiv_rn(__fdiv_rn(x, scale_lo), scale_hi));
  float y = __fmul_rn(__fmul_rn(q, scale_lo), scale_hi);
  if (fabsf(y) > f.max_finite) y = copysignf(INFINITY, y);
  if (!isfinite(x)) y = x;
  if (x == 0.0f) y = x;
  return y;
}

// 2**e as f32 for e in [-149, 127], exactly: below -126 from the subnormal
// bit pattern, since pow2_from_exp builds only normal powers.
__device__ __forceinline__ float pow2_exact(int e) {
  return e >= -126 ? pow2_from_exp(e) : __uint_as_float(1u << (e + 149));
}

// quantize_rne with x * 2**-half_lo * 2**-half_hi in place of the two
// divisions, in the same order: -half_lo lies in [-127, 126] (2**-127 is an
// f32 subnormal, built exactly) and -half_hi in [0, 22].
__device__ __forceinline__ float quantize_rne_mul(float x, const QFmt f) {
  if (f.identity) return x;
  int e = unbiased_exp_f32(x);
  int q_exp = min(max(e, f.emin), f.emax);
  int scale_exp = q_exp - f.man_bits;
  int half_lo = min(max(scale_exp, -126), 127);
  int half_hi = scale_exp - half_lo;
  float q = rintf(__fmul_rn(__fmul_rn(x, pow2_exact(-half_lo)),
                            pow2_exact(-half_hi)));
  float y = __fmul_rn(__fmul_rn(q, pow2_from_exp(half_lo)),
                      pow2_from_exp(half_hi));
  if (fabsf(y) > f.max_finite) y = copysignf(INFINITY, y);
  if (!isfinite(x)) y = x;
  if (x == 0.0f) y = x;
  return y;
}
