// Round-to-format (RNE) on f32, the device function shared by the quantize
// kernel (K2, quantize.cu) and the emulated-precision matmul kernels (K1/K3,
// qmm.cu).
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
