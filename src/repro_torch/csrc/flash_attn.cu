// K4: blockwise flash attention with per-block quantize/dequant.
//
// Replaces the TPU kernel
//   repro/kernels/fused.py::fused_flash_attention (pallas_call at :391; block
//     update _flash_block_update :257, mask _flash_mask :297, flush :321).
//
// What it computes, for q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), q head h
// reading kv head h / (Hq / Hkv) (no repeated KV in memory):
//   q is cut into blocks of bq rows and k, v into blocks of bk rows, padded
//   with zero rows to whole blocks.  The block sizes are semantics, not
//   tiling: the pow2 scale is taken per (bq, D) q tile and per (bk, D) k and
//   v tile, and the online softmax rescales at the kv-block edges.  For each
//   q block, over the kv blocks in order, with `fmt` set the q, k and v tiles
//   are rounded to `fmt` (after an exact pow2 tile scale when `scaled`), and
//     1. s = dot(q, k^T) in f32;            2. s *= sq*sk if scaled;
//     3. s *= scale (f32(1/sqrt(D)), a separate multiplication);
//     4. m_new = max(m, rowmax(mask ? s : -1e30));
//     5. m_safe = m_new <= -5e29 ? 0 : m_new;
//     6. p = exp(s - m_safe) * mask  (a product, not a select: a masked score
//        far above m_safe gives inf * 0 = NaN, as in the reference);
//     7. corr = exp(min(m - m_safe, 0)) * (m > -5e29);
//     8. l = l*corr + sum_j p;              9. p = quantize(p, fmt) if fmt;
//    10. pv = dot(p, v); pv *= sv if scaled;  11. acc = acc*corr + pv;
//    12. m = m_new;
//   and the flush writes acc / max(l, 1e-30), rounded to `out_fmt` if one is
//   given, in the operands' type.  fmt = none runs the same schedule unrounded.
// Every sum has a fixed order, the order of the plain PyTorch version
// (kernels/fused.py::fused_flash_ref): s over d = 0..D-1, l over j = 0..bk-1
// of the unrounded p, pv over j = 0..bk-1 of the rounded p, each left to
// right with the first term taken as it is, and each term one rounded
// multiply and one rounded add (__fmul_rn and __fadd_rn, so that nvcc cannot
// contract them into FMAs).  A chain starts from -0, which leaves its first
// term as it is (-0 + x == x for every x, signed zeros and NaN included).
// The row max is the one order-free part: it is reduced across threads in
// any order, NaN-propagating (max_nan, as torch.amax and torch.maximum), and
// the sign of a zero it picks cannot change a result bit (m - m_safe, and
// s - m_safe for s = +-0, give values that exp maps alike).  min and max
// below propagate NaN as torch.clamp and jnp.minimum do.  expf and the IEEE
// division are those torch's CUDA exp and division run; the roundings use
// quantize_rne_mul, bitwise equal to the division form over all 2**32
// inputs.  So the kernel is bitwise equal to the plain version on the card.
// Build without --use_fast_math and -ftz (the rounding needs subnormals).
//
// Bound on the H100: the two dot products, 2*B*Hq*Sq*Sk*D operations each
// (masked pairs are computed, not skipped, as on the TPU), each at the
// tensor-core rate of a type that holds its operands exactly: with a format
// both at the format's rate (bf16 989 TFLOP/s; the repo's fp8_e4m3 grid lies
// inside e4m3fn, 1979 TFLOP/s); with none, q k^T at the operands' type's
// rate (989 for bf16) and p v at the f32 rate (67 TFLOP/s), since p is not
// rounded; the bytes (q, k, v read once, out written once) are far below.
// Tinyllama-1.1b's layer 0 at 2 x 2048: 0.548 ms with no format.  The fixed
// IEEE f32 order runs on the CUDA cores instead, one FMUL and one FADD per
// term: 4*B*Hq*Sq*Sk*D = 68.7 G instructions at that shape, whose own
// ceiling is 132 SMs x 128 lanes a clock (~1.98 GHz), ~2.05 ms.
//
// Design: one thread block of 256 threads (8 warps) per (q block, head,
// batch) loops over the kv blocks; one block per SM, within the opt-in
// shared memory.  The 128 x 128 score tile is cut into 8 x 8 register tiles
// on a 16 x 16 thread grid: thread (tr, tc) owns rows tr*4 + {0..3} and
// 64 + tr*4 + {0..3} and columns likewise from tc, so that the float4 reads
// of 16 neighbouring threads cover 64 consecutive floats.  q and k are kept
// rounded and d-major (D x 128) in shared memory: each d step reads 4 float4
// and issues 64 FMUL + 64 FADD into 64 independent chains.  The softmax runs
// in registers, the row max over the 16 threads of a row (one half-warp) by
// shuffles.  The unrounded p goes to shared memory in place of the k tile
// (row stride 132); one thread per row then runs the row's l chain while
// the other four warps widen v, and all threads round p and v in place.
// p v uses the same rows: each thread holds 8 rows x D/16 output columns,
// chains over j reading p and v as float4, and keeps its accumulator in
// registers across the kv blocks.  Rows beyond bq and
// columns beyond bk are computed as zeros or left out of the max, l and p v;
// padding rows within a block are zeros, as in the plain version.  k and v
// are rounded once per kv block as they are staged, by multiplication.  For
// D = 16 and 64 (D equal to the template's head dim) the next k and v tiles
// are copied raw with cp.async into a staging tile while the current one is
// used; at D = 128 they do not fit beside q, k/p and v, and are read from
// device memory as they are staged.  Shared memory: 164 KB at D = 64 (f32),
// 194 KB at D = 128.
#include <cuda_bf16.h>
#include <stdint.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, a 16 x 16 grid of thread tiles
constexpr int kBlk = 128;      // the largest bq and bk: tiles of 128 rows
constexpr int kPld = kBlk + 4;  // row stride of the probability tile
constexpr float kNegInf = -1.0e30f;
constexpr float kHalfNegInf = -5.0e29f;

struct FlashArgs {
  int Sq, Sk, Hq, Hkv, D, bq, bk, nk;
  QFmt f, fo;
  int round, scaled, round_out;
  int causal, window, kv_len, q_offset;
  int async;  // k and v tiles copied ahead with cp.async
  float scale;
};

// Shared memory of one block, in this order: q (MAXD x 128, d-major), k
// (d-major) and then p (128 x kPld), v (128 x MAXD), and for MAXD <= 64 the
// raw staging tile (128 rows of MAXD values of T, padded by 16 bytes).
template <int MAXD, typename T>
struct Smem {
  static constexpr bool kAsync = MAXD <= 64;
  static constexpr int kRawLd = MAXD + 16 / (int)sizeof(T);
  static constexpr size_t kQ = (size_t)MAXD * kBlk;
  static constexpr size_t kKP = (size_t)kBlk * kPld;
  static constexpr size_t kV = (size_t)kBlk * MAXD;
  static constexpr size_t kRaw =
      kAsync ? (size_t)kBlk * kRawLd * sizeof(T) : 0;
  static constexpr size_t kBytes = (kQ + kKP + kV) * sizeof(float) + kRaw;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// NaN-propagating max and min (fmaxf and fminf drop a NaN operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

// repro/kernels/fused.py::_flash_mask for one (q position, k position)
__device__ __forceinline__ bool visible(int q_pos, int k_pos,
                                        const FlashArgs& p) {
  bool m = k_pos < p.kv_len;
  if (p.causal) m = m && k_pos <= q_pos;
  if (p.window) m = m && k_pos > q_pos - p.window;
  return m;
}

// The i-th (0..7) of the rows or columns a thread owns in a 128-wide tile:
// four consecutive ones from g*4 in each half.
__device__ __forceinline__ int half_idx(int g, int i) {
  return (i >> 2) * 64 + g * 4 + (i & 3);
}

// The n-th output column of thread column tc in p v (TN = MAXD / 16 a
// thread): tc itself for TN = 1, else four consecutive ones from tc*4 in
// each 64-wide half.
template <int TN>
__device__ __forceinline__ int out_col(int tc, int n) {
  return TN == 1 ? tc : (n >> 2) * 64 + tc * 4 + (n & 3);
}

__device__ __forceinline__ float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

__device__ __forceinline__ unsigned warp_max_bits(unsigned m) {
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four values of one row from d on, as f32: `n` of them lie below D (the
// rest are zero).  `vec`: s is the shared staging tile (D == MAXD, aligned),
// read in one 16- or 8-byte load.
__device__ __forceinline__ float4 load4(const float* s, bool vec, int n) {
  if (vec) return *reinterpret_cast<const float4*>(s);
  return make_float4(n > 0 ? s[0] : 0.0f, n > 1 ? s[1] : 0.0f,
                     n > 2 ? s[2] : 0.0f, n > 3 ? s[3] : 0.0f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* s, bool vec,
                                        int n) {
  if (vec) {  // bf16 to f32 is the 16 bits shifted up
    const uint2 u = *reinterpret_cast<const uint2*>(s);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(n > 0 ? widen(s[0]) : 0.0f, n > 1 ? widen(s[1]) : 0.0f,
                     n > 2 ? widen(s[2]) : 0.0f, n > 3 ? widen(s[3]) : 0.0f);
}

// Copy rows [0, valid) of one head's (bk, MAXD) tile, row r at src + r *
// ld, into the staging tile with cp.async (16 bytes a copy), and commit.
template <int MAXD, typename T>
__device__ void issue_tile(T* raw, const T* src, long long ld, int valid) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int C = MAXD / E;
  for (int idx = threadIdx.x; idx < valid * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    cp_async16(raw + r * Smem<MAXD, T>::kRawLd + c * E, src + r * ld + c * E);
  }
  cp_async_commit();
}

// Widen a 128-row tile into dst as f32: row r < valid from src + r * ld (D
// values), zeros elsewhere (rows at or beyond valid, columns at or beyond
// D).  DMAJOR stores dst[d * 128 + r], four columns of one row per thread
// with neighbouring threads on neighbouring rows, so the stores do not
// conflict; otherwise dst[r * MAXD + d], neighbouring threads on
// neighbouring column groups.  Thread `tid` of `nthr` takes every nthr-th
// group.  Returns the largest abs_bits among the values it wrote.
template <int MAXD, bool DMAJOR, typename T>
__device__ unsigned widen_tile(float* dst, const T* src, long long ld,
                               int valid, int D, bool vec, int tid,
                               int nthr) {
  constexpr int G = MAXD / 4;
  unsigned mx = 0;
  for (int g = tid; g < kBlk * G; g += nthr) {
    const int r = DMAJOR ? g % kBlk : g / G;
    const int d = 4 * (DMAJOR ? g / kBlk : g % G);
    const float4 x = r < valid ? load4(src + r * ld + d, vec, D - d)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    mx = max(mx, max(max(abs_bits(x.x), abs_bits(x.y)),
                     max(abs_bits(x.z), abs_bits(x.w))));
    if (DMAJOR) {
      dst[d * kBlk + r] = x.x;
      dst[(d + 1) * kBlk + r] = x.y;
      dst[(d + 2) * kBlk + r] = x.z;
      dst[(d + 3) * kBlk + r] = x.w;
    } else {
      *reinterpret_cast<float4*>(dst + r * MAXD + d) = x;
    }
  }
  return mx;
}

__device__ __forceinline__ float4 round4(float4 x, bool scaled, float inv,
                                         const QFmt f) {
  if (scaled) {
    x.x = __fmul_rn(x.x, inv);
    x.y = __fmul_rn(x.y, inv);
    x.z = __fmul_rn(x.z, inv);
    x.w = __fmul_rn(x.w, inv);
  }
  return make_float4(quantize_rne_mul(x.x, f), quantize_rne_mul(x.y, f),
                     quantize_rne_mul(x.z, f), quantize_rne_mul(x.w, f));
}

// With a format, round the first n floats of a staged tile in place (after
// the exact pow2 tile scale when scaled, from the maxima warps w0..7 left in
// warp_max) and, given one, the probability tile (its first bk columns,
// unscaled), with all threads, and end at a barrier; returns the tile's
// dequant scale (1 unless rounded and scaled).  Without one, does nothing.
__device__ float round_staged(float* t, int n, int w0, const FlashArgs& p,
                              const unsigned* warp_max,
                              float* probs = nullptr) {
  if (!p.round) return 1.0f;
  float scale = 1.0f, inv = 1.0f;
  if (p.scaled) {
    unsigned m = 0;
    for (int w = w0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    const int e = tile_scale_exp(m, p.f);
    scale = pow2_from_exp(e);
    inv = pow2_from_exp(-e);
  }
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) {
    float4* x = reinterpret_cast<float4*>(t + i);
    *x = round4(*x, p.scaled, inv, p.f);
  }
  if (probs) {  // neighbouring threads on neighbouring rows
    const int c4 = (p.bk + 3) / 4;
    for (int i = threadIdx.x; i < kBlk * c4; i += kThreads) {
      float4* x = reinterpret_cast<float4*>(probs + (i % kBlk) * kPld +
                                            (i / kBlk) * 4);
      *x = round4(*x, false, 1.0f, p.f);
    }
  }
  __syncthreads();
  return scale;
}

// Stage a d-major tile with all threads (widen, then round): returns the
// dequant scale; ends at a barrier.
template <int MAXD, typename T>
__device__ float stage_dmajor(float* dst, const T* src, long long ld,
                              int valid, bool vec, const FlashArgs& p,
                              unsigned* warp_max) {
  unsigned mx = widen_tile<MAXD, true>(dst, src, ld, valid, p.D, vec,
                                       threadIdx.x, kThreads);
  if (p.round && p.scaled) {
    mx = warp_max_bits(mx);
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  }
  __syncthreads();
  return round_staged(dst, p.D * kBlk, 0, p, warp_max);
}

template <int MAXD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const FlashArgs p) {
  using L = Smem<MAXD, T>;
  constexpr int TN = MAXD / 16;  // output columns a thread holds in p v
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned warp_max[kThreads / 32];
  __shared__ float s_corr[kBlk], s_l[kBlk];
  float* s_q = smem;
  float* s_kp = s_q + L::kQ;  // k, then p of the same kv block
  float* s_v = s_kp + L::kKP;
  T* raw = reinterpret_cast<T*>(s_v + L::kV);

  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int row0 = qi * p.bq;
  const bool rounded_scaled = p.round && p.scaled;
  const bool async = L::kAsync && p.async;
  const bool rows_live = tr * 4 < p.bq;  // else all 8 rows lie beyond bq
  const long long kv_ld = (long long)p.Hkv * p.D;
  const long long head = ((long long)b * p.Sk * p.Hkv + hk) * p.D;
  const T* k_head = k + head;
  const T* v_head = v + head;

  if (async) issue_tile<MAXD>(raw, k_head, kv_ld, min(p.bk, p.Sk));
  const float sq = stage_dmajor<MAXD>(
      s_q, q + (((long long)b * p.Sq + row0) * p.Hq + h) * p.D,
      (long long)p.Hq * p.D, min(p.bq, p.Sq - row0), false, p, warp_max);
  if (async) {
    cp_async_wait_all();
    __syncthreads();
  }

  float m[8], acc[8][TN], l = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.0f;
  }

  for (int kj = 0; kj < p.nk; ++kj) {
    const int col0 = kj * p.bk;
    const int kv_valid = min(p.bk, p.Sk - col0);
    const long long off = (long long)col0 * kv_ld;
    const float sk = stage_dmajor<MAXD>(
        s_kp, async ? raw : k_head + off, async ? L::kRawLd : kv_ld,
        kv_valid, async, p, warp_max);
    if (async) issue_tile<MAXD>(raw, v_head + off, kv_ld, kv_valid);

    // step 1: 64 chains over d, each from -0
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = -0.0f;
    if (rows_live && tc * 4 < p.bk) {
      const float* qp = s_q + tr * 4;
      const float* kp = s_kp + tc * 4;
#pragma unroll 2
      for (int d = 0; d < p.D; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(qp + d * kBlk);
        const float4 qb =
            *reinterpret_cast<const float4*>(qp + d * kBlk + 64);
        const float4 ka = *reinterpret_cast<const float4*>(kp + d * kBlk);
        const float4 kb =
            *reinterpret_cast<const float4*>(kp + d * kBlk + 64);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            s[i][j] = __fadd_rn(s[i][j], __fmul_rn(qv[i], kv[j]));
      }
    }

    // steps 2-7 in registers; columns at or beyond bk are not in the block
    const float sqk = __fmul_rn(sq, sk);
    float corr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q_pos = p.q_offset + row0 + half_idx(tr, i);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = half_idx(tc, j);
        float sc = s[i][j];
        if (rounded_scaled) sc = __fmul_rn(sc, sqk);
        sc = __fmul_rn(sc, p.scale);
        s[i][j] = sc;
        if (col < p.bk)
          mx = max_nan(mx, visible(q_pos, col0 + col, p) ? sc : kNegInf);
      }
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 threads
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = max_nan(m[i], mx);
      const float m_safe = m_new <= kHalfNegInf ? 0.0f : m_new;
      corr[i] = __fmul_rn(expf(min_nan(__fsub_rn(m[i], m_safe), 0.0f)),
                          m[i] > kHalfNegInf ? 1.0f : 0.0f);
      m[i] = m_new;  // step 12: the carry is m_new, not m_safe
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = half_idx(tc, j);
        s[i][j] = col < p.bk
                      ? __fmul_rn(expf(__fsub_rn(s[i][j], m_safe)),
                                  visible(q_pos, col0 + col, p) ? 1.0f
                                                                : 0.0f)
                      : 0.0f;
      }
    }
    __syncthreads();  // every thread is done with the k tile: p replaces it
    float* s_p = s_kp;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* pr = s_p + half_idx(tr, i) * kPld + tc * 4;
      *reinterpret_cast<float4*>(pr) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(pr + 64) =
          make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
      if (tc == 0) s_corr[half_idx(tr, i)] = corr[i];
    }
    if (async) cp_async_wait_all();  // the v tile
    __syncthreads();

    if (t < kBlk) {
      // step 8 over the unrounded p: one thread a row
      if (t < p.bq) {
        const float* pr = s_p + t * kPld;
        float lsum = -0.0f;
        for (int j0 = 0; j0 < p.bk; j0 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(pr + j0);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (j0 + c < p.bk) lsum = __fadd_rn(lsum, comp(x, c));
        }
        l = __fadd_rn(__fmul_rn(l, s_corr[t]), lsum);
      }
    } else {
      // meanwhile the other four warps widen the v tile
      unsigned mx = widen_tile<MAXD, false>(
          s_v, async ? raw : v_head + off, async ? L::kRawLd : kv_ld,
          kv_valid, p.D, async, t - kBlk, kThreads - kBlk);
      if (rounded_scaled) {
        mx = warp_max_bits(mx);
        if (t % 32 == 0) warp_max[t / 32] = mx;
      }
    }
    __syncthreads();
    // step 9 and the v tile's rounding, with all threads
    const float sv =
        round_staged(s_v, p.bk * MAXD, kBlk / 32, p, warp_max, s_p);
    if (async && kj + 1 < p.nk)
      issue_tile<MAXD>(raw, k_head + off + (long long)p.bk * kv_ld, kv_ld,
                       min(p.bk, p.Sk - col0 - p.bk));

    // steps 10-11: chains over j of the rounded p, each from -0
    if (rows_live) {
      float pv[8][TN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) pv[i][n] = -0.0f;
      for (int j0 = 0; j0 < p.bk; j0 += 4) {
        float4 pj[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pj[i] = *reinterpret_cast<const float4*>(
              s_p + half_idx(tr, i) * kPld + j0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (j0 + c < p.bk) {
            const float* vr = s_v + (j0 + c) * MAXD;
            float vv[TN];
            if constexpr (TN == 1) {
              vv[0] = vr[tc];
            } else {
#pragma unroll
              for (int hh = 0; hh < TN / 4; ++hh) {
                const float4 x =
                    *reinterpret_cast<const float4*>(vr + hh * 64 + tc * 4);
                vv[hh * 4] = x.x;
                vv[hh * 4 + 1] = x.y;
                vv[hh * 4 + 2] = x.z;
                vv[hh * 4 + 3] = x.w;
              }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float pc = comp(pj[i], c);
#pragma unroll
              for (int n = 0; n < TN; ++n)
                pv[i][n] = __fadd_rn(pv[i][n], __fmul_rn(pc, vv[n]));
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          float x = pv[i][n];
          if (rounded_scaled) x = __fmul_rn(x, sv);
          acc[i][n] = __fadd_rn(__fmul_rn(acc[i][n], corr[i]), x);
        }
    }
    if (async) cp_async_wait_all();  // the next k tile
    __syncthreads();  // every thread is done with p and v
  }

  if (t < kBlk) s_l[t] = l;
  __syncthreads();
  if (!rows_live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = half_idx(tr, i);
    if (row >= p.bq || row0 + row >= p.Sq) continue;
    const float lr = s_l[row];
    const float den = isnan(lr) ? lr : fmaxf(lr, 1e-30f);
    T* orow = out + (((long long)b * p.Sq + row0 + row) * p.Hq + h) * p.D;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int col = out_col<TN>(tc, n);
      if (col < p.D) {
        float o = __fdiv_rn(acc[i][n], den);
        if (p.round_out) o = quantize_rne_mul(o, p.fo);
        narrow(orow + col, o);
      }
    }
  }
}

template <int MAXD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int nb,
           FlashArgs p, cudaStream_t stream) {
  using L = Smem<MAXD, T>;
  // cp.async copies 16-byte pieces of whole rows: D must fill the tile and
  // both operands start on 16 bytes (every row then does)
  p.async = L::kAsync && p.D == MAXD && (uintptr_t)k % 16 == 0 &&
            (uintptr_t)v % 16 == 0;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<MAXD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hq, nb);
  flash_kernel<MAXD, T><<<grid, kThreads, L::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int nb,
             const FlashArgs& p, cudaStream_t stream) {
  if (p.D <= 16) return launch<16, T>(q, k, v, out, nb, p, stream);
  if (p.D <= 64) return launch<64, T>(q, k, v, out, nb, p, stream);
  return launch<128, T>(q, k, v, out, nb, p, stream);
}

}  // namespace

// q (nb, Sq, Hq, D), k and v (nb, Sk, Hkv, D), out (nb, Sq, Hq, D), all
// contiguous and of one type (dtype 0 = float32, 1 = bfloat16); bq and bk
// the logical blocks (1..128), D at most 128, Hq a multiple of Hkv.
// exp_bits = 0 means no format, out_exp = 0 no out_fmt; window = 0 no
// window.  Returns a cudaError_t.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int nb,
    int Sq, int Sk, int Hq, int Hkv, int D, int bq, int bk, int exp_bits,
    int man_bits, int scaled, int out_exp, int out_man, int causal,
    int window, int kv_len, int q_offset, float scale, void* stream) {
  if (D < 1 || D > 128 || bq < 1 || bq > kBlk || bk < 1 || bk > kBlk ||
      Hkv < 1 || Hq % Hkv != 0 || nb > 65535 || Hq > 65535 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0) return 0;
  FlashArgs p;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.D = D;
  p.bq = bq; p.bk = bk; p.nk = (Sk + bk - 1) / bk;
  p.round = exp_bits > 0;
  p.f = p.round ? make_qfmt(exp_bits, man_bits) : make_qfmt(8, 23);
  p.scaled = scaled;
  p.round_out = out_exp > 0;
  p.fo = p.round_out ? make_qfmt(out_exp, out_man) : make_qfmt(8, 23);
  p.causal = causal; p.window = window; p.kv_len = kv_len;
  p.q_offset = q_offset; p.scale = scale; p.async = 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, out, nb, p, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, nb, p, st);
}
