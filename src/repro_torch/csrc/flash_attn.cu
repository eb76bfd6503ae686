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
// (kernels/fused.py::fused_flash_ref): s over d = 0..D-1, l over j = 0..bk-1,
// pv over j = 0..bk-1, each left to right with the first term taken as it is,
// and each term one rounded multiply and one rounded add (__fmul_rn and
// __fadd_rn, so that nvcc cannot contract them into FMAs).  The row max is a
// NaN-propagating max (torch.amax, torch.maximum); min and max below
// propagate NaN as torch.clamp and jnp.minimum do.  expf and the IEEE
// division are those torch's CUDA exp and division run.  So the kernel is
// bitwise equal to the plain version on the card.  Build without
// --use_fast_math and -ftz (the rounding needs IEEE division and subnormals).
//
// Bound on the H100: the two dot products, 2*B*Hq*Sq*Sk*D operations each
// (masked pairs are computed, not skipped, as on the TPU), each at the
// tensor-core rate of a type that holds its operands exactly: with a format
// both at the format's rate (bf16 989 TFLOP/s; the repo's fp8_e4m3 grid lies
// inside e4m3fn, 1979 TFLOP/s); with none, q k^T at the operands' type's
// rate (989 for bf16) and p v at the f32 rate (67 TFLOP/s), since p is not
// rounded; the bytes (q, k, v read once, out written once) are far below.  This kernel
// runs the products as separate f32 multiplies and adds on the CUDA cores,
// to keep the fixed IEEE f32 order, so it stays well above either bound.
//
// Design: the TPU grid (B, Hq, nq, nk) with the kv axis sequential in VMEM
// becomes one thread block per (q block, head, batch) that loops over the kv
// blocks.  One thread owns one q row: its f32 accumulator of D values is in
// registers (the head dim is a template parameter, 16, 64 or 128, with
// the columns above D zero).  Shared memory holds the rounded q tile (row
// stride D+1, so the rows a warp reads lie in distinct banks), the rounded k
// tile and then, in the same buffer, the rounded v tile of the current kv
// block (rounding once per kv block gives the values the TPU schedule gets
// by rounding once per block pair, since the scale depends only on the
// tile), and the block's scores, then probabilities, one row per thread.  At
// D = 128 and 128-row blocks that is 197,632 bytes, taken with the opt-in
// dynamic shared memory attribute; it leaves one block of 4 warps per SM.
#include <cuda_bf16.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 128;   // one thread per q row: bq <= 128
constexpr int kMaxBlock = 128;  // bq and bk
constexpr float kNegInf = -1.0e30f;
constexpr float kHalfNegInf = -5.0e29f;

struct FlashArgs {
  int Sq, Sk, Hq, Hkv, D, bq, bk, nk;
  QFmt f, fo;
  int round, scaled, round_out;
  int causal, window, kv_len, q_offset;
  float scale;
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

// Stage one head's tile into shared memory: `rows` rows of `cols` floats at
// row stride `ld`, row r read from src + r * stride (D values; rows at or
// beyond `valid` and columns at or beyond D are zero).  With a format, the
// tile is then rounded in place, after the exact pow2 tile scale when
// `scaled`; returns the dequant scale (1 unless scaled).  Each thread
// rounds the elements it loaded, and the call ends at a barrier.
template <typename T>
__device__ float stage_tile(float* dst, int ld, int cols,
                            const T* __restrict__ src, long long stride,
                            int valid, int rows, const FlashArgs& p,
                            unsigned* warp_max) {
  const int n = rows * cols;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / cols, d = idx % cols;
    dst[r * ld + d] = (r < valid && d < p.D) ? widen(src[r * stride + d])
                                             : 0.0f;
  }
  float scale = 1.0f, inv = 1.0f;
  if (p.round && p.scaled) {
    unsigned m = 0;
    for (int idx = threadIdx.x; idx < n; idx += kThreads)
      m = max(m, abs_bits(dst[(idx / cols) * ld + idx % cols]));
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
    __syncthreads();
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    const int e = tile_scale_exp(m, p.f);
    scale = pow2_from_exp(e);
    inv = pow2_from_exp(-e);
  }
  if (p.round) {
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      float* x = dst + (idx / cols) * ld + idx % cols;
      *x = quantize_rne(p.scaled ? __fmul_rn(*x, inv) : *x, p.f);
    }
  }
  __syncthreads();
  return scale;
}

template <int MAXD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             const FlashArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned warp_max[kThreads / 32];
  constexpr int ldq = MAXD + 1;
  const int ldp = p.bk + 1;
  float* s_kv = smem;                    // bk x MAXD: k, then v
  float* s_q = s_kv + p.bk * MAXD;       // bq x (MAXD + 1)
  float* s_p = s_q + p.bq * ldq;         // bq x (bk + 1): s, then p

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int row0 = qi * p.bq;
  const int i = threadIdx.x;
  const bool own = i < p.bq;
  const int q_pos = p.q_offset + row0 + i;
  const bool rounded_scaled = p.round && p.scaled;

  const float sq = stage_tile(
      s_q, ldq, MAXD, q + (((long long)b * p.Sq + row0) * p.Hq + h) * p.D,
      (long long)p.Hq * p.D, min(p.bq, p.Sq - row0), p.bq, p, warp_max);

  float m = kNegInf, l = 0.0f;
  float acc[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) acc[d] = 0.0f;

  for (int kj = 0; kj < p.nk; ++kj) {
    const int col0 = kj * p.bk;
    const long long kv_off =
        (((long long)b * p.Sk + col0) * p.Hkv + hk) * p.D;
    const long long kv_stride = (long long)p.Hkv * p.D;
    const int kv_valid = min(p.bk, p.Sk - col0);
    const float sk = stage_tile(s_kv, MAXD, MAXD, k + kv_off, kv_stride,
                                kv_valid, p.bk, p, warp_max);
    float m_new = m, corr = 0.0f;
    if (own) {
      const float* qr = s_q + i * ldq;
      float* pr = s_p + i * ldp;
      const float sqk = __fmul_rn(sq, sk);
      float mx = 0.0f;
      // steps 1-4, four kv columns at a time (four independent sums, each
      // over d in order)
      for (int j0 = 0; j0 < p.bk; j0 += 4) {
        const float* k0 = s_kv + min(j0, p.bk - 1) * MAXD;
        const float* k1 = s_kv + min(j0 + 1, p.bk - 1) * MAXD;
        const float* k2 = s_kv + min(j0 + 2, p.bk - 1) * MAXD;
        const float* k3 = s_kv + min(j0 + 3, p.bk - 1) * MAXD;
        float s[4] = {__fmul_rn(qr[0], k0[0]), __fmul_rn(qr[0], k1[0]),
                      __fmul_rn(qr[0], k2[0]), __fmul_rn(qr[0], k3[0])};
        for (int d = 1; d < p.D; ++d) {
          const float qd = qr[d];
          s[0] = __fadd_rn(s[0], __fmul_rn(qd, k0[d]));
          s[1] = __fadd_rn(s[1], __fmul_rn(qd, k1[d]));
          s[2] = __fadd_rn(s[2], __fmul_rn(qd, k2[d]));
          s[3] = __fadd_rn(s[3], __fmul_rn(qd, k3[d]));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          if (j >= p.bk) break;
          float sc = s[c];
          if (rounded_scaled) sc = __fmul_rn(sc, sqk);
          sc = __fmul_rn(sc, p.scale);
          pr[j] = sc;
          const float sm = visible(q_pos, col0 + j, p) ? sc : kNegInf;
          mx = (j == 0 || isnan(sm) || sm > mx) ? sm : mx;
        }
      }
      // steps 4-8
      m_new = max_nan(m, mx);
      const float m_safe = m_new <= kHalfNegInf ? 0.0f : m_new;
      corr = __fmul_rn(expf(min_nan(__fsub_rn(m, m_safe), 0.0f)),
                       m > kHalfNegInf ? 1.0f : 0.0f);
      float lsum = 0.0f;
      for (int j = 0; j < p.bk; ++j) {
        float pj = __fmul_rn(expf(__fsub_rn(pr[j], m_safe)),
                             visible(q_pos, col0 + j, p) ? 1.0f : 0.0f);
        lsum = j == 0 ? pj : __fadd_rn(lsum, pj);
        if (p.round) pj = quantize_rne(pj, p.f);  // step 9
        pr[j] = pj;
      }
      l = __fadd_rn(__fmul_rn(l, corr), lsum);
    }
    __syncthreads();  // every row is done with the k tile
    const float sv = stage_tile(s_kv, MAXD, MAXD, v + kv_off, kv_stride,
                                kv_valid, p.bk, p, warp_max);
    if (own) {
      // steps 10-11, four head columns at a time (each summed over j in
      // order)
      const float* pr = s_p + i * ldp;
#pragma unroll
      for (int d0 = 0; d0 < MAXD; d0 += 4) {
        float pj = pr[0];
        float4 vv = *reinterpret_cast<const float4*>(s_kv + d0);
        float a0 = __fmul_rn(pj, vv.x), a1 = __fmul_rn(pj, vv.y);
        float a2 = __fmul_rn(pj, vv.z), a3 = __fmul_rn(pj, vv.w);
        for (int j = 1; j < p.bk; ++j) {
          pj = pr[j];
          vv = *reinterpret_cast<const float4*>(s_kv + j * MAXD + d0);
          a0 = __fadd_rn(a0, __fmul_rn(pj, vv.x));
          a1 = __fadd_rn(a1, __fmul_rn(pj, vv.y));
          a2 = __fadd_rn(a2, __fmul_rn(pj, vv.z));
          a3 = __fadd_rn(a3, __fmul_rn(pj, vv.w));
        }
        if (rounded_scaled) {
          a0 = __fmul_rn(a0, sv);
          a1 = __fmul_rn(a1, sv);
          a2 = __fmul_rn(a2, sv);
          a3 = __fmul_rn(a3, sv);
        }
        acc[d0] = __fadd_rn(__fmul_rn(acc[d0], corr), a0);
        acc[d0 + 1] = __fadd_rn(__fmul_rn(acc[d0 + 1], corr), a1);
        acc[d0 + 2] = __fadd_rn(__fmul_rn(acc[d0 + 2], corr), a2);
        acc[d0 + 3] = __fadd_rn(__fmul_rn(acc[d0 + 3], corr), a3);
      }
      m = m_new;  // step 12: the carry is m_new, not m_safe
    }
    __syncthreads();  // every row is done with the v tile
  }

  if (own && row0 + i < p.Sq) {
    const float den = isnan(l) ? l : fmaxf(l, 1e-30f);
    T* orow = out + (((long long)b * p.Sq + row0 + i) * p.Hq + h) * p.D;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < p.D) {
        float o = __fdiv_rn(acc[d], den);
        if (p.round_out) o = quantize_rne(o, p.fo);
        narrow(orow + d, o);
      }
    }
  }
}

template <int MAXD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int nb,
           const FlashArgs& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)p.bk * MAXD +
                                       (size_t)p.bq * (MAXD + 1) +
                                       (size_t)p.bq * (p.bk + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<MAXD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.Sq + p.bq - 1) / p.bq, p.Hq, nb);
  flash_kernel<MAXD, T><<<grid, kThreads, smem, stream>>>(
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
  if (D < 1 || D > 128 || bq < 1 || bq > kMaxBlock || bk < 1 ||
      bk > kMaxBlock || Hkv < 1 || Hq % Hkv != 0 || nb > 65535 ||
      Hq > 65535 || dtype < 0 || dtype > 1)
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
  p.q_offset = q_offset; p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, out, nb, p, st);
  return launch_d<__nv_bfloat16>(q, k, v, out, nb, p, st);
}
