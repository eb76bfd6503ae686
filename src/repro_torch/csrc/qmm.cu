// K1 and K3: emulated-precision matmul with the FPMax accumulation styles.
//
// Replaces the TPU kernels
//   repro/kernels/fused.py::fused_qmm         (pallas_call at :177; block
//     update _qmm_block_update :98, _quantize_block :87, _pow2_scale :62)
//   repro/kernels/fma_emu.py::fma_emu_matmul  (pallas_call at :100), the
//     2-D unscaled form, which shares this file's device code.
//
// What it computes: (B?, M, K) @ (K, N) in f32.  For each 128-deep k block
// the a and b tiles are rounded to `fmt` (after an exact power-of-two tile
// scale when `scaled`), the partial dot is taken in f32 and dequantised by
// sa*sb, and the style folds it into the accumulator:
//   fused       acc + part
//   cascade_fwd acc + q(part)
//   cascade     q(acc + q(part))
// After the last block the result is rounded to `out_fmt` if one is given.
//
// Bound on the H100: the rounded operands are exact in bf16, fp16 or fp8,
// so the least time for the work is 2MKN operations at that type's
// tensor-core rate (989 TFLOP/s for bf16), and that is the bound PERF.md
// reports; the decode shapes (M = 4) read each weight once for a handful of
// rows and are bound by the bytes of b instead.  This kernel does the
// products as f32 FMA on the CUDA cores (67 TFLOP/s peak) to keep an IEEE
// f32 partial dot, so at the prefill shapes (M = 512) it stays at least
// ~15x above that bound; a tensor-core version must first show that the
// MMA's internal accumulation stays within the format's rounding.
//
// Design: one thread block per (batch, BM x 128 output tile); the TPU's sequential k grid axis becomes a loop inside the block over
// exactly 128-deep k blocks, because the cascade styles round at those
// boundaries.  Each k block is staged through shared memory in 32-deep
// slices, rounded on load; every thread keeps an 8-wide row of acc and part
// per output row it owns in registers and accumulates part with fmaf in k
// order.  b is read through its strides in place (the unembed's table.T is
// column-major) and bf16 operands are widened on load, which is exact.  With
// `scaled`, a pre-pass writes each logical 128 x 128 tile's scale exponent,
// so the scale is that of the TPU tile whatever BM is.  The dequant and the
// style epilogues use __fmul_rn/__fadd_rn so that nvcc cannot contract them
// into an FMA: their op order is part of the contract.
#include <cuda_bf16.h>

#include "quantize.cuh"

namespace {

constexpr int kBN = 128;      // output tile width
constexpr int kBK = 128;      // the k block: the styles round at its edges
constexpr int kKC = 32;       // k slice staged through shared memory
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kTN = 8;        // columns per thread (tx + 16 * j)

enum Style { kFused = 0, kCascade = 1, kCascadeFwd = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Scale exponent of a tile from the bit pattern of its largest |x|: the max
// over (bits & 0x7fffffff) orders NaN above inf, so a NaN tile gets the
// exponent field 255 as jnp.max(jnp.abs(x)) gives it (fmaxf would drop NaN).
__device__ __forceinline__ int tile_scale_exp(unsigned max_bits, const QFmt f) {
  int e = (int)((max_bits >> 23) & 0xFFu) - 127;
  int target = min(max(e, f.emin), f.emax - 1);
  return min(max(e - target, -126), 126);
}

// One block per logical 128 x 128 tile of a (rows x cols) matrix in each of
// `nbatch` slices: out[batch][tile_r][tile_c] = the tile's scale exponent.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_exp_kernel(const T* __restrict__ x, long long s_batch, long long s_row,
                 long long s_col, int rows, int cols, QFmt f,
                 int* __restrict__ out) {
  const int tr = blockIdx.y, tc = blockIdx.x, bb = blockIdx.z;
  const T* xb = x + bb * s_batch;
  unsigned m = 0;
  for (int idx = threadIdx.x; idx < 128 * 128; idx += kThreads) {
    int r = tr * 128 + idx / 128, c = tc * 128 + idx % 128;
    if (r < rows && c < cols) {
      float v = widen(xb[r * s_row + c * s_col]);
      m = max(m, __float_as_uint(v) & 0x7fffffffu);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    out[((long long)bb * gridDim.y + tr) * gridDim.x + tc] = tile_scale_exp(m, f);
  }
}

struct QmmArgs {
  long long sab, sam, sak;  // a strides: batch, row, k
  long long sbk, sbn;       // b strides: k, column
  int M, N, K;
  QFmt f, out_f;
  int has_out_fmt, style;
  const int* a_scale;  // (batch, ceil(M/128), K/128) or null when unscaled
  const int* b_scale;  // (K/128, ceil(N/128)) or null when unscaled
};

template <int BM, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
           float* __restrict__ out, const QmmArgs p) {
  constexpr int TM = BM / 16;  // rows per thread (ty + 16 * i)
  __shared__ float as[kKC][BM + 1];   // a slice, k-major, rounded
  __shared__ float bs[kKC][kBN + 1];  // b slice, rounded

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, bb = blockIdx.z;
  const TA* ab = a + bb * p.sab;
  const int gk = (p.K + kBK - 1) / kBK;
  const int gm128 = (p.M + 127) / 128, gn128 = (p.N + 127) / 128;
  const bool scaled = p.a_scale != nullptr;
  const bool b_col_major = p.sbk == 1 && p.sbn != 1;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < gk; ++kb) {
    float sa = 1.0f, inv_a = 1.0f, sb = 1.0f, inv_b = 1.0f;
    if (scaled) {
      int ea = p.a_scale[((long long)bb * gm128 + m0 / 128) * gk + kb];
      int eb = p.b_scale[(long long)kb * gn128 + n0 / kBN];
      sa = pow2_from_exp(ea);
      inv_a = pow2_from_exp(-ea);
      sb = pow2_from_exp(eb);
      inv_b = pow2_from_exp(-eb);
    }
    float part[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) part[i][j] = 0.0f;

    for (int kc = 0; kc < kBK; kc += kKC) {
      const int k0 = kb * kBK + kc;
      // stage the a slice (BM x 32), k fastest: coalesced along a's rows
      for (int idx = tid; idx < BM * kKC; idx += kThreads) {
        int r = idx / kKC, c = idx % kKC;
        int m = m0 + r, k = k0 + c;
        float v = 0.0f;
        if (m < p.M && k < p.K) {
          v = widen(ab[m * p.sam + (long long)k * p.sak]);
          if (scaled) v = __fmul_rn(v, inv_a);
          v = quantize_rne(v, p.f);
        }
        as[c][r] = v;
      }
      // stage the b slice (32 x 128) along b's contiguous dimension
      for (int idx = tid; idx < kKC * kBN; idx += kThreads) {
        int r, c;
        if (b_col_major) { c = idx / kKC; r = idx % kKC; }
        else { r = idx / kBN; c = idx % kBN; }
        int k = k0 + r, n = n0 + c;
        float v = 0.0f;
        if (k < p.K && n < p.N) {
          v = widen(b[(long long)k * p.sbk + (long long)n * p.sbn]);
          if (scaled) v = __fmul_rn(v, inv_b);
          v = quantize_rne(v, p.f);
        }
        bs[r][c] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float av[TM], bv[kTN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
      __syncthreads();
    }

    const float sab_scale = __fmul_rn(sa, sb);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        float pt = part[i][j];
        if (scaled) pt = __fmul_rn(pt, sab_scale);
        if (p.style == kFused) {
          acc[i][j] = __fadd_rn(acc[i][j], pt);
        } else if (p.style == kCascadeFwd) {
          acc[i][j] = __fadd_rn(acc[i][j], quantize_rne(pt, p.f));
        } else {
          acc[i][j] = quantize_rne(__fadd_rn(acc[i][j], quantize_rne(pt, p.f)),
                                   p.f);
        }
      }
  }

  float* ob = out + (long long)bb * p.M * p.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (p.has_out_fmt) v = quantize_rne(v, p.out_f);
      ob[(long long)m * p.N + n] = v;
    }
  }
}

template <int BM, typename TA, typename TB>
void launch_qmm(const void* a, const void* b, void* out, int nbatch,
                const QmmArgs& p, cudaStream_t stream) {
  dim3 grid((p.N + kBN - 1) / kBN, (p.M + BM - 1) / BM, nbatch);
  qmm_kernel<BM, TA, TB><<<grid, kThreads, 0, stream>>>(
      (const TA*)a, (const TB*)b, (float*)out, p);
}

template <typename TA, typename TB>
void launch_qmm_bm(const void* a, const void* b, void* out, int nbatch,
                   const QmmArgs& p, cudaStream_t stream) {
  // decode rows (M <= 16) get a 16-row tile so the b tile is not staged for
  // 64 rows of padding
  if (p.M <= 16) launch_qmm<16, TA, TB>(a, b, out, nbatch, p, stream);
  else launch_qmm<64, TA, TB>(a, b, out, nbatch, p, stream);
}

// dtype codes: 0 = float32, 1 = bfloat16
int qmm_dispatch(const void* a, int a_dtype, const void* b, int b_dtype,
                 void* out, int nbatch, const QmmArgs& p, cudaStream_t s) {
  if (a_dtype == 0 && b_dtype == 0) launch_qmm_bm<float, float>(a, b, out, nbatch, p, s);
  else if (a_dtype == 0 && b_dtype == 1) launch_qmm_bm<float, __nv_bfloat16>(a, b, out, nbatch, p, s);
  else if (a_dtype == 1 && b_dtype == 0) launch_qmm_bm<__nv_bfloat16, float>(a, b, out, nbatch, p, s);
  else if (a_dtype == 1 && b_dtype == 1) launch_qmm_bm<__nv_bfloat16, __nv_bfloat16>(a, b, out, nbatch, p, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale_exp(const void* x, long long s_batch, long long s_row,
                     long long s_col, int rows, int cols, int nbatch, QFmt f,
                     int* out, cudaStream_t s) {
  dim3 grid((cols + 127) / 128, (rows + 127) / 128, nbatch);
  scale_exp_kernel<T><<<grid, kThreads, 0, s>>>((const T*)x, s_batch, s_row,
                                                s_col, rows, cols, f, out);
  return (int)cudaGetLastError();
}

int scale_exp_dispatch(const void* x, int dtype, long long s_batch,
                       long long s_row, long long s_col, int rows, int cols,
                       int nbatch, QFmt f, int* out, cudaStream_t s) {
  if (dtype == 0)
    return launch_scale_exp<float>(x, s_batch, s_row, s_col, rows, cols,
                                   nbatch, f, out, s);
  if (dtype == 1)
    return launch_scale_exp<__nv_bfloat16>(x, s_batch, s_row, s_col, rows,
                                           cols, nbatch, f, out, s);
  return (int)cudaErrorInvalidValue;
}

QmmArgs make_args(long long sab, long long sam, long long sak, long long sbk,
                  long long sbn, int M, int N, int K, int exp_bits,
                  int man_bits, int style, int out_exp_bits,
                  int out_man_bits) {
  QmmArgs p;
  p.sab = sab; p.sam = sam; p.sak = sak; p.sbk = sbk; p.sbn = sbn;
  p.M = M; p.N = N; p.K = K;
  p.f = make_qfmt(exp_bits, man_bits);
  p.has_out_fmt = out_exp_bits > 0;
  p.out_f = p.has_out_fmt ? make_qfmt(out_exp_bits, out_man_bits) : p.f;
  p.style = style;
  p.a_scale = nullptr;
  p.b_scale = nullptr;
  return p;
}

}  // namespace

// K1, and K3 with nbatch = 1 and scaled = 0.  a: (nbatch, M, K) with
// strides (sab, sam, sak); b: (K, N) with strides (sbk, sbn); out: contiguous (nbatch, M, N) f32.  With scaled != 0,
// a_scale (nbatch, ceil(M/128), ceil(K/128)) and b_scale (ceil(K/128),
// ceil(N/128)) are int32 scratch that the pre-pass fills.  out_exp_bits = 0
// means no out_fmt.  Returns the CUDA error of the launches (0 = success).
extern "C" int repro_fused_qmm(const void* a, int a_dtype, long long sab,
                               long long sam, long long sak, const void* b,
                               int b_dtype, long long sbk, long long sbn,
                               void* out, int nbatch, int M, int N, int K,
                               int exp_bits, int man_bits, int style,
                               int out_exp_bits, int out_man_bits, int scaled,
                               void* a_scale, void* b_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  QmmArgs p = make_args(sab, sam, sak, sbk, sbn, M, N, K, exp_bits, man_bits,
                        style, out_exp_bits, out_man_bits);
  if (scaled) {
    int rc = scale_exp_dispatch(a, a_dtype, sab, sam, sak, M, K, nbatch, p.f,
                                (int*)a_scale, s);
    if (rc) return rc;
    rc = scale_exp_dispatch(b, b_dtype, 0, sbk, sbn, K, N, 1, p.f,
                            (int*)b_scale, s);
    if (rc) return rc;
    p.a_scale = (const int*)a_scale;
    p.b_scale = (const int*)b_scale;
  }
  return qmm_dispatch(a, a_dtype, b, b_dtype, out, nbatch, p, s);
}
