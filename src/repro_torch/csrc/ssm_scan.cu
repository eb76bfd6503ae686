// K5 and K6: the selective scan (the Mamba recurrence) with optionally
// format-rounded operands.
//
// Replaces the TPU kernels
//   repro/kernels/fused.py::ssm_scan_quantized  (pallas_call at :614; body
//     _ssm_scan_quant_kernel :562), K5;
//   repro/kernels/ssm_scan.py::ssm_scan         (pallas_call at :74; body
//     _ssm_scan_kernel :34), K6, which is K5 with no rounding and shares
//     this file's device code (identity formats).
//
// What it computes, for a, b (B, S, D, N) and c (B, S, N), all f32:
//   per token s: a, b and c rounded to `fmt` (the identity for K6);
//   h = a * h + b in an f32 state of N values per (batch, d) row;
//   y[b, s, d] = sum over n = 0..N-1, left to right, of h[n] * c[n],
//   rounded to `out_fmt` if one is given;
//   h_last[b, d, :] = h after the last token.
// The recurrence and the readout use __fmul_rn/__fadd_rn so that nvcc
// cannot contract them into FMAs, and the readout sums n in a fixed order:
// the plain PyTorch versions (kernels/ssm_scan.py, kernels/fused.py) run the
// same rounded ops in the same order, so the kernel is bitwise equal to them.
//
// Bound on the H100: bytes.  Each (b, s, d, n) element of a and b is read
// once for four flops of the recurrence and readout (plus the rounding), so
// the least time is the bytes of a, b, c, y and h_last over 3.35 TB/s.
//
// Design: the TPU grid (B, D/bd, S/chunk) with the chunk axis sequential in
// VMEM is not carried over.  One thread owns one (b, d) row, keeps its N
// states in registers and loops over S; a warp's 32 rows of one step are 32
// adjacent 64-byte runs of a and of b (N = 16), read as float4 vectors, and
// the next step's a and b are loaded before this step's arithmetic so that
// one step's loads are in flight while the previous one computes.  c[b, s]
// is the same for every row of a batch and comes through the cache; y is
// written per step (one coalesced 128-byte store per warp) and h_last once.
// `chunk` and `bd` only validate shapes in the wrappers, as in the JAX
// package.  N = 16 (falcon-mamba-7b) and N = 8 (the reduced configs) take
// this vectorised kernel; any other N runs a scalar variant with the same
// op order.
#include "quantize.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
struct Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         Vec<N>& out) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float4 t = __ldg(p4 + i);
    out.v[4 * i] = t.x;
    out.v[4 * i + 1] = t.y;
    out.v[4 * i + 2] = t.z;
    out.v[4 * i + 3] = t.w;
  }
}

// One step of one row: round the operands, update the state, read out.
template <int N>
__device__ __forceinline__ float step(float* h, const Vec<N>& a,
                                      const Vec<N>& b,
                                      const float* __restrict__ c, QFmt f) {
  float y = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float an = quantize_rne(a.v[n], f);
    float bn = quantize_rne(b.v[n], f);
    float cn = quantize_rne(__ldg(c + n), f);
    h[n] = __fadd_rn(__fmul_rn(an, h[n]), bn);
    float p = __fmul_rn(h[n], cn);
    y = n == 0 ? p : __fadd_rn(y, p);
  }
  return y;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_vec_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, float* __restrict__ y,
                    float* __restrict__ h_last, int nb, int s_len, int d_len,
                    QFmt f, int round_out, QFmt fo) {
  long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= (long long)nb * d_len) return;
  const long long bi = row / d_len, d = row % d_len;
  const long long step_ab = (long long)d_len * N;  // a, b: one token
  const float* pa = a + (bi * s_len * d_len + d) * N;
  const float* pb = b + (bi * s_len * d_len + d) * N;
  const float* pc = c + bi * s_len * N;
  float* py = y + bi * s_len * d_len + d;
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.0f;
  Vec<N> an, bn;
  load_row<N>(pa, an);
  load_row<N>(pb, bn);
  for (int s = 0; s < s_len; ++s) {
    Vec<N> a_cur = an, b_cur = bn;
    if (s + 1 < s_len) {  // the next step's loads go out first
      load_row<N>(pa + (s + 1) * step_ab, an);
      load_row<N>(pb + (s + 1) * step_ab, bn);
    }
    float out = step<N>(h, a_cur, b_cur, pc + (long long)s * N, f);
    if (round_out) out = quantize_rne(out, fo);
    py[(long long)s * d_len] = out;
  }
  float4* ph = reinterpret_cast<float4*>(h_last + row * N);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    ph[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
}

// Any N: scalar loads, the state in local memory, the same op order.
__global__ void __launch_bounds__(kThreads)
ssm_scan_any_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, float* __restrict__ y,
                    float* __restrict__ h_last, int nb, int s_len, int d_len,
                    int n_len, QFmt f, int round_out, QFmt fo) {
  constexpr int kMaxN = 256;
  long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= (long long)nb * d_len) return;
  const long long bi = row / d_len, d = row % d_len;
  float h[kMaxN];
  for (int n = 0; n < n_len; ++n) h[n] = 0.0f;
  for (int s = 0; s < s_len; ++s) {
    const long long base = ((bi * s_len + s) * d_len + d) * n_len;
    const float* pc = c + (bi * s_len + s) * n_len;
    float out = 0.0f;
    for (int n = 0; n < n_len; ++n) {
      float an = quantize_rne(a[base + n], f);
      float bn = quantize_rne(b[base + n], f);
      float cn = quantize_rne(pc[n], f);
      h[n] = __fadd_rn(__fmul_rn(an, h[n]), bn);
      float p = __fmul_rn(h[n], cn);
      out = n == 0 ? p : __fadd_rn(out, p);
    }
    if (round_out) out = quantize_rne(out, fo);
    y[(bi * s_len + s) * d_len + d] = out;
  }
  for (int n = 0; n < n_len; ++n) h_last[row * n_len + n] = h[n];
}

template <int N>
void launch_vec(const float* a, const float* b, const float* c, float* y,
                float* h, int nb, int s_len, int d_len, QFmt f, int round_out,
                QFmt fo, unsigned blocks, cudaStream_t stream) {
  ssm_scan_vec_kernel<N><<<blocks, kThreads, 0, stream>>>(
      a, b, c, y, h, nb, s_len, d_len, f, round_out, fo);
}

}  // namespace

// a, b: (nb, s_len, d_len, n_len) f32 contiguous, 16-byte aligned; c:
// (nb, s_len, n_len); y: (nb, s_len, d_len); h_last: (nb, d_len, n_len).
// fmt (exp_bits, man_bits) = (8, 23) is the identity (K6, or K5 with
// fmt=None); out_exp = 0 means no out_fmt.  Returns a cudaError_t.
extern "C" int repro_ssm_scan(const void* a, const void* b, const void* c,
                              void* y, void* h_last, int nb, int s_len,
                              int d_len, int n_len, int exp_bits,
                              int man_bits, int out_exp, int out_man,
                              void* stream) {
  if (n_len > 256) return (int)cudaErrorInvalidValue;
  long long rows = (long long)nb * d_len;
  if (rows <= 0 || s_len <= 0 || n_len <= 0) return 0;
  unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  QFmt f = make_qfmt(exp_bits, man_bits);
  int round_out = out_exp > 0;
  QFmt fo = round_out ? make_qfmt(out_exp, out_man) : make_qfmt(8, 23);
  const float *pa = (const float*)a, *pb = (const float*)b,
              *pc = (const float*)c;
  float *py = (float*)y, *ph = (float*)h_last;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_len) {
    case 8: launch_vec<8>(pa, pb, pc, py, ph, nb, s_len, d_len, f, round_out,
                          fo, blocks, st); break;
    case 16: launch_vec<16>(pa, pb, pc, py, ph, nb, s_len, d_len, f,
                            round_out, fo, blocks, st); break;
    default:
      ssm_scan_any_kernel<<<blocks, kThreads, 0, st>>>(
          pa, pb, pc, py, ph, nb, s_len, d_len, n_len, f, round_out, fo);
  }
  return (int)cudaGetLastError();
}
