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
// cannot contract them into FMAs, and the readout sums n in a fixed order
// that starts from the first product (which keeps the sign of -0): the plain
// PyTorch versions (kernels/ssm_scan.py, kernels/fused.py) run the same
// rounded ops in the same order, so the kernel is bitwise equal to them.
//
// Bound on the H100: bytes.  Each (b, s, d, n) element of a and b is read
// once for four flops of the recurrence and readout (plus the rounding), so
// the least time is the bytes of a, b, c, y and h_last over 3.35 TB/s.  The
// recurrence is sequential in s and the readout's order is fixed, so the
// parallelism is the B x D x N independent state chains.
//
// Design (N = 8 and 16, `ssm_scan_lanes_kernel`): the TPU grid (B, D/bd,
// S/chunk) with the chunk axis sequential in VMEM is not carried over.
//   - Lanes.  N/4 lanes own one (b, d) row, each lane four of its states
//     in registers (one float4 of a and one of b a step), so a block's
//     threads read one contiguous run of a (and of b) per step: rows x N x
//     4 bytes, 512 bytes a warp.  The grid runs over (d-block, batch), so
//     no block straddles two batches; the last d-block is predicated.
//   - A deep prefetch.  Each lane copies its own float4s of a and b with
//     16-byte cp.async into a shared-memory ring kDepth steps deep and
//     waits for its own copies only (no block barrier): kDepth - 1 steps of
//     every row are in flight while one computes.
//   - The readout's order across lanes.  Each lane multiplies its states by
//     c; lane 0 sums its four products from the first, and the partial sum
//     passes by __shfl_up_sync to the next lane, which adds its four: the
//     one left-to-right chain of the plain version.  The row's last lane
//     rounds y to `out_fmt` and stores it; each lane stores its float4 of
//     h_last.
//   - Rounding by multiplication (quantize_rne_mul, bitwise quantize_rne).
//     c[b, s, :] is the same for every row of a batch: each block rounds
//     kCSteps steps of it at a time into shared memory, not once a row.
//     K6 (and K5 with fmt=None) is the kRound = 0 instantiation, with no
//     rounding code at all.
// `chunk` and `bd` only validate shapes in the wrappers, as in the JAX
// package.  The host planner (kernels/ssm_scan.py::plan_scan) picks the
// rows a block takes.
#include "quantize.cuh"

// steps of a and b in the ring (scripts/scan_sweep.py builds other depths)
#ifndef SSM_SCAN_DEPTH
#define SSM_SCAN_DEPTH 8
#endif

namespace {

constexpr int kThreads = 128;  // the most threads a lanes block has
constexpr int kDepth = SSM_SCAN_DEPTH;
constexpr int kCSteps = 64;    // steps of rounded c a block holds at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int kRound>
__device__ __forceinline__ float rnd(float x, const QFmt& f) {
  return kRound ? quantize_rne_mul(x, f) : x;
}

// The shared memory of a lanes block of `threads` threads, in bytes: the
// ring (kDepth steps of a float4 of a and one of b per thread), then kCSteps
// steps of rounded c.
constexpr int lanes_smem_bytes(int threads, int n) {
  return kDepth * 2 * threads * 16 + kCSteps * n * 4;
}

template <int N, int kRound>
__global__ void __launch_bounds__(kThreads)
ssm_scan_lanes_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c, float* __restrict__ y,
                      float* __restrict__ h_last, int s_len, int d_len,
                      QFmt f, int round_out, QFmt fo) {
  constexpr int L = N / 4;  // lanes a row
  extern __shared__ float4 smem[];
  const int threads = blockDim.x, t = threadIdx.x, sub = t % L;
  float4* ring = smem;  // [kDepth][a, b][threads]
  float* cs = reinterpret_cast<float*>(smem + kDepth * 2 * threads);
  const long long bi = blockIdx.y;
  const long long d = (long long)blockIdx.x * (threads / L) + t / L;
  const bool valid = d < d_len;
  const long long step_ab = (long long)d_len * N;  // a, b: one token
  const long long off = (bi * s_len * d_len + d) * N + 4 * sub;
  const float* pa = a + off;
  const float* pb = b + off;
  const float* pc = c + bi * s_len * N;
  float* py = y + bi * s_len * d_len + d;

  // step s's float4s of a and b into ring stage s % kDepth; one commit
  // group a step, empty past the end, so that the count of groups in
  // flight is the same on every thread and step
  auto prefetch = [&](int s) {
    if (valid && s < s_len) {
      float4* st = ring + (s % kDepth) * 2 * threads;
      cp_async16(st + t, pa + s * step_ab);
      cp_async16(st + threads + t, pb + s * step_ab);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kDepth - 1; ++j) prefetch(j);

  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f, h3 = 0.0f;
  for (int s = 0; s < s_len; ++s) {
    if (s % kCSteps == 0) {  // the next kCSteps steps of c, rounded
      __syncthreads();       // every thread is done with the last ones
      const long long base = (long long)s * N, end = (long long)s_len * N;
      for (int i = t; i < kCSteps * N; i += threads)
        cs[i] = base + i < end ? rnd<kRound>(__ldg(pc + base + i), f) : 0.0f;
      __syncthreads();
    }
    prefetch(s + kDepth - 1);
    cp_async_wait<kDepth - 1>();  // this thread's copies of step s landed
    const float4* st = ring + (s % kDepth) * 2 * threads;
    const float4 av = st[t], bv = st[threads + t];
    const float4 cv =
        reinterpret_cast<const float4*>(cs)[(s % kCSteps) * L + sub];
    h0 = __fadd_rn(__fmul_rn(rnd<kRound>(av.x, f), h0), rnd<kRound>(bv.x, f));
    h1 = __fadd_rn(__fmul_rn(rnd<kRound>(av.y, f), h1), rnd<kRound>(bv.y, f));
    h2 = __fadd_rn(__fmul_rn(rnd<kRound>(av.z, f), h2), rnd<kRound>(bv.z, f));
    h3 = __fadd_rn(__fmul_rn(rnd<kRound>(av.w, f), h3), rnd<kRound>(bv.w, f));
    const float p0 = __fmul_rn(h0, cv.x), p1 = __fmul_rn(h1, cv.y),
                p2 = __fmul_rn(h2, cv.z), p3 = __fmul_rn(h3, cv.w);
    // lane 0 starts the chain from its first product; lane k > 0 adds its
    // four products to lane k - 1's sum
    float out = __fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3);
#pragma unroll
    for (int k = 1; k < L; ++k) {
      const float in = __shfl_up_sync(0xffffffffu, out, 1, L);
      if (sub == k)
        out = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(in, p0), p1), p2), p3);
    }
    if (valid && sub == L - 1) {
      if (round_out) out = quantize_rne_mul(out, fo);
      py[(long long)s * d_len] = out;
    }
  }
  if (valid)
    reinterpret_cast<float4*>(h_last + (bi * d_len + d) * N)[sub] =
        make_float4(h0, h1, h2, h3);
}

// Any N: one thread a row, scalar loads, the state in local memory, the same
// op order.  Not redesigned for the H100 (no configuration has such an N;
// only the checks at N = 5 reach it): it keeps the first port's schedule and
// the division form of the rounding, which is bitwise the multiplication
// form.
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
int launch_lanes(const float* a, const float* b, const float* c, float* y,
                 float* h, int nb, int s_len, int d_len, int rows, QFmt f,
                 int round_out, QFmt fo, cudaStream_t stream) {
  const int threads = rows * (N / 4);
  if (rows < 1 || threads > kThreads || threads % 32 != 0 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d_len + rows - 1) / rows), (unsigned)nb);
  const int smem = lanes_smem_bytes(threads, N);
  if (f.identity)
    ssm_scan_lanes_kernel<N, 0><<<grid, threads, smem, stream>>>(
        a, b, c, y, h, s_len, d_len, f, round_out, fo);
  else
    ssm_scan_lanes_kernel<N, 1><<<grid, threads, smem, stream>>>(
        a, b, c, y, h, s_len, d_len, f, round_out, fo);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (nb, s_len, d_len, n_len) f32 contiguous, 16-byte aligned; c:
// (nb, s_len, n_len); y: (nb, s_len, d_len); h_last: (nb, d_len, n_len).
// fmt (exp_bits, man_bits) = (8, 23) is the identity (K6, or K5 with
// fmt=None); out_exp = 0 means no out_fmt.  `rows` is the (b, d) rows of a
// block of the lanes kernel (N = 8 and 16), from plan_scan; other N ignore
// it.  Returns a cudaError_t.
extern "C" int repro_ssm_scan(const void* a, const void* b, const void* c,
                              void* y, void* h_last, int nb, int s_len,
                              int d_len, int n_len, int exp_bits,
                              int man_bits, int out_exp, int out_man,
                              int rows, void* stream) {
  if (n_len > 256) return (int)cudaErrorInvalidValue;
  long long all_rows = (long long)nb * d_len;
  if (all_rows <= 0 || s_len <= 0 || n_len <= 0) return 0;
  QFmt f = make_qfmt(exp_bits, man_bits);
  int round_out = out_exp > 0;
  QFmt fo = round_out ? make_qfmt(out_exp, out_man) : make_qfmt(8, 23);
  const float *pa = (const float*)a, *pb = (const float*)b,
              *pc = (const float*)c;
  float *py = (float*)y, *ph = (float*)h_last;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_len) {
    case 8:
      return launch_lanes<8>(pa, pb, pc, py, ph, nb, s_len, d_len, rows, f,
                             round_out, fo, st);
    case 16:
      return launch_lanes<16>(pa, pb, pc, py, ph, nb, s_len, d_len, rows, f,
                              round_out, fo, st);
    default: {
      unsigned blocks = (unsigned)((all_rows + kThreads - 1) / kThreads);
      ssm_scan_any_kernel<<<blocks, kThreads, 0, st>>>(
          pa, pb, pc, py, ph, nb, s_len, d_len, n_len, f, round_out, fo);
      return (int)cudaGetLastError();
    }
  }
}
