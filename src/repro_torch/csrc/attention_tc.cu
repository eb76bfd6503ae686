// Full-sequence attention on the tensor cores: the FlashAttention-2 schedule
// with mma.sync, bf16 or fp16 operands, f32 accumulation and an f32 online
// softmax.
//
// It replaces no TPU kernel.  The JAX package's attention
// (repro/models/attention.py::flash_attention) is plain jnp, which XLA fuses
// into a few passes; the port's plain version (models/attention.py::
// flash_blocks) runs eagerly, materialises every f32 score block in device
// memory, passes over it about ten times and takes both products as f32
// GEMMs on the CUDA cores.  This kernel computes the same function on the
// no-grad path (models/attention.py::flash_attention routes to it).
//
// What it computes, for q (B, Sq, Hq, D), k (B, Sk, Hkv, D) and
// v (B, Sk, Hkv, Dv), q head h reading kv head h / (Hq / Hkv):
//   s = q k^T, an f32 sum of the exact bf16 (or fp16) products;
//   s *= scale (a separate f32 multiplication, as the plain version's);
//   key j is kept for query i (absolute position q_offset + i) when
//     j < kv_len, and j <= q_offset + i if causal, and
//     j > q_offset + i - window if window > 0;
//   online softmax over kv tiles (64 keys; 16 at Dv 256) in f32 registers:
//     m_new = max(m, rowmax of the kept s), m_safe = m_new <= -5e29 ? 0 :
//     m_new,
//     p = exp(s - m_safe) for kept keys and exactly 0 for the others,
//     corr = m > -5e29 ? exp(min(m - m_safe, 0)) : 0, l = l corr + sum p
//     (the unrounded p), acc = acc corr + round(p) v, with p rounded to
//     v's type by round-to-nearest-even (torch's p.to(v.dtype));
//   out = acc / max(l, 1e-30), rounded to q's type: a row that attends
//     nothing gives 0.
// It differs from the plain version only in the f32 sums' order and
// rounding (the tensor cores' f32 accumulation), where the online softmax
// rescales (every kv tile, not every block_k) and in exp (ex2.approx of a
// log2e-scaled argument, within a few f32 ulps).  Two departures follow
// from skipping work: a key the mask excludes contributes exactly 0 (the
// plain version's exp(s - m) * mask gives inf * 0 = NaN for a masked score
// about 88.7 above its row max), and kv tiles that the mask excludes wholly
// (above the causal diagonal, at or past kv_len, before the window) are not
// visited (the plain version multiplies their v by p = 0, so a non-finite v
// there reaches its sum).
//
// Bound on the H100: the two products over the (q, k) pairs the mask
// admits, 2 * B * Hq * P * (D + Dv) operations at the bf16/fp16 tensor-core
// rate (989 TFLOP/s), P the admitted pairs (Sq (Sq + 1) / 2 for a causal
// square); q, k, v and out cross device memory once, far below that.
// Chatglm3-6b's prefill at 4096 positions, 32 heads, D 128: 0.28 ms per
// sequence and layer.
//
// Design: one CTA of 4 warps per (q tile of 64 rows, q head, batch row),
// the q tile the grid's slowest dimension, heaviest causal tiles first, so
// that the first wave holds the longest tiles of every head and row (8-20%
// faster on the H100 than walking each head's tiles in turn); each warp
// owns 16 query rows.  At D <= 128
// q's fragments stay in registers (read once from shared memory with
// ldmatrix) beside the f32 output accumulator, one 16 x 64 f32 score tile
// and its 16-bit repack, at up to 255 registers, so two CTAs share an SM;
// above D 128 q is read from shared memory every tile, and at Dv 256 the
// kv tiles hold 16 keys, so that nothing spills (ptxas -v).  (On the H100,
// 64-row tiles at two CTAs an SM ran 8-12% faster than 128-row tiles of 8
// warps at one.)  k and v tiles are double-buffered in shared memory with
// cp.async (zero-filled past Sk and past the head widths), the next k tile
// copied while s is computed and the next v tile while p v is, each stored
// with its 16-byte pieces XORed by row so that ldmatrix reads hit distinct
// banks.  s is mma.sync.m16n8k16 over q and k (ldmatrix); p stays in
// registers: its f32 accumulator fragments are rounded pairwise into the A
// operand of the p v product, and v is read with ldmatrix.trans.  Masks are
// computed only on tiles that reach the diagonal, kv_len or the window's
// edge.  The output is written from registers straight into (B, Sq, Hq,
// Dv).  Widths are padded to the instantiation's (64, 128, 192 or 256) with
// zeros.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;      // the plain version's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int DK, int DV>
struct Cfg {
  static constexpr int kWarps = 4;
  static constexpr int kBr = 16 * kWarps;  // q rows per CTA
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBc = DV <= 128 ? 64 : 16;  // keys per kv tile
  static constexpr bool kQRegs = DK <= 128;
  static constexpr int kQElems = kBr * DK;
  static constexpr int kKElems = kBc * DK;
  static constexpr int kVElems = kBc * DV;
  static constexpr int kBytes = 2 * (kQElems + 2 * kKElems + 2 * kVElems);
};

struct Args {
  int Sq, Sk, Hq, Hkv, D, Dv;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;  // strides in elements
  float scale;
  int causal, window, q_offset, kv_len;
};

// the element offset of 16-byte piece `chunk` of row `r` in a tile of rows
// `width` elements wide (width a multiple of 64): pieces XORed by r mod 8
__device__ __forceinline__ int swz(int r, int chunk, int width) {
  return r * width + ((chunk ^ (r & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b for a 16 x 16 A (row) and a 16 x 8 B (col) tile, f32 accumulators
template <bool BF16>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (BF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 values rounded (RNE) into one register of the 16-bit type, lo in
// the low half
template <bool BF16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (BF16) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) as 2^(x log2e - m log2e): exp(-inf - m) = 0
__device__ __forceinline__ float exp_shift(float x, float m_log2e) {
  return ex2(fmaf(x, kLog2e, -m_log2e));
}

// copy `ROWS` rows of a (row-major, `stride` apart) operand starting at row
// `row0` into a swizzled tile `WIDTH` wide; rows at or past `nrows` and
// pieces at or past `width` are zero-filled
template <int ROWS, int WIDTH, int THREADS>
__device__ __forceinline__ void load_tile(uint16_t* tile, const uint16_t* src,
                                          long long stride, int row0,
                                          int nrows, int width, int tid) {
  constexpr int kChunks = WIDTH / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    int gr = row0 + r;
    bool ok = gr < nrows && c * 8 < width;
    const uint16_t* g = ok ? src + (long long)gr * stride + c * 8 : src;
    cp_async16(tile + swz(r, c, WIDTH), g, ok);
  }
}

template <int DK, int DV, bool BF16>
__global__ void __launch_bounds__(Cfg<DK, DV>::kThreads, 1)
    attention_tc_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        uint16_t* __restrict__ out, Args a) {
  using C = Cfg<DK, DV>;
  constexpr int kBr = C::kBr, kBc = C::kBc, kNT = kBc / 8, kOT = DV / 8;
  extern __shared__ __align__(128) uint16_t smem[];
  uint16_t* sq = smem;
  uint16_t* sk = sq + C::kQElems;        // two k tiles
  uint16_t* sv = sk + 2 * C::kKElems;    // two v tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * kBr;
  const uint16_t* qg = q + b * a.qb + h * a.qh;
  const uint16_t* kg = k + b * a.kb + hk * a.kh;
  const uint16_t* vg = v + b * a.vb + hk * a.vh;

  // the kv tiles the mask reaches for the CTA's real rows
  const int qlo = a.q_offset + q0;
  const int qhi = a.q_offset + min(q0 + kBr, a.Sq) - 1;
  int kend = a.kv_len, kbeg = 0;
  if (a.causal) kend = min(kend, qhi + 1);
  if (a.window > 0) kbeg = max(0, qlo - a.window + 1);
  const int jt0 = kbeg / kBc;
  const int jt1 = kend > kbeg ? (kend + kBc - 1) / kBc : jt0;

  load_tile<kBr, DK, C::kThreads>(sq, qg, a.qs, q0, a.Sq, a.D, tid);
  cp_async_commit();
  if (jt0 < jt1) {
    load_tile<kBc, DK, C::kThreads>(sk, kg, a.ks, jt0 * kBc, a.Sk, a.D, tid);
  }
  cp_async_commit();
  if (jt0 < jt1) {
    load_tile<kBc, DV, C::kThreads>(sv, vg, a.vs, jt0 * kBc, a.Sk, a.Dv,
                                    tid);
  }
  cp_async_commit();

  float o[kOT][4];
#pragma unroll
  for (int i = 0; i < kOT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // absolute positions of this thread's two rows
  const int pos0 = qlo + warp * 16 + g, pos1 = pos0 + 8;
  const int qrow = warp * 16 + (lane & 15);  // the row this lane addresses

  uint32_t qf[C::kQRegs ? DK / 16 : 1][4];
  if (jt0 < jt1) {
    cp_async_wait<2>();  // q has arrived
    __syncthreads();
    if constexpr (C::kQRegs) {
#pragma unroll
      for (int ks = 0; ks < DK / 16; ++ks)
        ldsm_x4(qf[ks], sq + swz(qrow, ks * 2 + (lane >> 4), DK));
    }
  }

  for (int jt = jt0; jt < jt1; ++jt) {
    const int buf = (jt - jt0) & 1;
    const uint16_t* skb = sk + buf * C::kKElems;
    const uint16_t* svb = sv + buf * C::kVElems;
    cp_async_wait<1>();  // k tile jt has arrived
    __syncthreads();
    if (jt + 1 < jt1) {
      load_tile<kBc, DK, C::kThreads>(sk + (buf ^ 1) * C::kKElems, kg, a.ks,
                                      (jt + 1) * kBc, a.Sk, a.D, tid);
    }
    cp_async_commit();

    // s = q k^T over the 64 keys of the tile
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t af[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = qf[ks][i];
      } else {
        ldsm_x4(af, sq + swz(qrow, ks * 2 + (lane >> 4), DK));
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bf, skb + swz(key, ks * 2 + ((lane >> 3) & 1), DK));
        mma<BF16>(s[2 * np], af, bf[0], bf[1]);
        mma<BF16>(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // scale, mask, row max
    const int k0 = jt * kBc;
    const bool masked = k0 + kBc > a.kv_len ||
                        (a.causal && k0 + kBc - 1 > qlo) ||
                        (a.window > 0 && k0 <= qhi - a.window);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = __fmul_rn(s[nt][i], a.scale);
        if (masked) {
          const int key = k0 + nt * 8 + t4 * 2 + (i & 1);
          const int pos = i < 2 ? pos0 : pos1;
          const bool keep = key < a.kv_len && (!a.causal || key <= pos) &&
                            (a.window <= 0 || key > pos - a.window);
          x = keep ? x : -INFINITY;
        }
        s[nt][i] = x;
        tmax[i >> 1] = fmaxf(tmax[i >> 1], x);
      }
    }
    float corr[2], mlog[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = tmax[r];
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
      const float m_new = fmaxf(m[r], t);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      corr[r] = m[r] > kNegInf / 2 ? ex2((fminf(m[r] - m_safe, 0.f)) * kLog2e)
                                   : 0.f;
      mlog[r] = m_safe * kLog2e;
      m[r] = m_new;
    }

    // p in f32 for l, rounded pairwise into the A fragments of p v
    uint32_t pa[kBc / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float p0 = exp_shift(s[nt][0], mlog[0]);
      const float p1 = exp_shift(s[nt][1], mlog[0]);
      const float p2 = exp_shift(s[nt][2], mlog[1]);
      const float p3 = exp_shift(s[nt][3], mlog[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack2<BF16>(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack2<BF16>(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < kOT; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    cp_async_wait<1>();  // v tile jt has arrived
    __syncthreads();
    if (jt + 1 < jt1) {
      load_tile<kBc, DV, C::kThreads>(sv + (buf ^ 1) * C::kVElems, vg, a.vs,
                                      (jt + 1) * kBc, a.Sk, a.Dv, tid);
    }
    cp_async_commit();

    // o += p v
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < kOT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, svb + swz(key, dp * 2 + (lane >> 4), DV));
        mma<BF16>(o[2 * dp], pa[kk], bf[0], bf[1]);
        mma<BF16>(o[2 * dp + 1], pa[kk], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // flush: acc / max(l, 1e-30) in the operands' type, straight into out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.Sq) continue;
    uint16_t* og =
        out + (((long long)b * a.Sq + rows[r]) * a.Hq + h) * (long long)a.Dv;
#pragma unroll
    for (int i = 0; i < kOT; ++i) {
      const int col = i * 8 + t4 * 2;
      if (col < a.Dv) {
        *reinterpret_cast<uint32_t*>(og + col) =
            pack2<BF16>(__fdiv_rn(o[i][2 * r], l[r]),
                        __fdiv_rn(o[i][2 * r + 1], l[r]));
      }
    }
  }
}

template <int DK, int DV, bool BF16>
int launch(const void* q, const void* k, const void* v, void* out, int nb,
           const Args& a, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  auto kernel = attention_tc_kernel<DK, DV, BF16>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return (int)e;
  // the q tile is the slowest dimension: the first wave takes the longest
  // causal tiles of every (head, row)
  dim3 grid(a.Hq, nb, (a.Sq + C::kBr - 1) / C::kBr);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
      (uint16_t*)out, a);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_widths(const void* q, const void* k, const void* v, void* out,
                  int nb, const Args& a, cudaStream_t st) {
  if (a.D <= 64 && a.Dv <= 64) return launch<64, 64, BF16>(q, k, v, out, nb, a, st);
  if (a.D <= 128 && a.Dv <= 128)
    return launch<128, 128, BF16>(q, k, v, out, nb, a, st);
  if (a.D <= 192 && a.Dv <= 128)
    return launch<192, 128, BF16>(q, k, v, out, nb, a, st);
  return launch<256, 256, BF16>(q, k, v, out, nb, a, st);
}

}  // namespace

// q (nb, Sq, Hq, D), k (nb, Sk, Hkv, D), v (nb, Sk, Hkv, Dv), each with unit
// last stride, 16-byte aligned rows, its other strides (batch, position,
// head) in elements; out (nb, Sq, Hq, Dv) contiguous.  All of one type
// (bf16 = 1: bfloat16, else float16); D and Dv multiples of 16 up to 256;
// Hq a multiple of Hkv; 0 <= kv_len <= Sk; window = 0 no window.  Returns a
// cudaError_t.
extern "C" int repro_attention_tc(
    const void* q, const void* k, const void* v, void* out, int bf16, int nb,
    int Sq, int Sk, int Hq, int Hkv, int D, int Dv, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, float scale, int causal,
    int window, int q_offset, int kv_len, void* stream) {
  if (D < 16 || D > 256 || D % 16 || Dv < 16 || Dv > 256 || Dv % 16 ||
      Hkv < 1 || Hq % Hkv != 0 || nb > 65535 || Sq > 65535 * 64 ||
      kv_len < 0 ||
      kv_len > Sk || window < 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || Sq <= 0 || Hq <= 0) return 0;
  Args a;
  a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.Dv = Dv;
  a.qb = qb; a.qs = qs; a.qh = qh; a.kb = kb; a.ks = ks; a.kh = kh;
  a.vb = vb; a.vs = vs; a.vh = vh;
  a.scale = scale; a.causal = causal; a.window = window;
  a.q_offset = q_offset; a.kv_len = kv_len;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return launch_widths<true>(q, k, v, out, nb, a, st);
  return launch_widths<false>(q, k, v, out, nb, a, st);
}
