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
// The contract is exact equality with the plain version: each output's
// partial dot over one k block is one chain of fmaf in k order from +0.0f
// over the rounded operands (the zero padding past K included), and the
// dequant and the fold use __fmul_rn/__fadd_rn in k-block order, so nvcc
// cannot contract them.  A k block is therefore never split across threads;
// the k blocks of one output may run in different thread blocks, because
// the fold is a separate sequential step.
//
// Bound on the H100: the rounded operands are exact in bf16, fp16 or fp8,
// so the least time for the work is 2MKN operations at that type's
// tensor-core rate (989 TFLOP/s for bf16); the decode shapes (M <= 16) read
// each weight once for a handful of rows and are bound by the bytes of b.
// The products stay f32 FMAs on the CUDA cores (67 TFLOP/s peak) to keep an
// IEEE f32 partial dot, so the prefill shapes stay well above that bound.
// On the CUDA cores the tiled kernel is bound by FFMA issue and by the
// registers that feed it: an 8 x 8 register tile makes 4 LDS.128 feed 64
// FFMA (shared-memory bandwidth is not the limit: a warp's lanes read 64
// and 128 contiguous bytes), but its 64 partial dots and 16 fragment
// registers leave no room under the 128 registers a thread that two blocks
// of 8 warps per SM allow for a second set of accumulators, so those live
// in shared memory.  One block of 8 warps per SM with both sets in
// registers (up to 255 a thread) measured slower: too few warps to hide the
// slices' copies, rounding and barriers (PERF.md).
//
// Design: the host planner (kernels/fused.py::plan_qmm) picks one of three
// schedules and its tile, and passes them in.
//   whole       qmm_tile_kernel<BM>: one thread block per (batch, BM x 128
//               output tile) walks every k block in order; BM is 128, or 64
//               where a grid of 128-row tiles would leave the card part
//               idle.  256 threads, each with a BM / 16 x 8 register tile
//               of partial dots read from shared memory as float4 (a and b
//               both k-major); each folds its partial dots into its own
//               accumulators in shared memory at the end of each k block.
//               k slices (8 deep at BM 128, 16 at 64) are copied with
//               cp.async into a ring of three raw slices and rounded once
//               into one of two f32 buffers; slice s + 1 is rounded between
//               the same two barriers as slice s is multiplied, and two
//               thread blocks share an SM.
//   split_tile  the same kernel with one k block per thread block (grid z =
//               k block x batch): prefill shapes whose tile grid would leave
//               the card idle (small N).
//   split_rows  qmm_rows_kernel for M <= 16 (decode): grid (n tile of BN
//               columns, k block, batch).  The block keeps its M rounded
//               rows of a in shared memory, copies its 128 x BN tile of b
//               with cp.async along b's contiguous dimension (the unembed's
//               table.T is contiguous along k and is read in place), and
//               runs M chains per column.  Each thread rounds the b column
//               it reads, so a b element is rounded by each of the
//               min(128 / BN, M) threads of its column: once at BN = 128,
//               up to 8 times at BN = 16.  No padding rows are computed.
//               (A variant that rounded the b tile once into shared memory
//               as f32 fits 3 blocks per SM instead of 6 at BN = 128 and
//               measured slower on the bf16 decode path; PERF.md.)
// Both split schedules write each k block's dequantised part (before the
// style) to a workspace (gk, B, M, N) that the caller allocates, and
// qmm_fold_kernel then folds the parts of each output in k-block order and
// applies out_fmt.  With `scaled`, a pre-pass writes each logical 128 x 128
// tile's scale exponent; every tile of every schedule lies inside one
// logical tile, so the scale is that of the TPU tile.  Rounding uses
// quantize_rne_mul (bitwise quantize_rne with multiplications), and is
// skipped for an unscaled bf16 operand when the format holds every bf16
// value (exp_bits 8, man_bits >= 7), where it is the identity.
#include <cuda_bf16.h>
#include <stdint.h>

#include "quantize.cuh"

namespace {

constexpr int kBK = 128;          // the k block: the styles round at its edges
constexpr int kTileThreads = 256;  // the tiled kernel's threads: 8 warps
constexpr int kTileBN = 128;      // output tile width of the tiled kernel
constexpr int kRowsThreads = 128;
constexpr int kPadA = 4;          // row pad of the rows kernel's a (floats)
constexpr int kScaleThreads = 256;

enum Style { kFused = 0, kCascade = 1, kCascadeFwd = 2 };
enum Schedule { kWhole = 0, kSplitRows = 1, kSplitTile = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `valid` are zero-filled (src is not read when valid == 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chunk of 16 bytes (V elements) of an operand into shared memory, the
// elements past `valid` zero: with cp.async when the operand's base and row
// strides are 16-byte aligned (`vec`), else with plain loads.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int valid,
                                           bool vec, const T* base) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    cp_async16(dst, valid > 0 ? src : base, valid * (int)sizeof(T));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : T(0.0f);
  }
}

// One block per logical 128 x 128 tile of a (rows x cols) matrix in each of
// `nbatch` slices: out[batch][tile_r][tile_c] = the tile's scale exponent.
template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
scale_exp_kernel(const T* __restrict__ x, long long s_batch, long long s_row,
                 long long s_col, int rows, int cols, QFmt f,
                 int* __restrict__ out) {
  const int tr = blockIdx.y, tc = blockIdx.x, bb = blockIdx.z;
  const T* xb = x + bb * s_batch;
  unsigned m = 0;
  for (int idx = threadIdx.x; idx < 128 * 128; idx += kScaleThreads) {
    int r = tr * 128 + idx / 128, c = tc * 128 + idx % 128;
    if (r < rows && c < cols) {
      float v = widen(xb[r * s_row + c * s_col]);
      m = max(m, abs_bits(v));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_max[kScaleThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kScaleThreads / 32; ++w) m = max(m, warp_max[w]);
    out[((long long)bb * gridDim.y + tr) * gridDim.x + tc] = tile_scale_exp(m, f);
  }
}

struct QmmArgs {
  long long sab, sam;  // a strides: batch, row (contiguous along k)
  long long sbk, sbn;  // b strides: k, column
  int nb, M, N, K, gk;
  QFmt f, out_f;
  int has_out_fmt, style;
  int skip_a, skip_b;  // the operand's rounding is the identity
  int b_col;           // b contiguous along k (else along n)
  int vec;             // 16-byte aligned bases and row strides
  const int* a_scale;  // (batch, ceil(M/128), gk) or null when unscaled
  const int* b_scale;  // (gk, ceil(N/128)) or null when unscaled
};

// The scale of the logical tiles holding rows m0.. and columns n0.. at k
// block kb: (sa, 1/sa, sb, 1/sb), all ones when unscaled.
struct Scales {
  float sa, inv_a, sb, inv_b;
};

__device__ __forceinline__ Scales scales_at(const QmmArgs& p, int bb, int m0,
                                            int n0, int kb) {
  Scales s{1.0f, 1.0f, 1.0f, 1.0f};
  if (p.a_scale != nullptr) {
    int gm128 = (p.M + 127) / 128, gn128 = (p.N + 127) / 128;
    int ea = p.a_scale[((long long)bb * gm128 + m0 / 128) * p.gk + kb];
    int eb = p.b_scale[(long long)kb * gn128 + n0 / 128];
    s.sa = pow2_from_exp(ea);
    s.inv_a = pow2_from_exp(-ea);
    s.sb = pow2_from_exp(eb);
    s.inv_b = pow2_from_exp(-eb);
  }
  return s;
}

__device__ __forceinline__ float round_operand(float v, float inv, bool scaled,
                                               bool skip, const QFmt& f) {
  if (scaled) v = __fmul_rn(v, inv);
  return skip ? v : quantize_rne_mul(v, f);
}

// One k block's dequantised part folded into the accumulator by style.
__device__ __forceinline__ float fold(float acc, float pt, const QmmArgs& p) {
  if (p.style == kFused) return __fadd_rn(acc, pt);
  if (p.style == kCascadeFwd) return __fadd_rn(acc, quantize_rne_mul(pt, p.f));
  return quantize_rne_mul(__fadd_rn(acc, quantize_rne_mul(pt, p.f)), p.f);
}

// ---------------------------------------------------------------------------
// whole and split_tile: register-tiled, BM x 128 outputs per thread block
// ---------------------------------------------------------------------------
// Each row tile's k slice, raw slices in its ring and thread blocks per SM
// (128 registers a thread at most; shared memory for two blocks with bf16
// operands: 92 KB at 128 rows, 83 KB at 64; scripts/qmm_sweep.py and
// PERF.md hold the readings that chose them)
template <int BM>
struct TileCfg;
template <>
struct TileCfg<128> {
  static constexpr int KC = 8, STAGES = 3, PER_SM = 2;
};
template <>
struct TileCfg<64> {
  static constexpr int KC = 16, STAGES = 3, PER_SM = 2;
};

// bytes rounded up to an odd number of 16-byte units: rows that far apart
// put 16-byte reads of 8 consecutive rows on 32 different banks
__host__ __device__ constexpr int odd16(int bytes) {
  return ((bytes + 15) / 16 | 1) * 16;
}

template <int BM, typename TA, typename TB>
struct TileSmem {
  static constexpr int KC = TileCfg<BM>::KC, STAGES = TileCfg<BM>::STAGES;
  static constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
  static constexpr int LDA = odd16(KC * sizeof(TA)) / sizeof(TA);  // raw a row
  static constexpr int LDB = odd16(KC * sizeof(TB)) / sizeof(TB);  // raw b col
  static constexpr int RAW_B = KC * kTileBN > kTileBN * LDB ? KC * kTileBN
                                                            : kTileBN * LDB;
  static constexpr int RAW_A_BYTES = BM * LDA * sizeof(TA);
  static constexpr int RAW_B_BYTES = RAW_B * sizeof(TB);
  static constexpr int RAW_BYTES = RAW_A_BYTES + RAW_B_BYTES;
  static constexpr int ACC_BYTES = BM * kTileBN * sizeof(float);
  static constexpr int CA_BYTES = KC * BM * sizeof(float);       // ca[k][m]
  static constexpr int CB_BYTES = KC * kTileBN * sizeof(float);  // cb[k][n]
  static constexpr int C_BYTES = CA_BYTES + CB_BYTES;
  // 16-byte chunks of a slice: a's first, then b's
  static constexpr int A_CHUNKS = BM * KC / VA, B_CHUNKS = KC * kTileBN / VB;
  static constexpr int CHUNK_ITERS =
      (A_CHUNKS + B_CHUNKS + kTileThreads - 1) / kTileThreads;
  // the accumulators, two rounded slices, STAGES raw slices in flight
  static constexpr int BYTES = ACC_BYTES + 2 * C_BYTES + STAGES * RAW_BYTES;
};

// One raw chunk of V elements widened, and rounded unless `skip`.
template <typename T>
__device__ __forceinline__ void round_chunk(const T* src, float* w, float inv,
                                            bool scaled, bool skip,
                                            const QFmt& f) {
  constexpr int V = 16 / sizeof(T);
  alignas(16) T v[V];
  *(uint4*)v = *(const uint4*)src;
  if (skip) {
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = widen(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      w[j] = round_operand(widen(v[j]), inv, scaled, false, f);
  }
}

// A thread's TM x TN outputs into dst (M, N): rows r + 16 g + i, columns
// c + 32 h + j, as float4 where the rows of dst are 16-byte aligned.
template <int TM, int TN>
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float (&v)[TM][TN],
                                           const QmmArgs& p, int r, int c) {
  const bool vec4 = p.N % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = r + 16 * (i / 4) + i % 4;
    if (m >= p.M) continue;
    float* row = dst + (long long)m * p.N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = c + 32 * h;
      if (vec4 && n < p.N) {
        *(float4*)(row + n) = make_float4(v[i][4 * h], v[i][4 * h + 1],
                                          v[i][4 * h + 2], v[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.N) row[n + j] = v[i][4 * h + j];
      }
    }
  }
}

// The 8 warps tile the block's outputs 4 (rows) x 2 (columns), each warp
// BM / 4 x 64 with its lanes 4 x 8.  Lane (ly, lx) of a warp owns rows
// 4 ly + 16 g + i (g < BM / 64, i < 4) and columns 4 lx + 32 h + j (h < 2,
// j < 4) of the warp's tile, so at each k it reads its rows and columns of
// the rounded slice as BM / 64 + 2 float4 from ca[k][m] and cb[k][n], and
// the lanes of a warp read 64 and 128 contiguous bytes (no bank conflict).
// A thread's partial dots stay in registers; its accumulators live in
// shared memory, where it alone reads and folds them once per k block.
// Each k slice goes global -> raw (cp.async, the ring's slices in flight)
// -> rounded (two buffers) -> registers; the rounding of slice s + 1 and
// the products of slice s run between the same two barriers.
template <int BM, typename TA, typename TB>
__global__ void __launch_bounds__(kTileThreads, TileCfg<BM>::PER_SM)
qmm_tile_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                float* __restrict__ out, const QmmArgs p, int split) {
  using S = TileSmem<BM, TA, TB>;
  constexpr int BN = kTileBN, KC = S::KC, STAGES = S::STAGES;
  constexpr int RG = BM / 64;  // groups of 4 rows per thread
  constexpr int TM = 4 * RG;   // rows per thread
  constexpr int TN = 8;        // columns per thread
  constexpr int VA = S::VA, VB = S::VB;
  constexpr int SPB = kBK / KC;  // slices per k block
  static_assert(BM == 64 || BM == 128, "the row tile");
  static_assert(kBK % KC == 0 && KC % VA == 0 && KC % VB == 0, "slice");
  static_assert(S::A_CHUNKS % 32 == 0, "a warp copies one operand");
  static_assert(STAGES >= 2, "round s + 1 while s + 2 lands");
  extern __shared__ __align__(16) unsigned char smem[];
  // [accumulators | rounded slice 0 | rounded slice 1 | raw slice 0 | ...]
  float4* accs = (float4*)smem;  // accs[q][thread], q < TM * TN / 4
  unsigned char* cbase = smem + S::ACC_BYTES;
  auto ca = [&](int i) { return (float*)(cbase + (i & 1) * S::C_BYTES); };
  auto cb = [&](int i) {
    return (float*)(cbase + (i & 1) * S::C_BYTES + S::CA_BYTES);
  };
  unsigned char* raw_base = cbase + 2 * S::C_BYTES;  // + slot * RAW_BYTES

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = (warp % 4) * (BM / 4) + 4 * (lane / 8);  // + 16 g + i
  const int col0 = (warp / 4) * 64 + 4 * (lane % 8);        // + 32 h + j
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int bb = blockIdx.z % p.nb;
  const int kb_begin = split ? blockIdx.z / p.nb : 0;
  const int kb_end = split ? kb_begin + 1 : p.gk;
  const int slices = (kb_end - kb_begin) * SPB;
  const bool scaled = p.a_scale != nullptr;
  const bool vec = p.vec;

  // This thread's 16-byte chunks of every slice, fixed for the whole k
  // loop (kind 0: a, 1: b along n, 2: b along k, -1: none; one kind per
  // warp): where the copy reads the first slice and lands in a raw slice,
  // the k (or k rows) left inside the operand from there (lim, advanced by
  // KC a slice; -2^30 for a row or column past the end), and where the
  // rounding reads the raw chunk and writes it to ca or cb.
  constexpr int IT = S::CHUNK_ITERS;
  int kind[IT], lim[IT], nval[IT], dst[IT], roff[IT], woff[IT];
  const unsigned char* src[IT];
  {
    const int k_first = kb_begin * kBK;
    const TA* ab = a + bb * p.sab;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int ch = tid + it * kTileThreads;
      kind[it] = -1;
      lim[it] = nval[it] = dst[it] = roff[it] = woff[it] = 0;
      src[it] = (const unsigned char*)a;
      if (ch < S::A_CHUNKS) {
        const int r = ch / (KC / VA), kc = (ch % (KC / VA)) * VA;
        const int rr = ch % BM, kr = (ch / BM) * VA;  // the rounding's
        kind[it] = 0;
        lim[it] = m0 + r < p.M ? p.K - (k_first + kc) : -(1 << 30);
        src[it] = (const unsigned char*)(ab + (m0 + r) * p.sam + k_first + kc);
        dst[it] = (r * S::LDA + kc) * (int)sizeof(TA);
        roff[it] = (rr * S::LDA + kr) * (int)sizeof(TA);
        woff[it] = kr * BM + rr;
      } else if (ch < S::A_CHUNKS + S::B_CHUNKS) {
        const int cb_ = ch - S::A_CHUNKS;
        if (p.b_col) {
          const int c = cb_ % BN, kc = (cb_ / BN) * VB;
          kind[it] = 2;
          lim[it] = n0 + c < p.N ? p.K - (k_first + kc) : -(1 << 30);
          src[it] = (const unsigned char*)(b + (long long)(n0 + c) * p.sbn +
                                           k_first + kc);
          dst[it] = roff[it] = S::RAW_A_BYTES + (c * S::LDB + kc) *
                                                    (int)sizeof(TB);
          woff[it] = kc * BN + c;
        } else {
          const int r = cb_ / (BN / VB), c = (cb_ % (BN / VB)) * VB;
          kind[it] = 1;
          lim[it] = p.K - (k_first + r);
          nval[it] = min(max(p.N - (n0 + c), 0), VB);
          src[it] = (const unsigned char*)(b + (long long)(k_first + r) *
                                                   p.sbk + n0 + c);
          dst[it] = roff[it] = S::RAW_A_BYTES + (r * BN + c) * (int)sizeof(TB);
          woff[it] = r * BN + c;
        }
      }
    }
  }

  // the copies of slice s into its raw buffer, coalesced along each
  // operand's contiguous dimension; called for s = 0, 1, 2, ... in turn
  // (none past the end; the group is committed all the same, so group s is
  // slice s)
  auto issue = [&](int s) {
    if (s < slices) {
      unsigned char* raw = raw_base + (s % STAGES) * S::RAW_BYTES;
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        if (kind[it] == 0) {
          copy_chunk((TA*)(raw + dst[it]), (const TA*)src[it],
                     min(max(lim[it], 0), VA), vec, a);
          src[it] += KC * sizeof(TA);
        } else if (kind[it] == 2) {
          copy_chunk((TB*)(raw + dst[it]), (const TB*)src[it],
                     min(max(lim[it], 0), VB), vec, b);
          src[it] += KC * sizeof(TB);
        } else if (kind[it] == 1) {
          copy_chunk((TB*)(raw + dst[it]), (const TB*)src[it],
                     lim[it] > 0 ? nval[it] : 0, vec, b);
          src[it] += (long long)KC * p.sbk * sizeof(TB);
        }
        lim[it] -= KC;
      }
    }
    cp_async_commit();
  };

  // round raw slice s into ca[k][m] and cb[k][n], with its k block's
  // scales.  The transposing stores go row by row (a) or column by column
  // (k-contiguous b) across the lanes of a warp, so they hit 32 banks; the
  // raw rows or columns they read lie an odd number of 16-byte units apart.
  auto round_slice = [&](int s) {
    if (s >= slices) return;
    const Scales sc = scales_at(p, bb, m0, n0, kb_begin + s / SPB);
    const unsigned char* raw = raw_base + (s % STAGES) * S::RAW_BYTES;
    float* xa = ca(s);
    float* xb = cb(s);
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      alignas(16) float w[VA > VB ? VA : VB];
      if (kind[it] == 0) {
        round_chunk((const TA*)(raw + roff[it]), w, sc.inv_a, scaled,
                    p.skip_a, p.f);
#pragma unroll
        for (int j = 0; j < VA; ++j) xa[woff[it] + j * BM] = w[j];
      } else if (kind[it] == 2) {
        round_chunk((const TB*)(raw + roff[it]), w, sc.inv_b, scaled,
                    p.skip_b, p.f);
#pragma unroll
        for (int j = 0; j < VB; ++j) xb[woff[it] + j * BN] = w[j];
      } else if (kind[it] == 1) {
        round_chunk((const TB*)(raw + roff[it]), w, sc.inv_b, scaled,
                    p.skip_b, p.f);
#pragma unroll
        for (int j = 0; j < VB; j += 4)
          *(float4*)(xb + woff[it] + j) = *(const float4*)(w + j);
      }
    }
  };

  float part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
  if (!split) {
#pragma unroll
    for (int q = 0; q < TM * TN / 4; ++q)
      accs[q * kTileThreads + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int s = 0; s < STAGES; ++s) issue(s);
  cp_async_wait<STAGES - 1>();  // raw slice 0
  __syncthreads();
  round_slice(0);
  for (int s = 0; s < slices; ++s) {
    // raw slice s + 1 has landed and rounded slice s is complete, for every
    // thread; every thread is done with the products of slice s - 1 and the
    // rounding of slice s, so raw slice s's buffer takes slice s + STAGES
    // (issued after the rounding, which measured faster)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    round_slice(s + 1);
    issue(s + STAGES);

    const float* xa = ca(s) + row0;
    const float* xb = cb(s) + col0;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < RG; ++g) {
        const float4 v = *(const float4*)(xa + k * BM + 16 * g);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *(const float4*)(xb + k * BN + 32 * h);
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }

    if (s % SPB == SPB - 1) {  // the k block ends here
      const int kb = kb_begin + s / SPB;
      const Scales sc = scales_at(p, bb, m0, n0, kb);
      const float dq = __fmul_rn(sc.sa, sc.sb);
      if (scaled) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = __fmul_rn(part[i][j], dq);
      }
      if (split) {
        store_tile(out + ((long long)kb * p.nb + bb) * p.M * p.N, part, p,
                   m0 + row0, n0 + col0);
      } else {
#pragma unroll
        for (int q = 0; q < TM * TN / 4; ++q) {
          const int i = q / 2, h = q % 2;
          float4 v = accs[q * kTileThreads + tid];
          v.x = fold(v.x, part[i][4 * h], p);
          v.y = fold(v.y, part[i][4 * h + 1], p);
          v.z = fold(v.z, part[i][4 * h + 2], p);
          v.w = fold(v.w, part[i][4 * h + 3], p);
          accs[q * kTileThreads + tid] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
    }
  }
  if (split) return;

#pragma unroll
  for (int q = 0; q < TM * TN / 4; ++q) {  // the accumulators, out_fmt
    const int i = q / 2, h = q % 2;
    const float4 v = accs[q * kTileThreads + tid];
    part[i][4 * h] = v.x;
    part[i][4 * h + 1] = v.y;
    part[i][4 * h + 2] = v.z;
    part[i][4 * h + 3] = v.w;
  }
  if (p.has_out_fmt) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        part[i][j] = quantize_rne_mul(part[i][j], p.out_f);
  }
  store_tile(out + (long long)bb * p.M * p.N, part, p, m0 + row0, n0 + col0);
}

// ---------------------------------------------------------------------------
// split_rows: M <= 16 rows, one k block of one BN-wide column tile per block
// ---------------------------------------------------------------------------
template <typename TB>
__host__ __device__ constexpr int rows_ldb() {  // k-contiguous b column
  return kBK + 16 / (int)sizeof(TB);
}

template <typename TB>
__host__ __device__ constexpr int rows_raw_elems(int bn) {
  return kBK * bn > bn * rows_ldb<TB>() ? kBK * bn : bn * rows_ldb<TB>();
}

// R: rows per thread, at least ceil(M / (128 / bn))
template <int R, typename TA, typename TB>
__global__ void __launch_bounds__(kRowsThreads)
qmm_rows_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                float* __restrict__ ws, const QmmArgs p, int bn) {
  constexpr int V = 16 / sizeof(TB);
  constexpr int LDB = rows_ldb<TB>();
  constexpr int LDA = kBK + kPadA;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = (float*)smem;                            // [M][LDA]
  TB* raw = (TB*)(smem + p.M * LDA * sizeof(float));  // the b tile

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * bn, kb = blockIdx.y, bb = blockIdx.z;
  const int k0 = kb * kBK;
  const bool scaled = p.a_scale != nullptr;
  const bool vec = p.vec;

  // the b tile, 128 x bn, copied along b's contiguous dimension
  if (p.b_col) {  // raw[c][k]
    for (int ch = tid; ch < bn * (kBK / V); ch += kRowsThreads) {
      int c = ch / (kBK / V), kc = (ch % (kBK / V)) * V;
      int n = n0 + c, k = k0 + kc;
      int valid = n < p.N ? min(max(p.K - k, 0), V) : 0;
      copy_chunk(raw + c * LDB + kc, b + (long long)n * p.sbn + k, valid, vec,
                 b);
    }
  } else {  // raw[k][c]
    for (int ch = tid; ch < kBK * (bn / V); ch += kRowsThreads) {
      int r = ch / (bn / V), c = (ch % (bn / V)) * V;
      int n = n0 + c, k = k0 + r;
      int valid = k < p.K ? min(max(p.N - n, 0), V) : 0;
      copy_chunk(raw + r * bn + c, b + (long long)k * p.sbk + n, valid, vec,
                 b);
    }
  }
  cp_async_commit();

  // the M rows of a, rounded, while the copies are in flight
  const Scales sc = scales_at(p, bb, 0, n0, kb);
  const TA* ab = a + bb * p.sab;
  for (int idx = tid; idx < p.M * kBK; idx += kRowsThreads) {
    int m = idx / kBK, kk = idx % kBK, k = k0 + kk;
    float v = k < p.K ? widen(ab[m * p.sam + k]) : 0.0f;
    as[m * LDA + kk] = round_operand(v, sc.inv_a, scaled, p.skip_a, p.f);
  }
  cp_async_wait<0>();
  __syncthreads();

  // thread: column c, rows rg, rg + RG, ... (R of them at most); it rounds
  // column c of the b tile as it reads it
  const int RG = kRowsThreads / bn;
  const int c = tid % bn, rg = tid / bn;
  const int n = n0 + c;
  if (rg >= p.M || n >= p.N) return;
  float part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) part[i] = 0.0f;
  for (int kk = 0; kk < kBK; kk += V) {
    alignas(16) TB v[V];
    if (p.b_col) {
      *(uint4*)v = *(const uint4*)(raw + c * LDB + kk);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = raw[(kk + j) * bn + c];
    }
    float bv[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      bv[j] = round_operand(widen(v[j]), sc.inv_b, scaled, p.skip_b, p.f);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = rg + i * RG;
      if (m < p.M) {
        const float* ar = as + m * LDA + kk;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 x = *(const float4*)(ar + j);
          part[i] = fmaf(x.x, bv[j], part[i]);
          part[i] = fmaf(x.y, bv[j + 1], part[i]);
          part[i] = fmaf(x.z, bv[j + 2], part[i]);
          part[i] = fmaf(x.w, bv[j + 3], part[i]);
        }
      }
    }
  }
  const float dq = __fmul_rn(sc.sa, sc.sb);
  float* w = ws + (((long long)kb * p.nb + bb) * p.M) * p.N + n;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = rg + i * RG;
    if (m < p.M) w[(long long)m * p.N] = scaled ? __fmul_rn(part[i], dq)
                                                : part[i];
  }
}

// The parts of each output (bb, m, n), ws[kb][bb][m][n], folded in k-block
// order by style, then out_fmt.
__global__ void __launch_bounds__(256)
qmm_fold_kernel(const float* __restrict__ ws, float* __restrict__ out,
                const QmmArgs p) {
  const long long total = (long long)p.nb * p.M * p.N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int kb = 0; kb < p.gk; ++kb) acc = fold(acc, ws[kb * total + i], p);
  if (p.has_out_fmt) acc = quantize_rne_mul(acc, p.out_f);
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The dynamic shared memory a kernel may take, set on the current device
// before each launch (a cheap driver call; no state is kept here).
template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BM, typename TA, typename TB>
int launch_tile(const void* a, const void* b, float* dst, const QmmArgs& p,
                int split, cudaStream_t s) {
  constexpr int bytes = TileSmem<BM, TA, TB>::BYTES;
  if (int rc = set_smem(qmm_tile_kernel<BM, TA, TB>, bytes)) return rc;
  dim3 grid((p.N + kTileBN - 1) / kTileBN, (p.M + BM - 1) / BM,
            p.nb * (split ? p.gk : 1));
  qmm_tile_kernel<BM, TA, TB><<<grid, kTileThreads, bytes, s>>>(
      (const TA*)a, (const TB*)b, dst, p, split);
  return (int)cudaGetLastError();
}

template <int R, typename TA, typename TB>
int launch_rows_r(const void* a, const void* b, float* ws, const QmmArgs& p,
                  int bn, cudaStream_t s) {
  constexpr int max_bytes = 16 * (kBK + kPadA) * sizeof(float) +
                            rows_raw_elems<TB>(128) * sizeof(TB);
  if (int rc = set_smem(qmm_rows_kernel<R, TA, TB>, max_bytes)) return rc;
  int bytes = p.M * (kBK + kPadA) * sizeof(float) +
              rows_raw_elems<TB>(bn) * sizeof(TB);
  dim3 grid((p.N + bn - 1) / bn, p.gk, p.nb);
  qmm_rows_kernel<R, TA, TB><<<grid, kRowsThreads, bytes, s>>>(
      (const TA*)a, (const TB*)b, ws, p, bn);
  return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int launch_typed(const void* a, const void* b, float* out, float* ws,
                 const QmmArgs& p, int schedule, int bm, int bn,
                 cudaStream_t s) {
  int rc;
  if (schedule == kSplitRows) {
    if (p.M > 16 || bn < 16 || bn > 128 || 128 % bn)
      return (int)cudaErrorInvalidValue;
    int rows = (p.M + kRowsThreads / bn - 1) / (kRowsThreads / bn);
    if (rows <= 1) rc = launch_rows_r<1, TA, TB>(a, b, ws, p, bn, s);
    else if (rows <= 2) rc = launch_rows_r<2, TA, TB>(a, b, ws, p, bn, s);
    else if (rows <= 4) rc = launch_rows_r<4, TA, TB>(a, b, ws, p, bn, s);
    else if (rows <= 8) rc = launch_rows_r<8, TA, TB>(a, b, ws, p, bn, s);
    else rc = launch_rows_r<16, TA, TB>(a, b, ws, p, bn, s);
  } else {
    if (bn != kTileBN || (bm != 128 && bm != 64))
      return (int)cudaErrorInvalidValue;
    int split = schedule == kSplitTile;
    float* dst = split ? ws : out;
    rc = bm == 128 ? launch_tile<128, TA, TB>(a, b, dst, p, split, s)
                   : launch_tile<64, TA, TB>(a, b, dst, p, split, s);
  }
  if (rc || schedule == kWhole) return rc;
  long long total = (long long)p.nb * p.M * p.N;
  qmm_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, out, p);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
int qmm_dispatch(const void* a, int a_dtype, const void* b, int b_dtype,
                 float* out, float* ws, const QmmArgs& p, int schedule,
                 int bm, int bn, cudaStream_t s) {
  if (a_dtype == 0 && b_dtype == 0)
    return launch_typed<float, float>(a, b, out, ws, p, schedule, bm, bn, s);
  if (a_dtype == 0 && b_dtype == 1)
    return launch_typed<float, __nv_bfloat16>(a, b, out, ws, p, schedule, bm,
                                              bn, s);
  if (a_dtype == 1 && b_dtype == 0)
    return launch_typed<__nv_bfloat16, float>(a, b, out, ws, p, schedule, bm,
                                              bn, s);
  if (a_dtype == 1 && b_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, b, out, ws, p,
                                                      schedule, bm, bn, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_scale_exp(const void* x, long long s_batch, long long s_row,
                     long long s_col, int rows, int cols, int nbatch, QFmt f,
                     int* out, cudaStream_t s) {
  dim3 grid((cols + 127) / 128, (rows + 127) / 128, nbatch);
  scale_exp_kernel<T><<<grid, kScaleThreads, 0, s>>>(
      (const T*)x, s_batch, s_row, s_col, rows, cols, f, out);
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

// Counts, over all 2**32 f32 bit patterns, where quantize_rne_mul and
// quantize_rne differ bitwise (counts[0]), and, over the 2**16 bf16
// patterns, the finite ones that quantize_rne moves (counts[1]; zero for a
// format that holds every bf16 value).
__global__ void __launch_bounds__(256)
rounding_mismatch_kernel(QFmt f, unsigned long long* counts) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  const unsigned long long first =
      (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long bad = 0, moved = 0;
  for (unsigned long long i = first; i < (1ull << 32); i += stride) {
    float x = __uint_as_float((unsigned)i);
    bad += __float_as_uint(quantize_rne_mul(x, f)) !=
           __float_as_uint(quantize_rne(x, f));
  }
  for (unsigned long long i = first; i < (1ull << 16); i += stride) {
    float x = __uint_as_float((unsigned)i << 16);
    moved += isfinite(x) &&
             __float_as_uint(quantize_rne(x, f)) != __float_as_uint(x);
  }
  for (int off = 16; off > 0; off >>= 1) {
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
    moved += __shfl_xor_sync(0xffffffffu, moved, off);
  }
  if (threadIdx.x % 32 == 0) {
    if (bad) atomicAdd(counts, bad);
    if (moved) atomicAdd(counts + 1, moved);
  }
}

}  // namespace

// K1, and K3 with nbatch = 1 and scaled = 0.  a: (nbatch, M, K) with
// strides (sab, sam, 1); b: (K, N) with strides (sbk, sbn), one of them 1;
// out: contiguous (nbatch, M, N) f32.  With scaled != 0, a_scale (nbatch,
// ceil(M/128), ceil(K/128)) and b_scale (ceil(K/128), ceil(N/128)) are int32
// scratch that the pre-pass fills.  out_exp_bits = 0 means no out_fmt.
// schedule (0 whole, 1 split_rows, 2 split_tile), bm and bn are the plan of
// kernels/fused.py::plan_qmm; ws is the f32 workspace (ceil(K/128), nbatch,
// M, N) of a split schedule, else null; vec != 0 when both operands' bases
// and row strides are 16-byte aligned.  Returns the CUDA error of the
// launches (0 = success).
extern "C" int repro_fused_qmm(const void* a, int a_dtype, long long sab,
                               long long sam, const void* b, int b_dtype,
                               long long sbk, long long sbn, void* out,
                               int nbatch, int M, int N, int K, int exp_bits,
                               int man_bits, int style, int out_exp_bits,
                               int out_man_bits, int scaled, void* a_scale,
                               void* b_scale, int schedule, int bm, int bn,
                               int vec, void* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  QmmArgs p;
  p.sab = sab; p.sam = sam; p.sbk = sbk; p.sbn = sbn;
  p.nb = nbatch; p.M = M; p.N = N; p.K = K; p.gk = (K + kBK - 1) / kBK;
  p.f = make_qfmt(exp_bits, man_bits);
  p.has_out_fmt = out_exp_bits > 0;
  p.out_f = p.has_out_fmt ? make_qfmt(out_exp_bits, out_man_bits) : p.f;
  p.style = style;
  // rounding an unscaled bf16 operand onto a format that holds every bf16
  // value is the identity (the card check counts it over all bf16 patterns)
  const int holds_bf16 = exp_bits == 8 && man_bits >= 7;
  p.skip_a = !scaled && holds_bf16 && a_dtype == 1;
  p.skip_b = !scaled && holds_bf16 && b_dtype == 1;
  p.b_col = sbk == 1 && sbn != 1;
  p.vec = vec;
  p.a_scale = nullptr;
  p.b_scale = nullptr;
  if ((schedule != kWhole) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  if (scaled) {
    int rc = scale_exp_dispatch(a, a_dtype, sab, sam, 1, M, K, nbatch, p.f,
                                (int*)a_scale, s);
    if (rc) return rc;
    rc = scale_exp_dispatch(b, b_dtype, 0, sbk, sbn, K, N, 1, p.f,
                            (int*)b_scale, s);
    if (rc) return rc;
    p.a_scale = (const int*)a_scale;
    p.b_scale = (const int*)b_scale;
  }
  return qmm_dispatch(a, a_dtype, b, b_dtype, (float*)out, (float*)ws, p,
                      schedule, bm, bn, s);
}

// Test entry: fills counts (two zeroed uint64 on the device) as
// rounding_mismatch_kernel describes, for the format (exp_bits, man_bits).
extern "C" int repro_qmm_rounding_mismatches(int exp_bits, int man_bits,
                                             void* counts, void* stream) {
  rounding_mismatch_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      make_qfmt(exp_bits, man_bits), (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
