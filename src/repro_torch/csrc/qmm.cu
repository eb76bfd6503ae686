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
//
// Design: the host planner (kernels/fused.py::plan_qmm) picks one of three
// schedules and its tile, and passes them in.
//   whole       qmm_tile_kernel: one thread block per (batch, 64 x 128
//               output tile) walks every k block in order and folds in
//               registers.  256 threads, each with a 4 x 8 register tile
//               read from shared memory as float4.  32-deep k slices are
//               copied with cp.async into a ring of four raw slices and
//               rounded once into one of two compute buffers; slice s + 1
//               is rounded between the same two barriers as slice s is
//               multiplied, and two thread blocks share an SM.
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
// the tiled kernel: its 64 x 128 output tile, 32-deep k slices, four raw
// slices in flight, two thread blocks per SM (128 registers a thread; 110 KB
// of shared memory each with bf16 operands)
constexpr int kTileBM = 64;
constexpr int kKC = 32;
constexpr int kStages = 4;
constexpr int kTileBlocksPerSM = 2;
constexpr int kTileThreads = 256;  // 16 x 16
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
// whole and split_tile: register-tiled, 64 x 128 outputs per thread block
// ---------------------------------------------------------------------------
template <typename TA, typename TB>
struct TileSmem {
  static constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
  static constexpr int LDA = kKC + VA;    // raw a row: KC k + a 16-byte pad
  static constexpr int LDB = kKC + VB;    // raw b column when k-contiguous
  static constexpr int LDC = kKC + 4;     // rounded a row (floats)
  static constexpr int RAW_B = kKC * kTileBN > kTileBN * LDB ? kKC * kTileBN
                                                             : kTileBN * LDB;
  static constexpr int RAW_A_BYTES = kTileBM * LDA * sizeof(TA);
  static constexpr int RAW_B_BYTES = RAW_B * sizeof(TB);
  static constexpr int RAW_BYTES = RAW_A_BYTES + RAW_B_BYTES;
  static constexpr int CA_BYTES = kTileBM * LDC * sizeof(float);
  static constexpr int CB_BYTES = kKC * kTileBN * sizeof(float);
  static constexpr int C_BYTES = CA_BYTES + CB_BYTES;
  // kStages raw slices in flight, two rounded slices
  static constexpr int BYTES = kStages * RAW_BYTES + 2 * C_BYTES;
};

// Thread (tx, ty) of 16 x 16 owns rows 4 ty + i (i < 4) and columns
// 4 tx + j, 64 + 4 tx + j (j < 4) of the 64 x 128 tile.  Each k slice goes
// global -> raw (cp.async, kStages in flight) -> rounded (ca[m][k] and
// cb[k][n], two buffers) -> registers; the rounding of slice s + 1 and the
// products of slice s run between the same two barriers, so one warp's
// rounding overlaps another's products.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSM)
qmm_tile_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                float* __restrict__ out, const QmmArgs p, int split) {
  using S = TileSmem<TA, TB>;
  constexpr int BM = kTileBM, BN = kTileBN;
  constexpr int TM = 4;  // rows per thread
  constexpr int VA = S::VA, VB = S::VB;
  constexpr int SPB = kBK / kKC;  // slices per k block
  static_assert(kBK % kKC == 0 && kKC % VA == 0 && kKC % VB == 0, "slice");
  static_assert(kStages >= 3, "round s + 1 while s computes");
  extern __shared__ __align__(16) unsigned char smem[];
  // [rounded slice 0 | rounded slice 1 | raw slice 0 | ... | raw kStages-1]
  auto ca = [&](int i) { return (float*)(smem + (i & 1) * S::C_BYTES); };
  auto cb = [&](int i) {
    return (float*)(smem + (i & 1) * S::C_BYTES + S::CA_BYTES);
  };
  auto raw_a = [&](int i) {
    return (TA*)(smem + 2 * S::C_BYTES + (i % kStages) * S::RAW_BYTES);
  };
  auto raw_b = [&](int i) {
    return (TB*)(smem + 2 * S::C_BYTES + (i % kStages) * S::RAW_BYTES +
                 S::RAW_A_BYTES);
  };

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int bb = blockIdx.z % p.nb;
  const int kb_begin = split ? blockIdx.z / p.nb : 0;
  const int kb_end = split ? kb_begin + 1 : p.gk;
  const int slices = (kb_end - kb_begin) * SPB;
  const TA* ab = a + bb * p.sab;
  const bool scaled = p.a_scale != nullptr;
  const bool vec = p.vec;

  // the copies of slice s into its raw buffer, coalesced along each
  // operand's contiguous dimension (none past the end; the group is
  // committed all the same, so group s is slice s)
  auto issue = [&](int s) {
    if (s < slices) {
      const int k0 = kb_begin * kBK + s * kKC;
      TA* ra = raw_a(s);
      TB* rb = raw_b(s);
      for (int ch = tid; ch < BM * (kKC / VA); ch += kTileThreads) {
        int r = ch / (kKC / VA), kc = (ch % (kKC / VA)) * VA;
        int m = m0 + r, k = k0 + kc;
        int valid = m < p.M ? min(max(p.K - k, 0), VA) : 0;
        copy_chunk(ra + r * S::LDA + kc, ab + m * p.sam + k, valid, vec, a);
      }
      if (p.b_col) {
        for (int ch = tid; ch < BN * (kKC / VB); ch += kTileThreads) {
          int c = ch % BN, kc = (ch / BN) * VB;
          int n = n0 + c, k = k0 + kc;
          int valid = n < p.N ? min(max(p.K - k, 0), VB) : 0;
          copy_chunk(rb + c * S::LDB + kc, b + (long long)n * p.sbn + k,
                     valid, vec, b);
        }
      } else {
        for (int ch = tid; ch < kKC * (BN / VB); ch += kTileThreads) {
          int r = ch / (BN / VB), c = (ch % (BN / VB)) * VB;
          int n = n0 + c, k = k0 + r;
          int valid = k < p.K ? min(max(p.N - n, 0), VB) : 0;
          copy_chunk(rb + r * BN + c, b + (long long)k * p.sbk + n, valid,
                     vec, b);
        }
      }
    }
    cp_async_commit();
  };

  // round raw slice s into ca[m][k] and cb[k][n], with its k block's scales
  auto round_slice = [&](int s) {
    if (s >= slices) return;
    const Scales sc = scales_at(p, bb, m0, n0, kb_begin + s / SPB);
    const TA* ra = raw_a(s);
    const TB* rb = raw_b(s);
    float* xa = ca(s);
    float* xb = cb(s);
    for (int ch = tid; ch < BM * (kKC / VA); ch += kTileThreads) {
      int r = ch / (kKC / VA), kc = (ch % (kKC / VA)) * VA;
      alignas(16) TA v[VA];
      alignas(16) float w[VA];
      *(uint4*)v = *(const uint4*)(ra + r * S::LDA + kc);
#pragma unroll
      for (int j = 0; j < VA; ++j)
        w[j] = round_operand(widen(v[j]), sc.inv_a, scaled, p.skip_a, p.f);
#pragma unroll
      for (int j = 0; j < VA; j += 4)
        *(float4*)(xa + r * S::LDC + kc + j) = *(const float4*)(w + j);
    }
    if (p.b_col) {
      for (int ch = tid; ch < BN * (kKC / VB); ch += kTileThreads) {
        int c = ch % BN, kc = (ch / BN) * VB;
        alignas(16) TB v[VB];
        *(uint4*)v = *(const uint4*)(rb + c * S::LDB + kc);
#pragma unroll
        for (int j = 0; j < VB; ++j)
          xb[(kc + j) * BN + c] =
              round_operand(widen(v[j]), sc.inv_b, scaled, p.skip_b, p.f);
      }
    } else {
      for (int ch = tid; ch < kKC * (BN / VB); ch += kTileThreads) {
        int r = ch / (BN / VB), c = (ch % (BN / VB)) * VB;
        alignas(16) TB v[VB];
        alignas(16) float w[VB];
        *(uint4*)v = *(const uint4*)(rb + r * BN + c);
#pragma unroll
        for (int j = 0; j < VB; ++j)
          w[j] = round_operand(widen(v[j]), sc.inv_b, scaled, p.skip_b, p.f);
#pragma unroll
        for (int j = 0; j < VB; j += 4)
          *(float4*)(xb + r * BN + c + j) = *(const float4*)(w + j);
      }
    }
  };

  float acc[TM][8], part[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.0f;

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  cp_async_wait<kStages - 2>();  // raw slice 0
  __syncthreads();
  round_slice(0);
  for (int s = 0; s < slices; ++s) {
    // raw slice s + 1 has landed and rounded slice s is complete, for every
    // thread; every thread is done with the products of slice s - 1 and the
    // rounding of slice s
    cp_async_wait<kStages - 3>();
    __syncthreads();
    issue(s + kStages - 1);
    round_slice(s + 1);

    const float* xa = ca(s);
    const float* xb = cb(s);
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *(const float4*)(xa + (4 * ty + i) * S::LDC + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *(const float4*)(xb + (kk + q) * BN + 4 * tx);
        const float4 b1 = *(const float4*)(xb + (kk + q) * BN + 64 + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                        : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) part[i][j] = fmaf(x, bv[j], part[i][j]);
        }
      }
    }

    if (s % SPB == SPB - 1) {  // the k block ends here
      const int kb = kb_begin + s / SPB;
      const Scales sc = scales_at(p, bb, m0, n0, kb);
      const float dq = __fmul_rn(sc.sa, sc.sb);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pt = part[i][j];
          if (scaled) pt = __fmul_rn(pt, dq);
          part[i][j] = 0.0f;
          if (split) {
            int m = m0 + 4 * ty + i;
            int n = n0 + 4 * tx + (j % 4) + 64 * (j / 4);
            if (m < p.M && n < p.N)
              out[(((long long)kb * p.nb + bb) * p.M + m) * p.N + n] = pt;
          } else {
            acc[i][j] = fold(acc[i][j], pt, p);
          }
        }
    }
  }
  if (split) return;

  float* ob = out + (long long)bb * p.M * p.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + 4 * ty + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int n = n0 + 4 * tx + (j % 4) + 64 * (j / 4);
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (p.has_out_fmt) v = quantize_rne_mul(v, p.out_f);
      ob[(long long)m * p.N + n] = v;
    }
  }
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

template <typename TA, typename TB>
int launch_tile(const void* a, const void* b, float* dst, const QmmArgs& p,
                int split, cudaStream_t s) {
  constexpr int bytes = TileSmem<TA, TB>::BYTES;
  if (int rc = set_smem(qmm_tile_kernel<TA, TB>, bytes)) return rc;
  dim3 grid((p.N + kTileBN - 1) / kTileBN, (p.M + kTileBM - 1) / kTileBM,
            p.nb * (split ? p.gk : 1));
  qmm_tile_kernel<TA, TB><<<grid, kTileThreads, bytes, s>>>(
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
    if (bn != kTileBN || bm != kTileBM) return (int)cudaErrorInvalidValue;
    int split = schedule == kSplitTile;
    rc = launch_tile<TA, TB>(a, b, split ? ws : out, p, split, s);
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
