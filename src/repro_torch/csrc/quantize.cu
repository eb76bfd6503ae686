// K2: elementwise round-to-format (RNE) on an f32 tensor.
//
// Replaces the TPU kernel repro/kernels/quantize_kernel.py::quantize_2d
// (pallas_call at :41; quantize_nd at :52 folds the leading dims).
//
// Bound on the H100: bytes.  Each element is read once and written once
// (8 bytes) for a few dozen integer and float instructions, far below the
// card's operations-per-byte balance.  Design: one thread per element over
// the flattened tensor with a ragged-tail mask and a grid-stride loop,
// neighbouring threads on neighbouring addresses so every warp load and
// store is one coalesced 128-byte transaction.  The TPU's 128-lane padding
// was a layout constraint of its vector unit and is gone.
#include "quantize.cuh"

__global__ void quantize_kernel(const float* __restrict__ x,
                                float* __restrict__ y, long long n, QFmt f) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = quantize_rne(x[i], f);
  }
}

extern "C" int repro_quantize(const void* x, void* y, long long n,
                              int exp_bits, int man_bits, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  quantize_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n, make_qfmt(exp_bits, man_bits));
  return (int)cudaGetLastError();
}
