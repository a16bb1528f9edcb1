// Threshold split (TS, paper Eq. 4) for Hopper (sm_90a): the mask, the
// below-threshold tensor and the outlier counts in one pass.
//
// Replaces the Pallas TPU kernel repro/kernels/ts_mask.py (ts_mask,
// pallas_call at line 32). Python wrapper, launch count and plain PyTorch
// version: repro_torch/kernels/ts_mask.py.
//
//   x       (T, D)  f32 or bf16
//   below   (T, D)  f32    x where |x| < tau, else +0
//   mask    (T, D)  uint8  |x| >= tau
//   counts  (T,)    int32  entries of the row with |x| >= tau
//
// The comparison is in f32 against tau as an f32, as in the reference. The
// TPU kernel counts per tile of block_t rows and needs T % block_t == 0;
// here a tile is one row, so any T works (a decode payload has T = 1), and
// the total is the sum of the rows' counts.
//
// Bound: x read once, below and mask written once, T*D*(2|4 + 5) bytes
// against one compare a value: device-memory bytes.
//
// Design: one block per row; each thread strides the row, then the count is
// reduced with warp shuffles and shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ts_mask_kernel(const void* __restrict__ x, int x_bf16, float tau,
               float* __restrict__ below, uint8_t* __restrict__ mask,
               int32_t* __restrict__ counts, int D) {
  __shared__ int s_n[kWarps];
  const size_t row = (size_t)blockIdx.x * D;
  int n = 0;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v =
        x_bf16 ? __bfloat162float(
                     reinterpret_cast<const __nv_bfloat16*>(x)[row + i])
               : reinterpret_cast<const float*>(x)[row + i];
    const bool m = fabsf(v) >= tau;
    below[row + i] = m ? 0.f : v;
    mask[row + i] = m;
    n += m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
  if (threadIdx.x % 32 == 0) s_n[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_n[w];
    counts[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" int ts_mask_launch(const void* x, int x_bf16, float tau,
                              void* below, void* mask, void* counts, int T,
                              int D, void* stream) {
  if (T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  ts_mask_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, tau, static_cast<float*>(below),
      static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts), D);
  return (int)cudaGetLastError();
}
