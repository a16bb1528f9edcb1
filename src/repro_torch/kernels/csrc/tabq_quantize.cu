// Per-token asymmetric magnitude quantization (TAB-Q's inner step, paper
// Eq. 5-6), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/tabq_kernel.py
// (tabq_quantize, pallas_call at line 59). Python wrapper, launch count and
// plain PyTorch version: repro_torch/kernels/tabq_quantize.py.
//
//   x      (T, D)  f32 or bf16
//   codes  (T, D)  int8   |x| quantized, rebased per token to [0, qmax]
//   scale  (T, 1)  f32    s = max((max|x| - min|x|) * rq, 1e-8)
//   zero   (T, 1)  f32    ceil(min|x| / s) - c_lo
//   sign   (T, D)  int8   sign(x) in {-1, 0, 1}
//
// with qmax = 2^(bits-1) - 1, bits in [1, 8], codes = clip(round(|x|/s + z),
// c_lo, c_lo + qmax) - c_lo and c_lo = round(min|x|/s + z). rq is 1/max(qmax,
// 1) rounded to f32: the reference computes the scale under jit with qmax a
// constant, and XLA turns that division into a product with the rounded
// reciprocal (the division by s, a value, stays a division). The codes must
// be bit-identical to the reference's: TAB-Q picks each token's bit width
// from them, and the payload's size and the deadline ladder follow. So
// every step is an IEEE f32 operation in the reference's order, through
// __fmul_rn / __fdiv_rn / __fadd_rn / __fsub_rn (never contracted into an
// FMA), rintf (half to even, as jnp.round and torch.round) and ceilf. The
// TPU kernel's T % block_t == 0 is gone: a decode payload has T = 1.
//
// Bound: one read of x and one write of codes and sign, T*D*(2|4 + 2)
// bytes; a few operations per byte, so device-memory bytes bound it (and at
// the decode payload's T = 1, D = 4096, 16 KB, the launch itself).
//
// Design: one block per token. Pass 1 reduces min and max of |x| (warp
// shuffles, then shared memory); every thread then derives s, z and c_lo
// from the same two values with the same operations; pass 2 writes codes
// and sign. x is read twice, the second time mostly from L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const void* x, int bf16, size_t i) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(x)[i])
              : reinterpret_cast<const float*>(x)[i];
}

__global__ void __launch_bounds__(kThreads)
tabq_quantize_kernel(const void* __restrict__ x, int x_bf16,
                     int8_t* __restrict__ codes, float* __restrict__ scale,
                     float* __restrict__ zero, int8_t* __restrict__ sign,
                     int D, float qmax, float rq) {
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  const size_t row = (size_t)blockIdx.x * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float m = fabsf(load(x, x_bf16, row + i));
    lo = fminf(lo, m);
    hi = fmaxf(hi, m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }

  // min and max are exact in any order; from here every step is the
  // reference's f32 operation, rounded to nearest
  const float s = fmaxf(__fmul_rn(__fsub_rn(hi, lo), rq), 1e-8f);
  const float z = ceilf(__fdiv_rn(lo, s));
  const float c_lo = rintf(__fadd_rn(__fdiv_rn(lo, s), z));
  const float c_hi = __fadd_rn(c_lo, qmax);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = load(x, x_bf16, row + i);
    float c = rintf(__fadd_rn(__fdiv_rn(fabsf(v), s), z));
    c = fminf(fmaxf(c, c_lo), c_hi);
    codes[row + i] = (int8_t)__fsub_rn(c, c_lo);
    sign[row + i] = v > 0.f ? 1 : (v < 0.f ? -1 : 0);
  }
  if (threadIdx.x == 0) {
    scale[blockIdx.x] = s;
    zero[blockIdx.x] = __fsub_rn(z, c_lo);
  }
}

}  // namespace

extern "C" int tabq_quantize_launch(const void* x, int x_bf16, void* codes,
                                    void* scale, void* zero, void* sign,
                                    int T, int D, int bits, void* stream) {
  if (T < 1 || D < 1 || bits < 1 || bits > 8)
    return (int)cudaErrorInvalidValue;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const float rq = 1.f / (qmax > 1.f ? qmax : 1.f);  // IEEE: correctly rounded
  tabq_quantize_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, static_cast<int8_t*>(codes), static_cast<float*>(scale),
      static_cast<float*>(zero), static_cast<int8_t*>(sign), D, qmax, rq);
  return (int)cudaGetLastError();
}
