// Per-token asymmetric magnitude quantization (TAB-Q's inner step, paper
// Eq. 5-6) and TAB-Q's whole level walk (paper Algorithm 1), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/tabq_kernel.py
// (tabq_quantize, pallas_call at line 59). Python wrapper, launch counts
// and plain PyTorch versions: repro_torch/kernels/tabq_quantize.py.
//
// tabq_quantize_kernel, one level:
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
// tabq_adaptive_kernel, TAB-Q's whole level walk (repro/core/tabq.py::tabq)
// in one launch: the top level Q-1 = max_bits - 1 gives the codes T0
// (before the rebase); each lower level q down to MIN_BITS is kept while
// every level so far has delta = sum|round(T0 / 2^(Q-1-q)) - T_q| * (1/D
// rounded) <= Delta (the reference's prefix rule); the walk stops at the
// first level that fails. Out: the chosen level's codes, scale, zero (as
// above), the sign and the token's bits (level + 1: the sign bit). Each
// term of delta's sum is an integer-valued f32, so the sum is exact in any
// order while it stays below 2^24, which covers every sum that Delta * D
// admits: the chosen bits are the reference's.
//
// Bound: one read of x and one write of codes and sign, T*D*(2|4 + 2)
// bytes; a few operations per byte, so device-memory bytes bound it (and at
// the decode payload's T = 1, D = 4096, 16 KB, the launch itself). The
// walk at T = 1 runs on one SM, so there its levels' IEEE divisions, not
// its bytes, set its time.
//
// Design: one block per token. tabq_quantize_kernel: pass 1 reduces min
// and max of |x| (warp shuffles, then shared memory); every thread then
// derives s, z and c_lo from the same two values with the same operations;
// pass 2 writes codes and sign. tabq_adaptive_kernel: 1,024 threads read x
// once into shared memory as |x| (writing the sign), reduce min and max,
// keep T0 in shared memory, and reduce each level's delta over the block;
// every thread reads the same sums, so the walk is the same in all of them;
// a last pass writes the chosen level's codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAdaptThreads = 1024;
constexpr int kAdaptWarps = kAdaptThreads / 32;
constexpr int kMinBits = 2;  // tabq_quantize.py::MIN_BITS
// dynamic shared memory a token can have: the 227 KB a block can opt in
// to, less 1 KB for the static reductions
constexpr int kAdaptSmem = 227 * 1024 - 1024;

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


// one AIQ level of a token whose |x| spans [lo, hi], in the reference's f32
// operations (as tabq_quantize_kernel)
struct Level {
  float s, z, c_lo, c_hi;
};

__device__ __forceinline__ Level level_of(float lo, float hi, int bits) {
  const float qmax = (float)((1 << (bits - 1)) - 1);
  const float rq = __fdiv_rn(1.f, fmaxf(qmax, 1.f));  // rounded reciprocal
  Level L;
  L.s = fmaxf(__fmul_rn(__fsub_rn(hi, lo), rq), 1e-8f);
  L.z = ceilf(__fdiv_rn(lo, L.s));
  L.c_lo = rintf(__fadd_rn(__fdiv_rn(lo, L.s), L.z));
  L.c_hi = __fadd_rn(L.c_lo, qmax);
  return L;
}

// the code of magnitude m at level L before the rebase
__device__ __forceinline__ float code_of(float m, const Level& L) {
  const float c = rintf(__fadd_rn(__fdiv_rn(m, L.s), L.z));
  return fminf(fmaxf(c, L.c_lo), L.c_hi);
}

// the sum of every thread's v, the same in all threads (a warp's shuffles,
// then the warps in warp order); red holds kAdaptWarps floats
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kAdaptWarps; ++w) s += red[w];
  __syncthreads();  // red is free for the next sum
  return s;
}

__global__ void __launch_bounds__(kAdaptThreads)
tabq_adaptive_kernel(const void* __restrict__ x, int x_bf16,
                     int8_t* __restrict__ codes, float* __restrict__ scale,
                     float* __restrict__ zero, int8_t* __restrict__ sign,
                     int32_t* __restrict__ bits, int D, int q_ref,
                     float delta, float inv_n) {
  extern __shared__ float sm[];
  float* mag = sm;      // [D] |x|
  float* top = sm + D;  // [D] the top level's codes before the rebase
  __shared__ float s_lo[kAdaptWarps], s_hi[kAdaptWarps], red[kAdaptWarps];
  const size_t row = (size_t)blockIdx.x * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < D; i += kAdaptThreads) {
    const float v = load(x, x_bf16, row + i);
    const float m = fabsf(v);
    mag[i] = m;
    sign[row + i] = v > 0.f ? 1 : (v < 0.f ? -1 : 0);
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
  for (int w = 1; w < kAdaptWarps; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }

  // walk the levels down from the top while delta <= Delta (every thread
  // reads the same sums, so every thread takes the same branch)
  int chosen = q_ref;
  if (q_ref - 1 >= kMinBits) {
    const Level L0 = level_of(lo, hi, q_ref);
    for (int i = tid; i < D; i += kAdaptThreads) top[i] = code_of(mag[i], L0);
    // each thread reads back only its own entries of top: no barrier
    for (int q = q_ref - 1; q >= kMinBits; --q) {
      const Level L = level_of(lo, hi, q);
      const float inv_shift = ldexpf(1.f, q - q_ref);  // exact
      float d = 0.f;
      for (int i = tid; i < D; i += kAdaptThreads)
        d += fabsf(__fsub_rn(rintf(__fmul_rn(top[i], inv_shift)),
                             code_of(mag[i], L)));
      if (!(__fmul_rn(block_sum(d, red), inv_n) <= delta)) break;
      chosen = q;
    }
  }

  const Level L = level_of(lo, hi, chosen);
  for (int i = tid; i < D; i += kAdaptThreads)
    codes[row + i] = (int8_t)__fsub_rn(code_of(mag[i], L), L.c_lo);
  if (tid == 0) {
    scale[blockIdx.x] = L.s;
    zero[blockIdx.x] = __fsub_rn(L.z, L.c_lo);
    bits[blockIdx.x] = chosen + 1;  // the sign bit
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

// TAB-Q (Algorithm 1) in one launch, one block a token: codes (T, D) int8,
// scale and zero (T, 1) f32, sign (T, D) int8, bits (T,) int32 (sign bit
// included); max_bits in [2, 8]; D * 8 bytes of shared memory (at most
// kAdaptSmem: D <= 28,928). Returns cudaGetLastError() (0 = launched).
extern "C" int tabq_adaptive_launch(const void* x, int x_bf16, void* codes,
                                    void* scale, void* zero, void* sign,
                                    void* bits, int T, int D, int max_bits,
                                    float delta, void* stream) {
  const long long bytes = 8LL * D;
  if (T < 1 || D < 1 || max_bits < 2 || max_bits > 8 || bytes > kAdaptSmem)
    return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {};
  const cudaError_t e = smem_opt_in(tabq_adaptive_kernel, kAdaptSmem, opted);
  if (e != cudaSuccess) return (int)e;
  const float inv_n = 1.f / (float)D;  // IEEE: correctly rounded
  tabq_adaptive_kernel<<<T, kAdaptThreads, (size_t)bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, static_cast<int8_t*>(codes), static_cast<float*>(scale),
      static_cast<float*>(zero), static_cast<int8_t*>(sign),
      static_cast<int32_t*>(bits), D, max_bits - 1, delta, inv_n);
  return (int)cudaGetLastError();
}
