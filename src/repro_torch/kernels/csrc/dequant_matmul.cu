// Int8-weight matrix product (W8A16/W8A32) for Hopper (sm_90a): the OPSC
// front segment's projections.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py
// (dequant_matmul, pallas_call at line 52). Python wrapper, launch count and
// plain PyTorch version: repro_torch/kernels/dequant_matmul.py.
//
//   x      (M, K)  f32 or bf16
//   codes  (K, N)  int8    symmetric weight codes
//   scale  (N,)    f32     one scale per output channel
//   out    (M, N)  f32     (x @ codes) * scale, summed in f32
//
// The dequantized weights never exist in device memory: codes are widened
// to f32 in registers and the scale multiplies once at the end, as on the
// TPU. Any M, N, K (the TPU kernel needed its 128/128/512 blocks to divide
// them; llama2-7b's w_down has K = 11008 = 21.5 * 512).
//
// Bound: the decode product (M = 1) reads K*N code bytes for 2*K*N flops,
// so device-memory bytes bound it; a prefill product (M in the hundreds)
// has 2*M flops a code byte and is bound by operations (on the CUDA cores
// here; tensor cores are later work).
//
// Design, two kernels chosen by M:
//  * M <= 4 (decode): a split-K GEMV. A block of 8 warps covers 256
//    columns (each lane one 8-byte load of 8 codes, so a warp reads 256
//    contiguous bytes of a row; one code a lane when N or the base is not
//    8-byte aligned) and one K range; each warp walks every 8th row of the
//    range for up to 4 rows of x at once. The warps' sums meet in shared
//    memory. With more than one K range, each range writes its partial sums
//    to a workspace and a second kernel adds the ranges in a fixed order,
//    so a result does not depend on timing (no atomics).
//  * M > 4 (prefill): a tiled product, 64x64 outputs a block, K in steps of
//    16 staged in shared memory as f32, 4x4 outputs a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float load(const void* x, int bf16, size_t i) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(x)[i])
              : reinterpret_cast<const float*>(x)[i];
}

template <int VEC, int MT>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const void* __restrict__ x, int x_bf16,
            const int8_t* __restrict__ codes, const float* __restrict__ scale,
            float* __restrict__ out, float* __restrict__ partial, int M,
            int N, int K, int k_chunk) {
  constexpr int COLS = 32 * VEC;
  __shared__ float red[kGemvWarps][MT][COLS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_base = blockIdx.x * COLS;
  const int n0 = n_base + lane * VEC;
  const int m0 = blockIdx.z * MT;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;

  for (int k = k_begin + warp; k < k_end; k += kGemvWarps) {
    const int8_t* crow = codes + (size_t)k * N;
    float w[VEC];
    if (VEC == 8) {
      int2 v = make_int2(0, 0);
      if (n0 < N) v = *reinterpret_cast<const int2*>(crow + n0);
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) w[j] = (float)b[j];
    } else {
      w[0] = n0 < N ? (float)crow[n0] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xv =
          m0 + m < M ? load(x, x_bf16, (size_t)(m0 + m) * K + k) : 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp][m][lane * VEC + j] = acc[m][j];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * COLS; e += kGemvThreads) {
    const int m = e / COLS, c = e % COLS, n = n_base + c;
    if (m0 + m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[w][m][c];
    if (partial != nullptr)
      partial[((size_t)blockIdx.y * M + m0 + m) * N + n] = s;
    else
      out[(size_t)(m0 + m) * N + n] = s * scale[n];
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int splits,
                                     int M, int N) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[sp * mn + i];
    out[i] = s * scale[i % N];
  }
}

__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const void* __restrict__ x, int x_bf16,
            const int8_t* __restrict__ codes, const float* __restrict__ scale,
            float* __restrict__ out, int M, int N, int K) {
  // k-major tiles; the +1 keeps the transposed x stores free of bank
  // conflicts
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int r = e / kBK, c = e % kBK, m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? load(x, x_bf16, (size_t)m * K + k) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int r = e / kBN, c = e % kBN, k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? (float)codes[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

template <int VEC, int MT>
cudaError_t launch_gemv(const void* x, int x_bf16, const int8_t* codes,
                        const float* scale, float* out, float* partial, int M,
                        int N, int K, int splits, cudaStream_t st) {
  const int k_chunk = (K + splits - 1) / splits;
  const dim3 grid((N + 32 * VEC - 1) / (32 * VEC), splits, (M + MT - 1) / MT);
  gemv_kernel<VEC, MT><<<grid, kGemvThreads, 0, st>>>(
      x, x_bf16, codes, scale, out, splits > 1 ? partial : nullptr, M, N, K,
      k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(partial, scale, out, splits, M,
                                               N);
  return cudaGetLastError();
}

}  // namespace

// ``vec`` is 8 (N and the codes' address 8-byte aligned) or 1; ``mt`` 1 or
// 4 rows of x a GEMV block (M <= 4), 0 for the tiled kernel; ``splits`` K
// ranges of the GEMV, with ``partial`` a (splits, M, N) f32 workspace when
// splits > 1.
extern "C" int dequant_matmul_launch(const void* x, int x_bf16,
                                     const void* codes, const void* scale,
                                     void* out, void* partial, int M, int N,
                                     int K, int vec, int mt, int splits,
                                     void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > K ||
      (splits > 1 && partial == nullptr) || (vec != 8 && vec != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  if (mt == 0) {
    if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_kernel<<<grid, kGemmThreads, 0, st>>>(x, x_bf16, c, s, o, M, N, K);
    return (int)cudaGetLastError();
  }
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  if (mt == 1 && M == 1)
    return vec == 8 ? (int)launch_gemv<8, 1>(x, x_bf16, c, s, o, p, M, N, K,
                                             splits, st)
                    : (int)launch_gemv<1, 1>(x, x_bf16, c, s, o, p, M, N, K,
                                             splits, st);
  if (mt == 4 && M <= 4)
    return vec == 8 ? (int)launch_gemv<8, 4>(x, x_bf16, c, s, o, p, M, N, K,
                                             splits, st)
                    : (int)launch_gemv<1, 4>(x, x_bf16, c, s, o, p, M, N, K,
                                             splits, st);
  return (int)cudaErrorInvalidValue;
}
