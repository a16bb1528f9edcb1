// Int8-weight matrix product (W8A16/W8A32) for Hopper (sm_90a): the OPSC
// front segment's projections.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py
// (dequant_matmul, pallas_call at line 52). Python wrapper, route choice,
// launch counts and plain PyTorch version:
// repro_torch/kernels/dequant_matmul.py.
//
//   x      (M, K)  f32 or bf16
//   codes  (K, N)  int8    symmetric weight codes
//   scale  (N,)    f32     one scale per output channel
//   out    (M, N)  f32     (x @ codes) * scale, summed in f32
//
// The dequantized weights never exist in device memory: codes are widened
// in registers and the scale multiplies once at the end, as on the TPU.
// Any M, N, K (the TPU kernel needed its 128/128/512 blocks to divide
// them; llama2-7b's w_down has K = 11008 = 21.5 * 512).
//
// Bound: the decode product (M = 1) reads K*N code bytes for 2*K*N flops,
// so device-memory bytes bound it. A prefill product has 2*M flops a code
// byte; on the bf16 tensor cores (about 295 flops a byte at the ridge) the
// code bytes still bound it up to M of about 150, the operations above.
//
// Five kernels, chosen by the wrapper from shapes and dtypes:
//  * M <= 4 (decode), N % 16 == 0 and a 16-byte aligned code base (every
//    projection of llama2-7b): gemv16_kernel, a split-K GEMV built to keep
//    the code bytes in flight. A block of 8 warps covers 512 columns and
//    one K range: each lane reads 16 codes of a row with one 16-byte
//    read-only load, so a warp reads 512 contiguous bytes, and each warp
//    issues the loads of U code rows (and of its next U; U = 4 at one row
//    of x, 8 at four) before the first FMA on them. The block stages its
//    K range of x once in shared memory, widened to f32, so the FMA loop
//    reads no x from device memory. Codes widen to f32 exactly by a byte
//    permute and one FADD (I2F runs at a quarter of that rate). The warps'
//    sums meet in shared memory in warp order; with more than one K range
//    each block writes its sums to a workspace and takes a ticket per
//    column tile, and the block that takes the last adds the ranges in
//    range order, scales, writes out and resets the ticket (no float
//    atomics, one launch, graph-safe).
//  * M <= 4 with a ragged N or an unaligned base: gemv_kernel, the older
//    GEMV. A block of 8 warps covers 256 columns (each lane one 8-byte load
//    of 8 codes, so a warp reads 256 contiguous bytes of a row; one code a
//    lane when N or the base is not 8-byte aligned) and one K range; each
//    warp walks every 8th row of the range for up to 4 rows of x at once.
//    The warps' sums meet in shared memory. With more than one K range,
//    each range writes its partial sums to a workspace and a second kernel
//    adds the ranges in a fixed order, so a result does not depend on
//    timing (no atomics).
//  * bf16 x with M at or above the wrapper's threshold (a long prefill,
//    rows of several prompts), the same alignment: tc_large_kernel, the
//    same arithmetic in a persistent, warp-specialised kernel (see its
//    note below): tiles of rows of x sized to M so that the units of work
//    fill the SMs evenly, a producer warp feeding the ring by TMA against
//    "empty" mbarriers, two consumer warpgroups that only widen codes and
//    run wgmma;
//  * smaller M > 4, bf16 x, N % 16 == 0, K % 8 == 0, 16-byte aligned bases
//    (prefill): a split-K product on the tensor cores (tc_gemm_kernel)
//    with wgmma, computed transposed, out^T = codes^T . x^T: 128 columns of
//    out by 128 rows of x a block, 64 columns a warpgroup. K in steps of
//    64 through a 4-stage ring in shared memory, each stage filled by two
//    TMA copies (x's rows and the codes' rows, both in the 128-byte
//    swizzle) completing on an mbarrier. x is wgmma's operand B, read from
//    shared memory by descriptor. Each step a warpgroup widens the next
//    step's codes to bf16 (exact) in registers, its operand A, while its
//    wgmma of this step run (f32 accumulators): a lane reads the two
//    adjacent codes of its A rows g and g + 8 with one 2-byte load a row.
//    The scale multiplies once at the end. The K ranges fill the SMs (two
//    blocks each) and meet in splitk_reduce_kernel as the GEMV's do.
//  * other M > 4 (f32 x, a ragged N or K, an unaligned base): the tiled
//    CUDA-core product, 64x64 outputs a block, K in steps of 16 staged in
//    shared memory as f32, 4x4 outputs a thread.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

// ---- the decode GEMV on 16-byte aligned codes (see the note at the top)

constexpr int kGemvCols = 512;  // columns a block: 16 a lane
// code rows a warp loads before using them: 4 at one row of x, 8 at four
// (where the FMAs on a row take four times as long)
template <int MT>
constexpr int gemv_unroll() { return MT == 1 ? 4 : 8; }
// the staged x rows and the warps' sums stay within the static limit
constexpr int kGemvSmemMax = 48 * 1024;

// 16 codes by one read-only load that does not allocate in L1: each code
// byte is read once
__device__ __forceinline__ uint4 ld_codes16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z) = (512-column tile, K range
// of k_chunk rows, tile of MT rows of x). Warp w takes rows pass * PASS +
// w * U + u of its range (u = 0 .. U - 1) for every pass, summed in that
// order with fmaf. ``tickets`` holds one zeroed int a (column tile, row
// tile) when gridDim.y > 1.
template <int MT, int U>
__global__ void __launch_bounds__(kGemvThreads, MT == 1 ? 2 : 1)
gemv16_kernel(const void* __restrict__ x, int x_bf16,
              const int8_t* __restrict__ codes,
              const float* __restrict__ scale, float* __restrict__ out,
              float* __restrict__ partial, int* __restrict__ tickets, int M,
              int N, int K, int k_chunk) {
  constexpr int PASS = kGemvWarps * U;
  extern __shared__ __align__(16) float gemv_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_base = blockIdx.x * kGemvCols, n0 = n_base + lane * 16;
  const int m0 = blockIdx.z * MT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k_begin = split * k_chunk;
  const int n_rows = min(K, k_begin + k_chunk) - k_begin;
  const int passes = (k_chunk + PASS - 1) / PASS;
  float* xs = gemv_smem;                 // [passes * PASS][MT]
  float* red = xs + passes * PASS * MT;  // [MT][16][32]: column lane*16+j

  // N % 16 == 0: a lane's 16 columns are all in or all out
  const bool col_ok = n0 < N;
  const int8_t* crow = codes + (size_t)k_begin * N + n0;
  auto fetch = [&](uint4 (&v)[U], int pass) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = pass * PASS + warp * U + u;
      v[u] = col_ok && r < n_rows ? ld_codes16(crow + (size_t)r * N)
                                  : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 cur[U];
  fetch(cur, 0);  // the first rows are in flight while x is staged

  for (int e = threadIdx.x; e < passes * PASS * MT; e += kGemvThreads) {
    const int r = e / MT, m = e % MT;
    xs[e] = r < n_rows && m0 + m < M
                ? load(x, x_bf16, (size_t)(m0 + m) * K + k_begin + r)
                : 0.f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int p = 0; p < passes; ++p) {
    uint4 nxt[U];
    fetch(nxt, p + 1);  // zeros past the range: no load
    const float* xp = xs + (p * PASS + warp * U) * MT;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float w[16];
      widen4(cur[u].x, w);
      widen4(cur[u].y, w + 4);
      widen4(cur[u].z, w + 8);
      widen4(cur[u].w, w + 12);
      float xv[MT];
      if constexpr (MT == 4) {
        const float4 t = *reinterpret_cast<const float4*>(xp + u * MT);
        xv[0] = t.x;
        xv[1] = t.y;
        xv[2] = t.z;
        xv[3] = t.w;
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = xp[u * MT + m];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }

  // the warps' sums in warp order: all but the last through shared
  // memory, the last adds its own in registers
  for (int w = 0; w < kGemvWarps - 1; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float& r = red[(m * 16 + j) * 32 + lane];
          r = w == 0 ? acc[m][j] : r + acc[m][j];
        }
    }
    __syncthreads();
  }
  if (warp == kGemvWarps - 1 && col_ok) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) continue;
      float s[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s[j] = red[(m * 16 + j) * 32 + lane] + acc[m][j];
      float* dst = splits == 1
                       ? out + (size_t)(m0 + m) * N + n0
                       : partial + ((size_t)split * M + m0 + m) * N + n0;
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        float4 v = make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
        if (splits == 1) {
          const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + j);
          v.x *= sc.x;
          v.y *= sc.y;
          v.z *= sc.z;
          v.w *= sc.w;
        }
        *reinterpret_cast<float4*>(dst + j) = v;
      }
    }
    __threadfence();  // the sums are visible before the ticket is taken
  }
  if (splits == 1) return;

  // the block that takes a tile's last ticket adds its K ranges in order
  __shared__ int last;
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread's outputs, the loads of RANGES ranges in flight at a time
  // (within the registers that keep two blocks an SM at one row of x)
  constexpr int PER = MT * kGemvCols / kGemvThreads;
  constexpr int RANGES = 32 / PER;
  size_t at[PER];
  bool ok[PER];
  float s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * kGemvThreads;
    const int m = e / kGemvCols, n = n_base + e % kGemvCols;
    ok[i] = m0 + m < M && n < N;
    at[i] = (size_t)(m0 + m) * N + n;
    s[i] = 0.f;
  }
  const size_t stride = (size_t)M * N;
  for (int sp0 = 0; sp0 < splits; sp0 += RANGES) {
    float v[RANGES][PER];
#pragma unroll
    for (int u = 0; u < RANGES; ++u)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        v[u][i] = ok[i] && sp0 + u < splits
                      ? __ldcg(partial + (sp0 + u) * stride + at[i])
                      : 0.f;
#pragma unroll
    for (int u = 0; u < RANGES; ++u)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (sp0 + u < splits) s[i] += v[u][i];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (ok[i]) out[at[i]] = s[i] * scale[at[i] % N];
  if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next call
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

// ---- the tensor-core product (M > 4, bf16 x): out^T = codes^T . x^T, so
// that the widened codes are wgmma's register operand A and x's staged
// rows its shared-memory operand B

constexpr int kTcBM = 128;  // rows of x a block (wgmma's N)
constexpr int kTcBN = 128;  // columns of out a block: 64 a warpgroup
constexpr int kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTcXBytes = kTcBM * kTcBK * 2;
constexpr int kTcStage = kTcXBytes + kTcBK * kTcBN;  // 24 KB, 1 KB-aligned
// the stages, their barriers, and slack to align the stages to 1 KB
constexpr int kTcSmem = kTcStages * kTcStage + kTcStages * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// the TMA copy of the box at (c0 inner, c1 outer) of ``map`` into shared
// memory, completing on ``bar``; out-of-bounds elements land as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps a register that an asynchronous wgmma reads or writes where it is
// until here (the compiler does not know the wgmma is still running)
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// shared-memory descriptor of a K-major bf16 tile of 8-row x 128-byte
// atoms with the 128-byte swizzle, the atoms 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N f32) += a (64 x 16 bf16, registers) * B (16 x N bf16, shared
// memory, K-major): one specialisation for each N a kernel takes
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15, "
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31, "
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47, "
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<104>(float (&d)[52],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<200>(float (&d)[100],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99}, "
      "{%100, %101, %102, %103}, %104, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


// byte j (0..3) of a word of int8 codes whose sign bits are flipped, as
// f32: 2^23 + (code + 128) built in the mantissa, minus 2^23 + 128 (exact)
__device__ __forceinline__ float code_at(uint32_t flipped, int j) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540 + j)) -
         8388736.f;
}

// two f32 that are small integers (exact in bf16) as a bf16 pair, lo in
// the low half: their upper halves
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__global__ void __launch_bounds__(kTcThreads, 2)
tc_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap codes_map,
               const float* __restrict__ scale, float* __restrict__ out,
               float* __restrict__ partial, int M, int N, int K,
               int k_chunk) {
  extern __shared__ uint8_t tc_raw[];
  // the swizzle repeats every 1024 bytes: stages start on that boundary
  uint8_t* smem = tc_raw + ((1024 - (smem_u32(tc_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + kTcStages * kTcStage);  // barriers
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * kTcBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int steps = (k_end - k_begin + kTcBK - 1) / kTcBK;

  // stage s, filled by one thread's two TMA copies completing on barrier
  // s: the x tile [128][64] bf16, then the codes tile [64][128] int8, both
  // in the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r & 7))
  auto load_stage = [&](int s, int step) {
    const uint32_t base = smem_u32(smem + s * kTcStage);
    const int k0 = k_begin + step * kTcBK;
    mbar_expect_tx(full + 8 * s, kTcStage);
    tma_load_2d(base, &x_map, full + 8 * s, k0, m0);
    tma_load_2d(base + kTcXBytes, &codes_map, full + 8 * s, n0, k0);
  };

  // A of warp w (rows 16w .. 16w + 15 of its warpgroup's 64): row q + 8h
  // is out column n0 + a_col - 2g + 2q + h, so lane (g, t) reads the two
  // adjacent codes of its rows g and g + 8 with one load from each of rows
  // 2t, 2t+1, 2t+8, 2t+9 of a k16 step (the swizzle puts the four rows'
  // chunks in distinct banks)
  const int a_col = (warp / 4) * 64 + (warp % 4) * 16 + 2 * g;
  auto widen_a = [&](int s, uint32_t (&a)[4][4]) {
    const uint8_t* cs = smem + s * kTcStage + kTcXBytes + (a_col & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];  // bytes: row g, row g + 8; sign bits flipped
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = kk * 16 + 2 * t + (i & 1) + 8 * (i >> 1);
        r[i] = *reinterpret_cast<const uint16_t*>(
                   cs + row * kTcBN + (((a_col >> 4) ^ (row & 7)) << 4)) ^
               0x8080u;
      }
      a[kk][0] = pack_exact(code_at(r[0], 0), code_at(r[1], 0));
      a[kk][1] = pack_exact(code_at(r[0], 1), code_at(r[1], 1));
      a[kk][2] = pack_exact(code_at(r[2], 0), code_at(r[3], 0));
      a[kk][3] = pack_exact(code_at(r[2], 1), code_at(r[3], 1));
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  // one K step: 4 wgmma of this stage's x with ``a`` (widened the step
  // before); while they run, the last step's wgmma are waited for, which
  // frees ``a_next`` and the last step's stage for the step kTcStages - 1
  // ahead, and the next step's codes are widened into ``a_next``
  auto step_once = [&](int step, uint32_t (&a)[4][4],
                       uint32_t (&a_next)[4][4]) {
    const uint32_t xs = smem_u32(smem + (step % kTcStages) * kTcStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<128>(d, a[kk], sw128_desc(xs + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(a_next[kk][e]);
    __syncthreads();  // every warpgroup is past the last step's wgmma
    if (tid == 0 && step + kTcStages - 1 < steps)
      load_stage((step + kTcStages - 1) % kTcStages, step + kTcStages - 1);
    if (step + 1 < steps) {
      const int s = (step + 1) % kTcStages;
      mbar_wait(full + 8 * s, ((step + 1) / kTcStages) & 1);
      widen_a(s, a_next);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kTcStages - 1 && s < steps; ++s) load_stage(s, s);
  mbar_wait(full, 0);  // stage 0 has landed
  uint32_t a0[4][4], a1[4][4];  // two buffers: registers are not indexed
  widen_a(0, a0);
  for (int step = 0; step < steps; step += 2) {
    step_once(step, a0, a1);
    if (step + 1 < steps) step_once(step + 1, a1, a0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) keep(d[i]);

  // lane (g, t) holds, for each 8-row group j of the x tile, rows
  // m0 + 8j + 2t + e at out columns n0 + a_col (its A row g) and
  // n0 + a_col + 1 (row g + 8)
  const int n = n0 + a_col;
  if (n >= N) return;  // N % 16 == 0: both columns or neither
  const float2 sc = *reinterpret_cast<const float2*>(scale + n);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= M) continue;
      float2 v = make_float2(d[4 * j + e], d[4 * j + 2 + e]);
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.z * M + m) * N + n) = v;
      } else {
        v.x *= sc.x;
        v.y *= sc.y;
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) = v;
      }
    }
  }
}

// ---- the large-M product (bf16 x, M >= the wrapper's threshold):
// tc_large_kernel, warp-specialised and persistent. The tile is 128 * JN
// columns of out by BM rows of x, BM chosen by the wrapper to fit M
// (wgmma's N); a unit of work is a tile and one K range. One CTA an SM
// walks units blockIdx.x, + gridDim.x, ...: one thread of the producer
// warpgroup (which hands its registers to the consumers) keeps a ring of
// stages full by TMA (x's rows and JN boxes of codes), waiting on each
// stage's "empty" mbarrier; two consumer warpgroups, 64 * JN columns each,
// wait on its "full" mbarrier and, as tc_gemm_kernel does, run one group
// of wgmma a K step with the codes widened into registers (operand A) the
// step before, and release the stage by arriving on "empty" once the wgmma
// that read it have completed: no block-wide barrier in the K loop, and
// the producer runs ahead into the next unit while the consumers store
// this one's results. What holds it back: a K step costs a fixed time
// beside its tile's rows, most of it the widening, which overlaps the
// tensor cores little, as a wgmma's issue waits for its register operand
// (the wrapper's plan weighs both). Widening the codes in the producer's
// warps, or into shared memory for wgmma to read, was slower.

constexpr int kLgConsumerWarps = 8;                         // two warpgroups
constexpr int kLgThreads = (kLgConsumerWarps + 4) * 32;     // + the producer's
// registers a thread: the producer warpgroup gives its own up to the
// consumers' accumulators (128 * 40 + 256 * 232 <= 64K)
constexpr int kLgProducerRegs = 40, kLgConsumerRegs = 232;
constexpr int kLgRing = 212992;  // bytes of shared memory for the ring

template <int BM, int JN>
struct Lg {
  static constexpr int XBYTES = BM * kTcBK * 2;           // x's BM rows
  static constexpr int STAGE = XBYTES + JN * kTcBK * 128;  // + JN code boxes
  static constexpr int STAGES = kLgRing / STAGE < 8 ? kLgRing / STAGE : 8;
  // the stages, full and empty barriers, slack to align the stages to 1 KB
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(XBYTES % 1024 == 0, "stages keep the swizzle's alignment");
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbar_wait that traps after about 10 s instead of hanging the card, should
// a phase never complete
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar,
                                                  uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  }
}

template <int BM, int JN>
__global__ void __launch_bounds__(kLgThreads, 1)
tc_large_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap codes_map,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ partial, int M, int N, int K,
                int tiles_m, int tiles_n, int splits, int k_chunk) {
  using L = Lg<BM, JN>;
  extern __shared__ uint8_t lg_raw[];
  uint8_t* smem = lg_raw + ((1024 - (smem_u32(lg_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + L::STAGES * L::STAGE);
  const uint32_t empty = full + 8 * L::STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int units = tiles_m * tiles_n * splits;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kLgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // unit u: row tile fastest, so the CTAs that run together share codes
  auto unit = [&](int u, int& m0, int& n0, int& k_begin, int& steps) {
    const int r = u % tiles_m, z = (u / tiles_m) % splits;
    const int c = u / (tiles_m * splits);
    m0 = r * BM;
    n0 = c * 128 * JN;
    k_begin = z * k_chunk;
    steps = (min(K, k_begin + k_chunk) - k_begin + kTcBK - 1) / kTcBK;
    return z;
  };

  if (warp >= kLgConsumerWarps) {  // the producer: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kLgProducerRegs));
    if (warp != kLgConsumerWarps || lane != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int m0, n0, k_begin, steps;
      unit(u, m0, n0, k_begin, steps);
      for (int step = 0; step < steps; ++step, ++it) {
        const int s = it % L::STAGES;
        if (it >= L::STAGES)  // the consumers have released the stage
          mbar_wait_bounded(empty + 8 * s, ((it / L::STAGES) - 1) & 1);
        const uint32_t base = smem_u32(smem + s * L::STAGE);
        const int k0 = k_begin + step * kTcBK;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        tma_load_2d(base, &x_map, full + 8 * s, k0, m0);
#pragma unroll
        for (int h = 0; h < JN; ++h)
          tma_load_2d(base + L::XBYTES + h * kTcBK * 128, &codes_map,
                      full + 8 * s, n0 + 128 * h, k0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kLgConsumerRegs));
  // consumer warp (wg, wq) holds, for sub-tile j, A rows g and g + 8 as
  // tile column col[j] and col[j] + 1 (box col[j] / 128 of the stage)
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  int col[JN];
#pragma unroll
  for (int j = 0; j < JN; ++j) col[j] = (wg * JN + j) * 64 + wq * 16 + 2 * g;
  // a K step's A fragments from the stage's codes: four k16 slices (a
  // lane reads the two adjacent codes of its rows g and g + 8 with one
  // 2-byte load a K row; the swizzle puts the four rows in distinct banks)
  auto widen = [&](const uint8_t* cs, uint32_t (&a)[4][JN][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const uint8_t* box = cs + (col[j] >> 7) * (kTcBK * 128) +
                             (col[j] & 15);
        const int c16 = (col[j] & 127) >> 4;
        uint32_t r[4];  // bytes: row g, row g + 8; sign bits flipped
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = kk * 16 + 2 * t + (i & 1) + 8 * (i >> 1);
          r[i] = *reinterpret_cast<const uint16_t*>(
                     box + row * 128 + ((c16 ^ (row & 7)) << 4)) ^
                 0x8080u;
        }
        a[kk][j][0] = pack_exact(code_at(r[0], 0), code_at(r[1], 0));
        a[kk][j][1] = pack_exact(code_at(r[0], 1), code_at(r[1], 1));
        a[kk][j][2] = pack_exact(code_at(r[2], 0), code_at(r[3], 0));
        a[kk][j][3] = pack_exact(code_at(r[2], 1), code_at(r[3], 1));
      }
    }
  };

  float d[JN][BM / 2];
  int it = 0;  // the ring position of the step being multiplied
  // one K step: its 4 * JN wgmma with ``a`` (widened the step before) as
  // one group; then the last step's group is waited for, which frees
  // ``a_next`` and the last step's stage (released to the producer), and
  // the next step's codes are widened into ``a_next``
  auto step_once = [&](int step, int steps, uint32_t (&a)[4][JN][4],
                       uint32_t (&a_next)[4][JN][4]) {
    const uint32_t xs = smem_u32(smem + (it % L::STAGES) * L::STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < JN; ++j)
        wgmma_rs<BM>(d[j], a[kk][j], sw128_desc(xs + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < JN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) keep(a_next[kk][j][e]);
    if (step > 0 && lane == 0)
      mbar_arrive(empty + 8 * ((it - 1) % L::STAGES));
    ++it;
    if (step + 1 < steps) {
      const int s = it % L::STAGES;
      mbar_wait_bounded(full + 8 * s, (it / L::STAGES) & 1);
      widen(smem + s * L::STAGE + L::XBYTES, a_next);
    }
  };

  uint32_t a0[4][JN][4], a1[4][JN][4];  // registers are not indexed
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int m0, n0, k_begin, steps;
    const int z = unit(u, m0, n0, k_begin, steps);
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) d[j][i] = 0.f;
    {
      const int s = it % L::STAGES;
      mbar_wait_bounded(full + 8 * s, (it / L::STAGES) & 1);
      widen(smem + s * L::STAGE + L::XBYTES, a0);
    }
    for (int step = 0; step < steps; step += 2) {
      step_once(step, steps, a0, a1);
      if (step + 1 < steps) step_once(step + 1, steps, a1, a0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) keep(d[j][i]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % L::STAGES));

    // lane (g, t) holds, for each 8-row group jj of the x tile, rows
    // m0 + 8jj + 2t + e at out columns n0 + col[j] and n0 + col[j] + 1
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int n = n0 + col[j];
      if (n >= N) continue;  // N % 16 == 0: both columns or neither
      const float2 sc = *reinterpret_cast<const float2*>(scale + n);
#pragma unroll
      for (int jj = 0; jj < BM / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * jj + 2 * t + e;
          if (m >= M) continue;
          float2 v = make_float2(d[j][4 * jj + e], d[j][4 * jj + 2 + e]);
          if (partial != nullptr) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)z * M + m) * N + n) = v;
          } else {
            v.x *= sc.x;
            v.y *= sc.y;
            *reinterpret_cast<float2*>(out + (size_t)m * N + n) = v;
          }
        }
      }
    }
  }
}

cudaError_t launch_reduce(const float* partial, const float* scale,
                          float* out, int splits, int M, int N,
                          cudaStream_t st) {
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(partial, scale, out, splits,
                                               M, N);
  return cudaGetLastError();
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
  return launch_reduce(partial, scale, out, splits, M, N, st);
}

template <int MT>
cudaError_t launch_gemv16(const void* x, int x_bf16, const int8_t* codes,
                          const float* scale, float* out, float* partial,
                          int* tickets, int M, int N, int K, int splits,
                          cudaStream_t st) {
  constexpr int U = gemv_unroll<MT>(), PASS = kGemvWarps * U;
  const int k_chunk = (K + splits - 1) / splits;
  const int rows = (k_chunk + PASS - 1) / PASS * PASS;
  const size_t bytes = ((size_t)rows * MT + MT * kGemvCols) * sizeof(float);
  if (bytes > kGemvSmemMax) return cudaErrorInvalidValue;
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, splits, (M + MT - 1) / MT);
  gemv16_kernel<MT, U><<<grid, kGemvThreads, bytes, st>>>(
      x, x_bf16, codes, scale, out, splits > 1 ? partial : nullptr,
      splits > 1 ? tickets : nullptr, M, N, K, k_chunk);
  return cudaGetLastError();
}


// x (M, K) bf16 in boxes of 64 x ``rows`` rows; codes (K, N) int8 in boxes
// of 128 x 64 rows; both with the 128-byte swizzle. The entry point of
// cuTensorMapEncodeTiled is looked up once a process: a tensor map does not
// depend on the device.
cudaError_t encode_maps(CUtensorMap (&maps)[2], const void* x,
                        const void* codes, int M, int N, int K, int rows) {
  static decltype(&cuTensorMapEncodeTiled) encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(fn);
  }
  const cuuint64_t x_dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t c_dim[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t x_stride[1] = {(cuuint64_t)K * 2};
  const cuuint64_t c_stride[1] = {(cuuint64_t)N};
  const cuuint32_t x_box[2] = {kTcBK, (cuuint32_t)rows};
  const cuuint32_t c_box[2] = {kTcBN, kTcBK};
  const cuuint32_t one[2] = {1, 1};
  if (encode(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(x), x_dim, x_stride, x_box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<void*>(codes), c_dim, c_stride, c_box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

struct LargeArgs {
  const float* scale;
  float* out;
  float* partial;
  int M, N, K, splits, k_chunk, ctas;
  cudaStream_t st;
};

template <int BM, int JN>
cudaError_t launch_large(const CUtensorMap (&maps)[2], const LargeArgs& a) {
  constexpr int bytes = Lg<BM, JN>::SMEM;
  static bool opted[kMaxDevices] = {};
  cudaError_t e = smem_opt_in(tc_large_kernel<BM, JN>, bytes, opted);
  if (e != cudaSuccess) return e;
  const int tiles_m = (a.M + BM - 1) / BM;
  const int tiles_n = (a.N + 128 * JN - 1) / (128 * JN);
  tc_large_kernel<BM, JN><<<a.ctas, kLgThreads, bytes, a.st>>>(
      maps[0], maps[1], a.scale, a.out, a.partial, a.M, a.N, a.K, tiles_m,
      tiles_n, a.splits, a.k_chunk);
  return cudaGetLastError();
}

}  // namespace

// ``vec`` is 16 (N and the codes' address 16-byte aligned), 8 (8-byte) or
// 1; ``mt`` 1 or 4 rows of x a GEMV block (M <= 4), 0 for the tiled kernel;
// ``splits`` K ranges of the GEMV, with ``partial`` a (splits, M, N) f32
// workspace when splits > 1, and for vec 16 also ``tickets``: one int a
// (512-column tile, tile of mt rows), zero before the call and after it.
extern "C" int dequant_matmul_launch(const void* x, int x_bf16,
                                     const void* codes, const void* scale,
                                     void* out, void* partial, void* tickets,
                                     int M, int N, int K, int vec, int mt,
                                     int splits, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || splits > K ||
      (splits > 1 && partial == nullptr) ||
      (vec != 16 && vec != 8 && vec != 1) ||
      (vec == 16 && (N % 16 || (uintptr_t)codes % 16 || (uintptr_t)scale % 16 ||
                     (splits > 1 && tickets == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  int* t = static_cast<int*>(tickets);
  if (mt == 0) {
    if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_kernel<<<grid, kGemmThreads, 0, st>>>(x, x_bf16, c, s, o, M, N, K);
    return (int)cudaGetLastError();
  }
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  if (vec == 16) {
    if (mt == 1 && M == 1)
      return (int)launch_gemv16<1>(x, x_bf16, c, s, o, p, t, M, N, K, splits,
                                   st);
    if (mt == 4 && M <= 4)
      return (int)launch_gemv16<4>(x, x_bf16, c, s, o, p, t, M, N, K, splits,
                                   st);
    return (int)cudaErrorInvalidValue;
  }
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

// The tensor-core product: ``splits`` K ranges of ``k_chunk`` rows (a
// multiple of 64), with ``partial`` a (splits, M, N) f32 workspace when
// splits > 1. Needs N % 16 == 0, K % 8 == 0 and 16-byte aligned x, codes
// and scale.
extern "C" int dequant_matmul_tc_launch(const void* x, const void* codes,
                                        const void* scale, void* out,
                                        void* partial, int M, int N, int K,
                                        int splits, int k_chunk,
                                        void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 16 || K % 8 || splits < 1 ||
      k_chunk < 1 || k_chunk % kTcBK || (long long)splits * k_chunk < K ||
      (long long)(splits - 1) * k_chunk >= K ||
      (splits > 1 && partial == nullptr) ||
      (M + kTcBM - 1) / kTcBM > 65535 || splits > 65535 ||
      ((uintptr_t)x | (uintptr_t)codes | (uintptr_t)scale) % 16)
    return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {};
  cudaError_t e = smem_opt_in(tc_gemm_kernel, kTcSmem, opted);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[2];
  e = encode_maps(maps, x, codes, M, N, K, kTcBM);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM, splits);
  float* p = static_cast<float*>(partial);
  tc_gemm_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
      maps[0], maps[1], static_cast<const float*>(scale),
      static_cast<float*>(out), splits > 1 ? p : nullptr, M, N, K, k_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)launch_reduce(p, static_cast<const float*>(scale),
                            static_cast<float*>(out), splits, M, N, st);
}

// The large-M product: tiles of ``bm`` rows of x (96, 104, 128, or with
// ``jn`` 1 also 200 and 256) by 128 * ``jn`` columns of out, ``splits`` K
// ranges of ``k_chunk`` rows (a multiple of 64), walked by ``ctas`` CTAs;
// ``partial`` as for dequant_matmul_tc_launch. The same needs as that one.
extern "C" int dequant_matmul_large_launch(const void* x, const void* codes,
                                           const void* scale, void* out,
                                           void* partial, int M, int N,
                                           int K, int bm, int jn, int splits,
                                           int k_chunk, int ctas,
                                           void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 16 || K % 8 || splits < 1 ||
      k_chunk < 1 || k_chunk % kTcBK || (long long)splits * k_chunk < K ||
      (long long)(splits - 1) * k_chunk >= K ||
      (splits > 1 && partial == nullptr) || ctas < 1 || bm < 1 ||
      (long long)((M + bm - 1) / bm) * ((N + 128 * jn - 1) / (128 * jn)) *
              splits > 2147483647LL ||
      ((uintptr_t)x | (uintptr_t)codes | (uintptr_t)scale) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  cudaError_t e = encode_maps(maps, x, codes, M, N, K, bm);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LargeArgs args{static_cast<const float*>(scale), static_cast<float*>(out),
                 splits > 1 ? static_cast<float*>(partial) : nullptr,
                 M, N, K, splits, k_chunk, ctas, st};
  if (jn == 2 && bm == 96) e = launch_large<96, 2>(maps, args);
  else if (jn == 2 && bm == 104) e = launch_large<104, 2>(maps, args);
  else if (jn == 2 && bm == 128) e = launch_large<128, 2>(maps, args);
  else if (jn == 1 && bm == 96) e = launch_large<96, 1>(maps, args);
  else if (jn == 1 && bm == 104) e = launch_large<104, 1>(maps, args);
  else if (jn == 1 && bm == 128) e = launch_large<128, 1>(maps, args);
  else if (jn == 1 && bm == 200) e = launch_large<200, 1>(maps, args);
  else if (jn == 1 && bm == 256) e = launch_large<256, 1>(maps, args);
  else return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)launch_reduce(static_cast<float*>(partial), args.scale,
                            args.out, splits, M, N, st);
}
