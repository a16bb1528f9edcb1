// Prefill attention through the paged int8 KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention, pallas_call at line 200). Python wrapper, launch
// count and plain PyTorch version:
// repro_torch/kernels/paged_prefill_attention.py.
//
//   q            (R, S, K, G, hd)  f32 or bf16 (the model's (R, S, H, hd))
//   k/v_codes    (P, K, page, hd)  int8     k/v_scale (P, K, page) f32
//   pool_pos     (P, page)         int32    (-1 = empty slot)
//   block_table  (R, nb)           int32
//   q_pos        (R, S)            int32    per-token positions (-1 = pad)
//   start        (R,)              int32    first in-call position of row r
//   k/v_fresh    (R, S, K, hd)     q's dtype, this call's own keys/values
//   out          (R, S, K, G, hd)  f32
//
// Semantics kept from the TPU kernel: one online softmax over two key
// groups. History keys are the row's pool slots with 0 <= pos < start[r]
// and pos <= q_pos (this call's own tokens are already in the pool, and
// the start bound keeps them from counting twice); fresh keys are the
// call's k/v widened to f32, attended when 0 <= q_pos[key] <= q_pos[query].
// Scores are q.k/sqrt(hd) in f32. A query with no valid key gives exact
// zeros. Masking is by select: a masked key takes no part in the softmax.
//
// Page b of a row holds positions [b*page, (b+1)*page), so the history walk
// covers logical slots below min(start, largest q_pos of the block + 1),
// and a block whose queries are all pads writes zeros at once.
//
// Bound: 4*hd f32 flops per (query row, valid key) on the CUDA cores, with
// each needed history page read from device memory once per row; at a
// serving chunk it is bound by operations.
//
// Design: one block of 8 warps per (tile of 32 query rows, kv-head, row r);
// the query rows of a (r, kv-head) are its S*G (position, head) pairs in
// order. The block stages the 32 query rows (scaled, f32) and one tile of
// 32 keys at a time (dequantized or widened to f32) in shared memory. Each
// warp owns 4 query rows with their own online-softmax state; lane j scores
// key j of the tile against the warp's rows (float4 reads, the key rows
// padded so the lanes hit distinct banks), the warp reduces max and sum
// with shuffles, and each lane accumulates hd/32 output dims of p.v.
// Tensor cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int HD>
constexpr int smem_bytes() {
  // q rows, key tile (padded rows), value tile, key positions, row positions
  return 4 * (kRows * HD + kKeys * (HD + 4) + kKeys * HD + kKeys + kRows);
}

// Fold the staged key tile into the warp's rows' online-softmax state.
template <int HD>
__device__ __forceinline__ void fold_tile(const float* qs, const float* ks,
                                          const float* vs, const int* kpos,
                                          const int (&qrow)[kRowsPerWarp],
                                          int warp, int lane,
                                          float (&m)[kRowsPerWarp],
                                          float (&l)[kRowsPerWarp],
                                          float (&acc)[kRowsPerWarp][HD / 32]) {
  constexpr int KS = HD + 4;
  const int kp = kpos[lane];
  float s[kRowsPerWarp];
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) s[c] = 0.f;
  const float4* krow = reinterpret_cast<const float4*>(ks + lane * KS);
#pragma unroll 4
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kv = krow[d4];
#pragma unroll
    for (int c = 0; c < kRowsPerWarp; ++c) {
      const float4 qv = reinterpret_cast<const float4*>(
          qs + (warp * kRowsPerWarp + c) * HD)[d4];
      s[c] = fmaf(qv.x, kv.x, s[c]);
      s[c] = fmaf(qv.y, kv.y, s[c]);
      s[c] = fmaf(qv.z, kv.z, s[c]);
      s[c] = fmaf(qv.w, kv.w, s[c]);
    }
  }
  float p[kRowsPerWarp];
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    const bool valid = kp >= 0 && kp <= qrow[c];
    const float sc = valid ? s[c] : kNegInf;
    const float m_new = fmaxf(m[c], warp_max(sc));
    p[c] = valid ? expf(sc - m_new) : 0.f;
    const float corr = expf(m[c] - m_new);
    l[c] = l[c] * corr + warp_sum(p[c]);
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) acc[c][e] *= corr;
    m[c] = m_new;
  }
#pragma unroll 4
  for (int j = 0; j < kKeys; ++j) {
    float pj[kRowsPerWarp];
#pragma unroll
    for (int c = 0; c < kRowsPerWarp; ++c) pj[c] = __shfl_sync(kFull, p[c], j);
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) {
      const float v = vs[j * HD + lane + 32 * e];
#pragma unroll
      for (int c = 0; c < kRowsPerWarp; ++c) acc[c][e] = fmaf(pj[c], v, acc[c][e]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_prefill_attention_kernel(
    const void* __restrict__ q, int in_bf16, float scale,
    const int8_t* __restrict__ k_codes, const float* __restrict__ k_scale,
    const int8_t* __restrict__ v_codes, const float* __restrict__ v_scale,
    const int32_t* __restrict__ pool_pos,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ start,
    const void* __restrict__ k_fresh, const void* __restrict__ v_fresh,
    float* __restrict__ out, int S, int K, int G, int page, int nb) {
  constexpr int KS = HD + 4;
  constexpr int CPK = HD / 16;  // 16-code chunks per key
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [kRows][HD]
  float* ks = qs + kRows * HD;                     // [kKeys][HD + 4]
  float* vs = ks + kKeys * KS;                     // [kKeys][HD]
  int* kpos = reinterpret_cast<int*>(vs + kKeys * HD);  // [kKeys]
  int* rowpos = kpos + kKeys;                      // [kRows]

  const int f0 = blockIdx.x * kRows, kh = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rows = S * G;

  // this block's query rows: f = s*G + g over the row's (position, head)
  if (tid < kRows) {
    const int f = f0 + tid;
    rowpos[tid] = f < n_rows ? q_pos[(size_t)r * S + f / G] : -1;
  }
  __syncthreads();
  int maxq = -1;
#pragma unroll 8
  for (int i = 0; i < kRows; ++i) maxq = max(maxq, rowpos[i]);

  if (maxq < 0) {  // every query of the block is a pad: exact zeros
    for (int idx = tid; idx < kRows * HD; idx += kThreads) {
      const int f = f0 + idx / HD;
      if (f < n_rows) {
        const int s = f / G, g = f % G;
        out[((((size_t)r * S + s) * K + kh) * G + g) * HD + idx % HD] = 0.f;
      }
    }
    return;
  }

  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, f = f0 + i;
    float x = 0.f;
    if (f < n_rows) {
      const int s = f / G, g = f % G;
      x = load_f(q, ((((size_t)r * S + s) * K + kh) * G + g) * HD + d,
                 in_bf16);
    }
    qs[idx] = x * scale;
  }

  int qrow[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HD / 32];
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    qrow[c] = rowpos[warp * kRowsPerWarp + c];
    m[c] = kNegInf;
    l[c] = 0.f;
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) acc[c][e] = 0.f;
  }

  // ---- history: the row's pool slots below min(start, maxq + 1)
  const int st = start[r];
  const int n_hist = min(min(st, maxq + 1), nb * page);
  const int32_t* bt = block_table + (size_t)r * nb;
  for (int t0 = 0; t0 < n_hist; t0 += kKeys) {
    __syncthreads();  // the previous tile has been read
    for (int idx = tid; idx < kKeys * CPK; idx += kThreads) {
      const int j = idx / CPK, c = idx % CPK, t = t0 + j;
      float kx[16], vx[16];
      int pos = -1;
      if (t < n_hist) {
        const int b = t / page, off = t - b * page;
        const size_t phys = (size_t)bt[b];
        const size_t slot = (phys * K + kh) * page + off;
        const int4 kraw =
            *reinterpret_cast<const int4*>(k_codes + slot * HD + c * 16);
        const int4 vraw =
            *reinterpret_cast<const int4*>(v_codes + slot * HD + c * 16);
        const int8_t* kc = reinterpret_cast<const int8_t*>(&kraw);
        const int8_t* vc = reinterpret_cast<const int8_t*>(&vraw);
        const float ksc = k_scale[slot], vsc = v_scale[slot];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          kx[e] = (float)kc[e] * ksc;
          vx[e] = (float)vc[e] * vsc;
        }
        pos = pool_pos[phys * page + off];
        if (pos >= st) pos = -1;  // this call's own tokens: not history
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 16; e += 4) {
        *reinterpret_cast<float4*>(ks + j * KS + c * 16 + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(vs + j * HD + c * 16 + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
      if (c == 0) kpos[j] = pos;
    }
    __syncthreads();
    fold_tile<HD>(qs, ks, vs, kpos, qrow, warp, lane, m, l, acc);
  }

  // ---- fresh: the call's own keys, causal by position
  for (int j0 = 0; j0 < S; j0 += kKeys) {
    __syncthreads();  // the previous tile has been read
    bool useful = false;
    if (tid < kKeys) {
      const int jj = j0 + tid;
      const int kp = jj < S ? q_pos[(size_t)r * S + jj] : -1;
      kpos[tid] = kp;
      useful = kp >= 0 && kp <= maxq;
    }
    if (!__syncthreads_or(useful)) continue;  // no key of the tile counts
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, jj = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (jj < S) {
        const size_t at = (((size_t)r * S + jj) * K + kh) * HD + d;
        kx = load_f(k_fresh, at, in_bf16);
        vx = load_f(v_fresh, at, in_bf16);
      }
      ks[j * KS + d] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();
    fold_tile<HD>(qs, ks, vs, kpos, qrow, warp, lane, m, l, acc);
  }

#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    const int f = f0 + warp * kRowsPerWarp + c;
    if (f >= n_rows) continue;
    const int s = f / G, g = f % G;
    float* o = out + ((((size_t)r * S + s) * K + kh) * G + g) * HD;
    const bool seen = m[c] > 0.5f * kNegInf;
    const float inv = seen ? 1.f / fmaxf(l[c], 1e-30f) : 0.f;
#pragma unroll
    for (int e = 0; e < HD / 32; ++e)
      o[lane + 32 * e] = seen ? acc[c][e] * inv : 0.f;
  }
}

template <int HD>
cudaError_t launch(const void* q, int in_bf16, float scale, const void* kc,
                   const void* ks, const void* vc, const void* vs,
                   const void* pool_pos, const void* block_table,
                   const void* q_pos, const void* start, const void* kf,
                   const void* vf, void* out, int R, int S, int K, int G,
                   int page, int nb, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;  // above 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((S * G + kRows - 1) / kRows, K, R);
  paged_prefill_attention_kernel<HD><<<grid, kThreads, bytes, st>>>(
      q, in_bf16, scale, static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int32_t*>(pool_pos),
      static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(start),
      kf, vf, static_cast<float*>(out), S, K, G, page, nb);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_prefill_attention_launch(
    const void* q, int in_bf16, float scale, const void* k_codes,
    const void* k_scale, const void* v_codes, const void* v_scale,
    const void* pool_pos, const void* block_table, const void* q_pos,
    const void* start, const void* k_fresh, const void* v_fresh, void* out,
    int R, int S, int K, int G, int HD, int page, int nb, void* stream) {
  if (R < 1 || S < 1 || K < 1 || G < 1 || nb < 1 || page < 1 || page > 64 ||
      R > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32:
      return (int)launch<32>(q, in_bf16, scale, k_codes, k_scale, v_codes,
                             v_scale, pool_pos, block_table, q_pos, start,
                             k_fresh, v_fresh, out, R, S, K, G, page, nb, st);
    case 64:
      return (int)launch<64>(q, in_bf16, scale, k_codes, k_scale, v_codes,
                             v_scale, pool_pos, block_table, q_pos, start,
                             k_fresh, v_fresh, out, R, S, K, G, page, nb, st);
    case 128:
      return (int)launch<128>(q, in_bf16, scale, k_codes, k_scale, v_codes,
                              v_scale, pool_pos, block_table, q_pos, start,
                              k_fresh, v_fresh, out, R, S, K, G, page, nb, st);
    case 256:
      return (int)launch<256>(q, in_bf16, scale, k_codes, k_scale, v_codes,
                              v_scale, pool_pos, block_table, q_pos, start,
                              k_fresh, v_fresh, out, R, S, K, G, page, nb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
