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
// Bound: 4*hd flops per (query row, valid key), with each needed history
// page read once per row and the f32 output written once. On the bf16
// tensor cores (the operands are exact there) a serving chunk is bound by
// its bytes, the f32 output first; on the CUDA cores by its operations.
//
// Two kernels, chosen in the wrapper by q's dtype (and hd, S, alignment):
//
//  * bf16 q (the main path): tc_prefill_kernel, FlashAttention-2 shaped.
//    One block of 4 warps per (tile of 64 query rows, kv-head, row r), so
//    each history page is read once per 64 query rows; each warp owns 16
//    rows, their Q fragments in registers. Key tiles of 64 (32 at hd 256)
//    come by cp.async into a two-stage ring: history through the block
//    table as int8 codes with their scales and positions, widened to bf16
//    (exact) in shared memory while the next tile is in flight; fresh keys
//    as bf16 rows, used as they land. S = Q.K^T on the tensor cores
//    (mma.sync.m16n8k16, f32 accumulators); each score column takes its
//    k_scale and 1/sqrt(hd) in f32 after the product; the online softmax
//    runs in f32 in registers (base 2). P.V on the tensor cores with P
//    times v_scale (1 for fresh keys) split into hi = bf16(p) and lo =
//    bf16(p - hi), two products summed in f32: one bf16 P would cost
//    about |v| * 2^-9 of the result. Fresh key tiles with no key at or
//    before the block's last query position are not loaded. mma.sync and
//    not wgmma: a 64-row tile is one wgmma's M, so a block of 64 query
//    rows would be one warpgroup with no second to overlap its softmax.
//  * f32 q: paged_prefill_attention_kernel, on the CUDA cores. One block
//    of 8 warps per (tile of 32 query rows, kv-head, row r); the block
//    stages the 32
//    query rows (scaled, f32) and one tile of 32 keys at a time
//    (dequantized or widened to f32) in shared memory. Each warp owns 4
//    query rows with their own online-softmax state; lane j scores key j
//    of the tile against the warp's rows (float4 reads, the key rows
//    padded so the lanes hit distinct banks), the warp reduces max and sum
//    with shuffles, and each lane accumulates hd/32 output dims of p.v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
  static bool opted[kMaxDevices] = {};  // above 48 KB needs an opt-in
  const cudaError_t e = smem_opt_in(paged_prefill_attention_kernel<HD>,
                                    bytes, opted);
  if (e != cudaSuccess) return e;
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

// ---- the tensor-core kernel (bf16 q)

constexpr int kTcRows = 64;  // query rows per block, 16 a warp
constexpr int kTcThreads = 128;
constexpr int kTcMaxS = 32768;     // fresh tiles tracked in a 1024-bit mask
constexpr int kTcMaskWords = 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tc {
  static constexpr int KT = HD == 256 ? 32 : 64;  // keys a tile
  static constexpr int CPR = HD / 8;              // 16-byte chunks a bf16 row
  static constexpr int TILE = KT * HD * 2;        // a bf16 K (or V) tile
  // a ring stage: K, V (int8 codes or bf16 rows), k/v scales, positions
  static constexpr int STAGE = 2 * TILE + 3 * KT * 4;
  // two stages, the widened history K and V (q's staging before the first
  // tile), each key's position and scales, the fresh-tile mask
  static constexpr int SMEM = 2 * STAGE + 2 * TILE + 3 * KT * 4 +
                              kTcMaskWords * 4;
  static_assert(2 * TILE >= kTcRows * HD * 2, "q staging fits");
};

// 16-byte chunk c of row r of a bf16 tile [rows][HD] sits at chunk
// swz(r, c): the 8 rows an ldmatrix reads at one logical chunk fall in 8
// different bank groups
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  return HD >= 64 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

template <int HD>
__device__ __forceinline__ int tile_offset(int r, int c) {
  return r * HD * 2 + swz<HD>(r, c) * 16;
}

// global -> shared, or zeros when !valid (the source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 int8 codes -> 2 bf16 pairs (exact): each code as 2^23 + (code + 128)
// in an f32 mantissa, minus 2^23 + 128; the f32's upper half is its bf16
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// 16 codes of row r (its 16-code chunk c) -> bf16 chunks 2c, 2c + 1
template <int HD>
__device__ __forceinline__ void widen16(const uint8_t* src, uint8_t* dst,
                                        int r, int c) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint2 a = widen4(raw.x), b = widen4(raw.y), e = widen4(raw.z),
              f = widen4(raw.w);
  *reinterpret_cast<uint4*>(dst + tile_offset<HD>(r, 2 * c)) =
      make_uint4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<uint4*>(dst + tile_offset<HD>(r, 2 * c + 1)) =
      make_uint4(e.x, e.y, f.x, f.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
tc_prefill_kernel(const __nv_bfloat16* __restrict__ q, float sm_scale,
                  const int8_t* __restrict__ k_codes,
                  const float* __restrict__ k_scale,
                  const int8_t* __restrict__ v_codes,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ pool_pos,
                  const int32_t* __restrict__ block_table,
                  const int32_t* __restrict__ q_pos,
                  const int32_t* __restrict__ start,
                  const __nv_bfloat16* __restrict__ k_fresh,
                  const __nv_bfloat16* __restrict__ v_fresh,
                  float* __restrict__ out, int S, int K, int G, int page,
                  int nb) {
  using C = Tc<HD>;
  constexpr int KT = C::KT, CPR = C::CPR, CH = HD / 16;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* kb = smem + 2 * C::STAGE;  // widened history K [KT][HD] bf16
  uint8_t* vb = kb + C::TILE;         // widened history V
  int* kpos = reinterpret_cast<int*>(vb + C::TILE);  // [KT], -1: no key
  float* csc = reinterpret_cast<float*>(kpos + KT);  // score scale, base 2
  float* vsc = csc + KT;                             // value scale
  unsigned* fmask = reinterpret_cast<unsigned*>(vsc + KT);
  __shared__ int rowpos[kTcRows];

  const int f0 = blockIdx.x * kTcRows, kh = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_rows = S * G;
  const int32_t* qp = q_pos + (size_t)r * S;

  if (tid < kTcRows) {
    const int f = f0 + tid;
    rowpos[tid] = f < n_rows ? qp[f / G] : -1;
  }
  if (tid < kTcMaskWords) fmask[tid] = 0u;
  __syncthreads();
  int maxq = -1;
#pragma unroll 8
  for (int i = 0; i < kTcRows; ++i) maxq = max(maxq, rowpos[i]);

  if (maxq < 0) {  // every query of the block is a pad: exact zeros
    for (int idx = tid; idx < kTcRows * HD / 4; idx += kTcThreads) {
      const int f = f0 + idx / (HD / 4);
      if (f < n_rows) {
        const int s = f / G, gg = f % G;
        reinterpret_cast<float4*>(
            out + ((((size_t)r * S + s) * K + kh) * G + gg) * HD)
            [idx % (HD / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // fresh tiles holding a key at or before the block's last query
  for (int j = tid; j < S; j += kTcThreads) {
    const int p = qp[j];
    if (p >= 0 && p <= maxq)
      atomicOr(&fmask[(j / KT) >> 5], 1u << ((j / KT) & 31));
  }
  __syncthreads();  // every thread walks the same tiles

  // the walk: history tiles below min(start, maxq + 1), then those fresh
  // tiles; tile code c < n_ht is history tile c, else fresh tile c - n_ht
  const int st = start[r];
  const int n_hist = min(min(st, maxq + 1), nb * page);
  const int n_ht = n_hist > 0 ? (n_hist + KT - 1) / KT : 0;
  const int n_ft = (S + KT - 1) / KT;
  const int end = n_ht + n_ft;
  const int32_t* bt = block_table + (size_t)r * nb;
  auto advance = [&](int code) {
    const int nxt = code + 1;
    if (nxt < n_ht) return nxt;
    for (int b = max(nxt - n_ht, 0); b < n_ft;) {
      const unsigned w = fmask[b >> 5] >> (b & 31);
      if (w) return n_ht + min(n_ft, b + __ffs(w) - 1);
      b = (b | 31) + 1;
    }
    return end;
  };

  auto load_tile = [&](int code, int s) {
    uint8_t* sk = smem + s * C::STAGE;
    uint8_t* sv = sk + C::TILE;
    float* sks = reinterpret_cast<float*>(sv + C::TILE);
    float* svs = sks + KT;
    int* spos = reinterpret_cast<int*>(svs + KT);
    if (code < n_ht) {  // int8 codes, rows of HD bytes as they are
      const int t0 = code * KT;
      for (int e = tid; e < KT * CH; e += kTcThreads) {
        const int j = e / CH, c = e % CH, tt = t0 + j;
        const bool ok = tt < n_hist;
        size_t slot = 0;
        if (ok) {
          const int b = tt / page;
          slot = ((size_t)bt[b] * K + kh) * page + (tt - b * page);
        }
        cp_async16(smem_u32(sk + j * HD + c * 16),
                   k_codes + slot * HD + c * 16, ok);
        cp_async16(smem_u32(sv + j * HD + c * 16),
                   v_codes + slot * HD + c * 16, ok);
      }
      for (int j = tid; j < KT; j += kTcThreads) {
        const int tt = t0 + j;
        const bool ok = tt < n_hist;
        size_t slot = 0, ps = 0;
        if (ok) {
          const int b = tt / page, off = tt - b * page;
          const size_t phys = (size_t)bt[b];
          slot = (phys * K + kh) * page + off;
          ps = phys * page + off;
        }
        cp_async4(smem_u32(sks + j), k_scale + slot, ok);
        cp_async4(smem_u32(svs + j), v_scale + slot, ok);
        cp_async4(smem_u32(spos + j), pool_pos + ps, ok);
      }
    } else {  // bf16 rows, swizzled as the tensor cores read them
      const int j0 = (code - n_ht) * KT;
      for (int e = tid; e < KT * CPR; e += kTcThreads) {
        const int j = e / CPR, c = e % CPR, jj = j0 + j;
        const bool ok = jj < S;
        const size_t at =
            ok ? (((size_t)r * S + jj) * K + kh) * HD + c * 8 : 0;
        const int o = tile_offset<HD>(j, c);
        cp_async16(smem_u32(sk + o), k_fresh + at, ok);
        cp_async16(smem_u32(sv + o), v_fresh + at, ok);
      }
      for (int j = tid; j < KT; j += kTcThreads)
        cp_async4(smem_u32(spos + j), qp + (j0 + j < S ? j0 + j : 0),
                  j0 + j < S);
    }
  };

  // q: 64 rows staged in kb (zeros past the last row), then each warp's
  // 16 rows as A fragments, in registers for the whole walk
  int code = advance(-1);
  if (code < end) load_tile(code, 0);
  cp_async_commit();
  for (int e = tid; e < kTcRows * CPR; e += kTcThreads) {
    const int i = e / CPR, c = e % CPR, f = f0 + i;
    const bool ok = f < n_rows;
    const size_t at =
        ok ? ((((size_t)r * S + f / G) * K + kh) * G + f % G) * HD + c * 8
           : 0;
    cp_async16(smem_u32(kb + tile_offset<HD>(i, c)), q + at, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int i = warp * 16 + (lane % 16);
    ldmatrix_x4(qa[kk], smem_u32(kb + tile_offset<HD>(i, kk * 2 + lane / 16)));
  }
  const int myq[2] = {rowpos[warp * 16 + g], rowpos[warp * 16 + g + 8]};

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  int s = 0;
  while (code < end) {
    const int next = advance(code);
    cp_async_wait_all();  // this tile's stage has landed
    __syncthreads();      // for every thread; the last tile is done with
    if (next < end) load_tile(next, s ^ 1);
    cp_async_commit();

    uint8_t* sk = smem + s * C::STAGE;
    uint8_t* sv = sk + C::TILE;
    const float* sks = reinterpret_cast<const float*>(sv + C::TILE);
    const float* svs = sks + KT;
    const int* spos = reinterpret_cast<const int*>(svs + KT);
    const uint8_t* ktile = sk;
    const uint8_t* vtile = sv;
    if (code < n_ht) {
      for (int e = tid; e < KT * CH; e += kTcThreads) {
        const int j = e / CH, c = e % CH;
        widen16<HD>(sk + j * HD + c * 16, kb, j, c);
        widen16<HD>(sv + j * HD + c * 16, vb, j, c);
      }
      for (int j = tid; j < KT; j += kTcThreads) {
        const int p = spos[j];
        // this call's own tokens (pos >= start) are fresh keys, not history
        const bool ok = code * KT + j < n_hist && p >= 0 && p < st;
        kpos[j] = ok ? p : -1;
        csc[j] = ok ? sks[j] * sm_scale * kLog2e : 0.f;
        vsc[j] = ok ? svs[j] : 0.f;
      }
      ktile = kb;
      vtile = vb;
    } else {
      for (int j = tid; j < KT; j += kTcThreads) {
        const int p = (code - n_ht) * KT + j < S ? spos[j] : -1;
        kpos[j] = p >= 0 ? p : -1;
        csc[j] = sm_scale * kLog2e;
        vsc[j] = 1.f;
      }
    }
    __syncthreads();

    // S = Q.K^T for the warp's 16 rows and the tile's KT keys
    float sc[KT / 8][4];
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        const int key = np * 16 + (lane / 16) * 8 + (lane % 8);
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(ktile + tile_offset<HD>(
                                            key, kk * 2 + ((lane / 8) & 1))));
        mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp's 16; a
    // row's 4 lanes share its max)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + 2 * t + (e & 1);
        const int kp = kpos[key];
        const bool ok = kp >= 0 && kp <= myq[e >> 1];
        sc[nt][e] = ok ? sc[nt][e] * csc[key] : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= corr[e >> 1];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[nt][e] > 0.5f * kNegInf
                            ? exp2f(sc[nt][e] - m[e >> 1])
                            : 0.f;
        l[e >> 1] += p;
        sc[nt][e] = p * vsc[nt * 8 + 2 * t + (e & 1)];
      }

    // O += P.V, P as hi + lo bf16
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a0: tile 2kk rows g; a1: rows g + 8; a2, a3: tile 2kk + 1
        const float p0 = sc[2 * kk + (i >> 1)][2 * (i & 1)];
        const float p1 = sc[2 * kk + (i >> 1)][2 * (i & 1) + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
        hi[i] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[i] = pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        const int key = kk * 16 + ((lane / 8) & 1) * 8 + (lane % 8);
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(vtile + tile_offset<HD>(key, 2 * dp + lane / 16)));
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    code = next;
    s ^= 1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int f = f0 + warp * 16 + g + 8 * h;
    if (f >= n_rows) continue;
    const int sq = f / G, gg = f % G;
    float* orow = out + ((((size_t)r * S + sq) * K + kh) * G + gg) * HD;
    const bool seen = m[h] > 0.5f * kNegInf;
    const float inv = seen ? 1.f / fmaxf(l[h], 1e-30f) : 0.f;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8 + 2 * t) =
          seen ? make_float2(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv)
               : make_float2(0.f, 0.f);
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, float scale, const void* kc,
                      const void* ks, const void* vc, const void* vs,
                      const void* pool_pos, const void* block_table,
                      const void* q_pos, const void* start, const void* kf,
                      const void* vf, void* out, int R, int S, int K, int G,
                      int page, int nb, cudaStream_t st) {
  constexpr int bytes = Tc<HD>::SMEM;
  static bool opted[kMaxDevices] = {};  // above 48 KB needs an opt-in
  const cudaError_t e = smem_opt_in(tc_prefill_kernel<HD>, bytes, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((S * G + kTcRows - 1) / kTcRows, K, R);
  tc_prefill_kernel<HD><<<grid, kTcThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), scale,
      static_cast<const int8_t*>(kc), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vc), static_cast<const float*>(vs),
      static_cast<const int32_t*>(pool_pos),
      static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(start),
      static_cast<const __nv_bfloat16*>(kf),
      static_cast<const __nv_bfloat16*>(vf), static_cast<float*>(out), S, K,
      G, page, nb);
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

// The tensor-core kernel: bf16 q and fresh k/v, S <= 32768, hd 32, 64, 128
// or 256, 16-byte aligned q, codes and fresh k/v.
extern "C" int paged_prefill_attention_tc_launch(
    const void* q, float scale, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, const void* pool_pos,
    const void* block_table, const void* q_pos, const void* start,
    const void* k_fresh, const void* v_fresh, void* out, int R, int S, int K,
    int G, int HD, int page, int nb, void* stream) {
  if (R < 1 || S < 1 || K < 1 || G < 1 || nb < 1 || page < 1 || R > 65535 ||
      K > 65535 || S > kTcMaxS ||
      ((uintptr_t)q | (uintptr_t)k_codes | (uintptr_t)v_codes |
       (uintptr_t)k_fresh | (uintptr_t)v_fresh) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32:
      return (int)launch_tc<32>(q, scale, k_codes, k_scale, v_codes, v_scale,
                                pool_pos, block_table, q_pos, start, k_fresh,
                                v_fresh, out, R, S, K, G, page, nb, st);
    case 64:
      return (int)launch_tc<64>(q, scale, k_codes, k_scale, v_codes, v_scale,
                                pool_pos, block_table, q_pos, start, k_fresh,
                                v_fresh, out, R, S, K, G, page, nb, st);
    case 128:
      return (int)launch_tc<128>(q, scale, k_codes, k_scale, v_codes,
                                 v_scale, pool_pos, block_table, q_pos, start,
                                 k_fresh, v_fresh, out, R, S, K, G, page, nb,
                                 st);
    case 256:
      return (int)launch_tc<256>(q, scale, k_codes, k_scale, v_codes,
                                 v_scale, pool_pos, block_table, q_pos, start,
                                 k_fresh, v_fresh, out, R, S, K, G, page, nb,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
