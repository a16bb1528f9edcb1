// Token-packed varlen attention through the paged int8 KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/varlen_attention.py
// (varlen_attention, pallas_call at line 186). Python wrapper, launch count
// and plain PyTorch version: repro_torch/kernels/varlen_attention.py.
//
//   q            (K, T, G, hd)     f32 or bf16, one flat token batch; any
//                                  strides over (K, T), (G, hd) contiguous
//   k/v_codes    (P, K, page, hd)  int8     k/v_scale (P, K, page) f32
//   pool_pos     (P, page)         int32    (-1 = empty slot)
//   block_table  (R, nb)           int32
//   q_pos        (T,)              int32    per-token positions (-1 = pad)
//   tok_slot     (T,)              int32    per-token slot ids (-1 = pad)
//   start        (R,)              int32    each slot's first in-call
//                                           position (2^30 if absent)
//   k/v_fresh    (K, T, hd)        q's dtype, the call's own keys/values;
//                                  any strides over (K, T), hd contiguous
//   out          (K, T, G, hd)     f32, strides as given
//
// Semantics kept from the TPU kernel: one online softmax per query row over
// two key groups. HISTORY keys are the row's OWN slot's pool entries with
// 0 <= pos < start[slot] (the pool is post-update: this call's tokens are
// in it too, and the start bound keeps them from counting twice). FRESH
// keys are the call's k/v widened to f32, attended when the key carries the
// row's slot id and 0 <= q_pos[key] <= q_pos[row] (a block-diagonal causal
// mask over the flat batch). Scores are q.k/sqrt(hd) in f32. A row with
// slot -1, or with no valid key, gives exact zeros. Masking is by select: a
// masked key takes no part in the softmax. Slot ids must be below R.
//
// Bound: 4*hd f32 flops per (query row, valid key) on the CUDA cores, each
// needed history page read from device memory once; at the serving tick
// (a 256-token chunk beside eight decode rows) it is bound by operations.
//
// Design: the TPU grid sets all T rows against every page of every slot;
// here a row needs only its own slot's keys, so the work splits by slot
// with nothing to combine. One block of 8 warps takes a tile of 32 query
// rows of ONE kv-head (rows f = t*G + g of the flat batch, in order) and
// the z-th distinct slot among those rows (blockIdx.z; blocks past the
// tile's count exit at once), and computes that slot's rows completely:
//   * history: the slot's pool slots below start[slot] (page b holds
//     positions [b*page, (b+1)*page)), in tiles of 32 dequantized keys and
//     values staged in shared memory;
//   * fresh: the slot's keys at or before its rows' last position, found
//     by a ballot over each 32-column stretch of the buffer and folded 32 at
//     a time in buffer order, so that which keys share a tile, and so the
//     rounding of a row's result, depends on its segment alone, not on
//     where the segment sits in the buffer.
// A warp with no row of the slot skips a tile's arithmetic. Each warp owns
// 4 query rows with their own online-softmax state; lane j scores key j of
// the tile (float4 reads, key rows padded so the lanes hit distinct banks),
// the warp reduces max and sum with shuffles, and each lane accumulates
// hd/32 output dims of p.v. The block of slot 0 (z = 0) also writes the
// tile's pad rows as zeros. A tile's decode segments thus walk their
// histories in parallel blocks; a long history is still one block's serial
// walk. Tensor cores (wgmma), TMA and a lane-group walk for length-1
// segments are later work.

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

__device__ __forceinline__ float load_f(const void* p, long long i, int bf16) {
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
  // q rows, key tile (padded rows), value tile; then ints: key positions,
  // key slots, row positions, row slots, pending fresh-key columns and
  // their count
  return 4 * (kRows * HD + kKeys * (HD + 4) + kKeys * HD + 4 * kKeys +
              2 * kRows + 1);
}

// Fold the staged key tile into the warp's rows' online-softmax state. Key j
// counts for row c when it carries the row's slot (>= 0), its position is
// >= 0 and, for fresh keys (`causal`), not after the row's position.
template <int HD>
__device__ __forceinline__ void fold_tile(
    const float* qs, const float* ks, const float* vs, const int* kpos,
    const int* kslot, bool causal, const int (&qrow)[kRowsPerWarp],
    const int (&rslot)[kRowsPerWarp], int warp, int lane,
    float (&m)[kRowsPerWarp], float (&l)[kRowsPerWarp],
    float (&acc)[kRowsPerWarp][HD / 32]) {
  constexpr int KS = HD + 4;
  const int kp = kpos[lane], kslt = kslot[lane];
  bool valid[kRowsPerWarp];
  bool any = false;
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    valid[c] = rslot[c] >= 0 && kslt == rslot[c] && kp >= 0 &&
               (!causal || kp <= qrow[c]);
    any = any || valid[c];
  }
  if (!__any_sync(kFull, any)) return;  // no row of this warp sees the tile
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
    const float sc = valid[c] ? s[c] : kNegInf;
    const float m_new = fmaxf(m[c], warp_max(sc));
    p[c] = valid[c] ? expf(sc - m_new) : 0.f;
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
      for (int c = 0; c < kRowsPerWarp; ++c)
        acc[c][e] = fmaf(pj[c], v, acc[c][e]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
varlen_attention_kernel(
    const void* __restrict__ q, int in_bf16, float scale, long long q_sk,
    long long q_st, const int8_t* __restrict__ k_codes,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_codes,
    const float* __restrict__ v_scale, const int32_t* __restrict__ pool_pos,
    const int32_t* __restrict__ block_table,
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ tok_slot,
    const int32_t* __restrict__ start, const void* __restrict__ k_fresh,
    const void* __restrict__ v_fresh, long long f_sk, long long f_st,
    float* __restrict__ out, long long o_sk, long long o_st, int T, int K,
    int G, int page, int nb, int R) {
  constexpr int KS = HD + 4;
  constexpr int CPK = HD / 16;  // 16-code chunks per key
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [kRows][HD]
  float* ks = qs + kRows * HD;                     // [kKeys][HD + 4]
  float* vs = ks + kKeys * KS;                     // [kKeys][HD]
  int* kpos = reinterpret_cast<int*>(vs + kKeys * HD);  // [kKeys]
  int* kslot = kpos + kKeys;                       // [kKeys]
  int* rowpos = kslot + kKeys;                     // [kRows]
  int* rowslot = rowpos + kRows;                   // [kRows]
  int* cols = rowslot + kRows;                     // [2 * kKeys] pending
  int* n_pend = cols + 2 * kKeys;                  // [1] keys in cols

  const int f0 = blockIdx.x * kRows, kh = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rows = T * G;

  // this block's query rows: f = t*G + g over the flat batch
  if (tid < kRows) {
    const int f = f0 + tid;
    const int t = f / G;
    rowpos[tid] = f < n_rows ? q_pos[t] : -1;
    rowslot[tid] = f < n_rows ? tok_slot[t] : -1;
  }
  __syncthreads();
  // every thread finds the same z-th distinct slot of the tile (a row
  // opens a slot unless an earlier row carries it)
  int n_slots = 0, slot = -1;
  for (int i = 0; i < kRows; ++i) {
    const int s = rowslot[i];
    if (s < 0) continue;
    bool first = true;
    for (int j = 0; j < i; ++j) first = first && rowslot[j] != s;
    if (first) {
      if (n_slots == z) slot = s;
      ++n_slots;
    }
  }
  if (z > 0 && z >= n_slots) return;  // the tile has no z-th slot
  if (z == 0) {  // the tile's pad rows: exact zeros
    for (int idx = tid; idx < kRows * HD; idx += kThreads) {
      const int i = idx / HD, f = f0 + i;
      if (f < n_rows && rowslot[i] < 0) {
        const int t = f / G, g = f % G;
        out[kh * o_sk + t * o_st + (long long)g * HD + idx % HD] = 0.f;
      }
    }
    if (n_slots == 0) return;
  }
  int maxq = -1;  // the slot's last position among the tile's rows
  for (int i = 0; i < kRows; ++i)
    if (rowslot[i] == slot) maxq = max(maxq, rowpos[i]);

  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int i = idx / HD, d = idx % HD, f = f0 + i;
    float x = 0.f;
    if (f < n_rows) {
      const int t = f / G, g = f % G;
      x = load_f(q, kh * q_sk + t * q_st + (long long)g * HD + d, in_bf16);
    }
    qs[idx] = x * scale;
  }

  int qrow[kRowsPerWarp], rslot[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HD / 32];
#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    qrow[c] = rowpos[warp * kRowsPerWarp + c];
    // rows of other slots are another block's: they never see a key here
    rslot[c] = rowslot[warp * kRowsPerWarp + c] == slot ? slot : -1;
    m[c] = kNegInf;
    l[c] = 0.f;
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) acc[c][e] = 0.f;
  }
  // ---- history: the slot's pool slots below start
  if (slot < R) {
    const int st = start[slot];
    const int n_hist = min(st, nb * page);
    const int32_t* bt = block_table + (long long)slot * nb;
    for (int t0 = 0; t0 < n_hist; t0 += kKeys) {
      __syncthreads();  // the previous tile has been read
      for (int idx = tid; idx < kKeys * CPK; idx += kThreads) {
        const int j = idx / CPK, c = idx % CPK, t = t0 + j;
        float kx[16], vx[16];
        int pos = -1;
        if (t < n_hist) {
          const int b = t / page, off = t - b * page;
          const long long phys = bt[b];
          const long long sl = (phys * K + kh) * page + off;
          const int4 kraw =
              *reinterpret_cast<const int4*>(k_codes + sl * HD + c * 16);
          const int4 vraw =
              *reinterpret_cast<const int4*>(v_codes + sl * HD + c * 16);
          const int8_t* kc = reinterpret_cast<const int8_t*>(&kraw);
          const int8_t* vc = reinterpret_cast<const int8_t*>(&vraw);
          const float ksc = k_scale[sl], vsc = v_scale[sl];
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
        if (c == 0) {
          kpos[j] = pos;
          kslot[j] = slot;
        }
      }
      __syncthreads();
      fold_tile<HD>(qs, ks, vs, kpos, kslot, false, qrow, rslot, warp, lane,
                    m, l, acc);
    }
  }

  // ---- fresh: the slot's keys at or before its last row position, in
  // buffer order, gathered 32 at a time: the tiles then depend on the
  // slot's own keys only, not on where its segment sits in the buffer, so
  // a row's result does not change with its neighbours
  if (tid == 0) *n_pend = 0;
  for (int j0 = 0;; j0 += kKeys) {
    __syncthreads();  // the previous tile and list have been read
    if (warp == 0 && j0 < T) {  // append this stretch's keys of the slot
      const int jj = j0 + lane;
      bool match = false;
      if (jj < T) {
        const int kp = q_pos[jj];
        match = tok_slot[jj] == slot && kp >= 0 && kp <= maxq;
      }
      const unsigned ballot = __ballot_sync(kFull, match);
      const int base = *n_pend;
      if (match) cols[base + __popc(ballot & ((1u << lane) - 1u))] = jj;
      __syncwarp();
      if (lane == 0) *n_pend = base + __popc(ballot);
    }
    __syncthreads();
    const int n = *n_pend;  // the same in every thread: the loop is uniform
    const bool last = j0 + kKeys >= T;  // no stretch left to append
    // fold a full tile, or what is left after the last stretch
    const int take = n >= kKeys ? kKeys : (last ? n : 0);
    if (take == 0) {
      if (last) break;
      continue;
    }
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      float kx = 0.f, vx = 0.f;
      if (j < take) {
        const long long at = kh * f_sk + (long long)cols[j] * f_st + d;
        kx = load_f(k_fresh, at, in_bf16);
        vx = load_f(v_fresh, at, in_bf16);
      }
      ks[j * KS + d] = kx;
      vs[j * HD + d] = vx;
    }
    if (tid < kKeys) {
      kpos[tid] = tid < take ? q_pos[cols[tid]] : -1;
      kslot[tid] = slot;
    }
    __syncthreads();
    fold_tile<HD>(qs, ks, vs, kpos, kslot, true, qrow, rslot, warp, lane, m,
                  l, acc);
    __syncthreads();  // every warp has read the tile
    // keep the keys past the tile (fewer than 32: indices 32.. move to 0..)
    if (tid < n - take) cols[tid] = cols[tid + take];
    if (tid == 0) *n_pend = n - take;
    if (last && n == take) break;
  }

#pragma unroll
  for (int c = 0; c < kRowsPerWarp; ++c) {
    const int f = f0 + warp * kRowsPerWarp + c;
    if (f >= n_rows || rslot[c] < 0) continue;  // not this block's row
    const int t = f / G, g = f % G;
    float* o = out + kh * o_sk + t * o_st + (long long)g * HD;
    const bool seen = m[c] > 0.5f * kNegInf;
    const float inv = seen ? 1.f / fmaxf(l[c], 1e-30f) : 0.f;
#pragma unroll
    for (int e = 0; e < HD / 32; ++e)
      o[lane + 32 * e] = seen ? acc[c][e] * inv : 0.f;
  }
}

template <int HD>
cudaError_t launch(const void* q, int in_bf16, float scale, long long q_sk,
                   long long q_st, const void* kc, const void* ks,
                   const void* vc, const void* vs, const void* pool_pos,
                   const void* block_table, const void* q_pos,
                   const void* tok_slot, const void* start, const void* kf,
                   const void* vf, long long f_sk, long long f_st, void* out,
                   long long o_sk, long long o_st, int T, int K, int G,
                   int page, int nb, int R, cudaStream_t st) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;  // above 48 KB needs an opt-in, once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        varlen_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // z: the distinct slots a tile of kRows rows can hold
  const dim3 grid((T * G + kRows - 1) / kRows, K, min(kRows, R));
  varlen_attention_kernel<HD><<<grid, kThreads, bytes, st>>>(
      q, in_bf16, scale, q_sk, q_st, static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int32_t*>(pool_pos),
      static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(tok_slot),
      static_cast<const int32_t*>(start), kf, vf, f_sk, f_st,
      static_cast<float*>(out), o_sk, o_st, T, K, G, page, nb, R);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernel does not take. Strides are
// in elements: q and out over (K, T) with (G, hd) contiguous, the fresh
// k/v over (K, T) with hd contiguous.
extern "C" int varlen_attention_launch(
    const void* q, int in_bf16, float scale, long long q_sk, long long q_st,
    const void* k_codes, const void* k_scale, const void* v_codes,
    const void* v_scale, const void* pool_pos, const void* block_table,
    const void* q_pos, const void* tok_slot, const void* start,
    const void* k_fresh, const void* v_fresh, long long f_sk, long long f_st,
    void* out, long long o_sk, long long o_st, int T, int K, int G, int HD,
    int page, int nb, int R, void* stream) {
  if (T < 1 || K < 1 || G < 1 || nb < 1 || R < 1 || page < 1 || page > 64 ||
      K > 65535 || (long long)T * G > 2147483647LL - 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VARLEN_LAUNCH(D)                                                     \
  return (int)launch<D>(q, in_bf16, scale, q_sk, q_st, k_codes, k_scale,     \
                        v_codes, v_scale, pool_pos, block_table, q_pos,      \
                        tok_slot, start, k_fresh, v_fresh, f_sk, f_st, out,  \
                        o_sk, o_st, T, K, G, page, nb, R, st)
  switch (HD) {
    case 32: VARLEN_LAUNCH(32);
    case 64: VARLEN_LAUNCH(64);
    case 128: VARLEN_LAUNCH(128);
    case 256: VARLEN_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VARLEN_LAUNCH
}
