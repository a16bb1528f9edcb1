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
// Bound: 4*hd flops per (query row, valid key), each needed history page
// read from device memory once. At the serving tick (a 256-token chunk
// beside eight decode rows) f32 on the CUDA cores is bound by operations,
// bf16 on the tensor cores by the history's bytes.
//
// Two routes, chosen in the wrapper by q's dtype (and hd, T, alignment):
//  * bf16 q (the main path): tc_varlen_kernel and varlen_combine_kernel,
//    below: prefill segments on the tensor cores (K3's arithmetic, tiles
//    of 64 query rows of one segment), decode segments on the CUDA cores
//    with a long history split over several blocks and merged in a fixed
//    order. Bound by the history bytes at the serving tick.
//  * f32 q: varlen_attention_kernel, f32 on the CUDA cores:
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
// histories in parallel blocks; a long history is one block's serial walk
// here (the bf16 route splits it).

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
  static bool opted[kMaxDevices] = {};  // above 48 KB needs an opt-in
  const cudaError_t e = smem_opt_in(varlen_attention_kernel<HD>, bytes,
                                    opted);
  if (e != cudaSuccess) return e;
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

// ---- the bf16 route: tc_varlen_kernel and varlen_combine_kernel
//
// The wrapper builds a work list on the device (``segment_rows``): the
// buffer's rows ordered by slot, each segment's rows in buffer order, pads
// (slot outside [0, R)) last as slot R, then each slot's first index into
// that order and its row count. Segments need not be contiguous in the
// buffer; every tile and split below is counted from the start of its
// segment or its slot's history, never from an offset in the buffer, so a
// row's bits do not depend on where its segment sits.
//
// tc_varlen_kernel's grid is (prefill units + decode units, K), shapes
// only: ceil(T*G / 64) + R units for the prefill segments (more than one
// row), which are enough for any partition of T rows among R slots, then
// R * splits * G units for decode segments (one row). A unit that finds no
// work exits at once.
//  * A prefill unit is a tile of 64 query rows of one segment (rows
//    f = i*G + g of its segment, in order) and one kv-head, K3's
//    tensor-core arithmetic: the slot's history tiles below start, then
//    the segment's fresh keys in tiles (a tile with no key at or before
//    the tile's last query position is skipped), each tile by cp.async
//    into a two-stage ring; int8 history widened exactly to bf16 in shared
//    memory; S = Q.K^T by mma.sync.m16n8k16 with f32 accumulators; each
//    score column times k_scale * log2(e) / sqrt(hd) after the product; a
//    base-2 online softmax in f32; P.V with P * v_scale split into hi + lo
//    bf16. The history is read once a tile of 64 query rows.
//  * A decode unit is one query head of a one-row segment and one split of
//    the slot's history, ``kSplit`` keys (K2's walk, spread over blocks):
//    the split's codes, scales and positions come into shared memory by
//    cp.async all at once, then lane groups of hd/16 lanes walk the keys
//    with their own online softmax in f32 (the query pre-scaled by
//    1/sqrt(hd), each score times k_scale), merged by shuffles across the
//    warp and through shared memory across warps. Split 0 also folds the
//    row's own fresh key. Each split writes its (max, sum, weighted values)
//    to a workspace.
// varlen_combine_kernel, one block a (slot, kv-head), then merges a decode
// row's splits in split order (a run repeats its bits) and writes the row,
// and the block of slot R writes the pads' exact zeros.

constexpr int kTcRows = 64;  // query rows a prefill unit, 16 a warp
constexpr int kTcThreads = 128;
constexpr int kTcMaxT = 32768;  // fresh tiles tracked in a 1024-bit mask
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
  static constexpr int PREFILL = 2 * STAGE + 2 * TILE + 3 * KT * 4 +
                                 kTcMaskWords * 4;
  static constexpr int SPLIT = HD == 256 ? 128 : 256;  // keys a decode unit
  // a split's k and v codes, scales and positions
  static constexpr int DECODE = SPLIT * (2 * HD + 12);
  static constexpr int SMEM = PREFILL > DECODE ? PREFILL : DECODE;
  static_assert(2 * TILE >= kTcRows * HD * 2, "q staging fits");
  static_assert(4 * (HD + 2) * 4 <= DECODE, "the warps' merge fits");
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

struct VarlenArgs {
  const __nv_bfloat16* q;
  float sm_scale;
  long long q_sk, q_st;
  const int8_t* k_codes;
  const float* k_scale;
  const int8_t* v_codes;
  const float* v_scale;
  const int32_t* pool_pos;
  const int32_t* block_table;
  const int32_t* q_pos;
  const int32_t* start;
  const int32_t* rows;  // the work list: order (T), first (R+1), count (R+1)
  const __nv_bfloat16* k_fresh;
  const __nv_bfloat16* v_fresh;
  long long f_sk, f_st;
  float* out;
  long long o_sk, o_st;
  float* part;  // decode splits: (R, splits, K, G) x hd values, then 2 each
  int T, K, G, page, nb, R, prefill_units, splits;
};

template <int HD>
__device__ __forceinline__ void prefill_unit(const VarlenArgs& a, int u,
                                             int kh, uint8_t* smem) {
  using C = Tc<HD>;
  constexpr int KT = C::KT, CPR = C::CPR, CH = HD / 16;
  __shared__ int rowpos[kTcRows], rowt[kTcRows];
  const int* order = a.rows;
  const int* first = a.rows + a.T;
  const int* count = first + a.R + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // the u-th tile among the prefill segments' tiles, in slot order
  int slot = -1, tile = 0;
  for (int s = 0, acc = 0; s < a.R; ++s) {
    const int c = count[s];
    if (c < 2) continue;
    const int nt = (c * a.G + kTcRows - 1) / kTcRows;
    if (u < acc + nt) {
      slot = s;
      tile = u - acc;
      break;
    }
    acc += nt;
  }
  if (slot < 0) return;  // fewer tiles than the grid allows for
  const int seg0 = first[slot], n_seg = count[slot];
  const int n_q = n_seg * a.G, f0 = tile * kTcRows;

  uint8_t* kb = smem + 2 * C::STAGE;  // widened history K [KT][HD] bf16
  uint8_t* vb = kb + C::TILE;         // widened history V
  int* kpos = reinterpret_cast<int*>(vb + C::TILE);  // [KT], -1: no key
  float* csc = reinterpret_cast<float*>(kpos + KT);  // score scale, base 2
  float* vsc = csc + KT;                             // value scale
  unsigned* fmask = reinterpret_cast<unsigned*>(vsc + KT);

  if (tid < kTcRows) {
    const int f = f0 + tid;
    const int row = f < n_q ? order[seg0 + f / a.G] : -1;
    rowt[tid] = row;
    rowpos[tid] = row >= 0 ? a.q_pos[row] : -1;
  }
  if (tid < kTcMaskWords) fmask[tid] = 0u;
  __syncthreads();
  int maxq = -1;
#pragma unroll 8
  for (int i = 0; i < kTcRows; ++i) maxq = max(maxq, rowpos[i]);
  // the segment's fresh tiles holding a key at or before the last query
  for (int j = tid; j < n_seg; j += kTcThreads) {
    const int p = a.q_pos[order[seg0 + j]];
    if (p >= 0 && p <= maxq)
      atomicOr(&fmask[(j / KT) >> 5], 1u << ((j / KT) & 31));
  }
  __syncthreads();  // every thread walks the same tiles

  // the walk: history tiles below min(start, the table's slots), then
  // those fresh tiles; tile code c < n_ht is history tile c, else fresh
  // tile c - n_ht
  const int st = a.start[slot];
  const int n_hist = min(st, a.nb * a.page);
  const int n_ht = n_hist > 0 ? (n_hist + KT - 1) / KT : 0;
  const int n_ft = (n_seg + KT - 1) / KT;
  const int end = n_ht + n_ft;
  const int32_t* bt = a.block_table + (size_t)slot * a.nb;
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
        size_t sl = 0;
        if (ok) {
          const int b = tt / a.page;
          sl = ((size_t)bt[b] * a.K + kh) * a.page + (tt - b * a.page);
        }
        cp_async16(smem_u32(sk + j * HD + c * 16),
                   a.k_codes + sl * HD + c * 16, ok);
        cp_async16(smem_u32(sv + j * HD + c * 16),
                   a.v_codes + sl * HD + c * 16, ok);
      }
      for (int j = tid; j < KT; j += kTcThreads) {
        const int tt = t0 + j;
        const bool ok = tt < n_hist;
        size_t sl = 0, ps = 0;
        if (ok) {
          const int b = tt / a.page, off = tt - b * a.page;
          const size_t phys = (size_t)bt[b];
          sl = (phys * a.K + kh) * a.page + off;
          ps = phys * a.page + off;
        }
        cp_async4(smem_u32(sks + j), a.k_scale + sl, ok);
        cp_async4(smem_u32(svs + j), a.v_scale + sl, ok);
        cp_async4(smem_u32(spos + j), a.pool_pos + ps, ok);
      }
    } else {  // the segment's bf16 rows, swizzled as the tensor cores read
      const int j0 = (code - n_ht) * KT;
      for (int e = tid; e < KT * CPR; e += kTcThreads) {
        const int j = e / CPR, c = e % CPR, jj = j0 + j;
        const bool ok = jj < n_seg;
        const size_t at =
            ok ? kh * a.f_sk + order[seg0 + jj] * a.f_st + c * 8 : 0;
        const int o = tile_offset<HD>(j, c);
        cp_async16(smem_u32(sk + o), a.k_fresh + at, ok);
        cp_async16(smem_u32(sv + o), a.v_fresh + at, ok);
      }
      for (int j = tid; j < KT; j += kTcThreads)  // read with the stage
        spos[j] = j0 + j < n_seg ? a.q_pos[order[seg0 + j0 + j]] : -1;
    }
  };

  // q: 64 rows staged in kb (zeros past the last row), then each warp's
  // 16 rows as A fragments, in registers for the whole walk
  int code = advance(-1);
  if (code < end) load_tile(code, 0);
  cp_async_commit();
  for (int e = tid; e < kTcRows * CPR; e += kTcThreads) {
    const int i = e / CPR, c = e % CPR, row = rowt[i];
    const size_t at =
        row >= 0 ? kh * a.q_sk + row * a.q_st +
                       (long long)((f0 + i) % a.G) * HD + c * 8
                 : 0;
    cp_async16(smem_u32(kb + tile_offset<HD>(i, c)), a.q + at, row >= 0);
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
    const bool hist = code < n_ht;
    if (hist) {
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
        csc[j] = ok ? sks[j] * a.sm_scale * kLog2e : 0.f;
        vsc[j] = ok ? svs[j] : 0.f;
      }
      ktile = kb;
      vtile = vb;
    } else {
      for (int j = tid; j < KT; j += kTcThreads) {
        kpos[j] = spos[j] >= 0 ? spos[j] : -1;
        csc[j] = a.sm_scale * kLog2e;
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
    // row's 4 lanes share its max). A history key counts for every row of
    // the slot, a fresh key for rows at or after its position.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + 2 * t + (e & 1);
        const int kp = kpos[key];
        const bool ok = kp >= 0 && (hist || kp <= myq[e >> 1]);
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
    const int i = warp * 16 + g + 8 * h, row = rowt[i];
    if (row < 0) continue;
    float* orow = a.out + kh * a.o_sk + row * a.o_st +
                  (long long)((f0 + i) % a.G) * HD;
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
__device__ __forceinline__ void decode_unit(const VarlenArgs& a, int u,
                                            int kh, uint8_t* smem) {
  using C = Tc<HD>;
  constexpr int CH = HD / 16;     // 16-code chunks a key: its lanes
  constexpr int SPW = 32 / CH;    // keys a warp a step
  constexpr int SPB = 4 * SPW;    // keys a block a step
  const int* order = a.rows;
  const int* first = a.rows + a.T;
  const int* count = first + a.R + 1;
  const int g = u % a.G, split = (u / a.G) % a.splits;
  const int slot = u / (a.G * a.splits);
  if (count[slot] != 1) return;  // not a decode segment
  const int row = order[first[slot]];
  const int st = a.start[slot];
  const int n_hist = min(st, a.nb * a.page);
  const int k0 = split * C::SPLIT;
  if (split > 0 && k0 >= n_hist) return;  // the combine reads no more
  const int n = max(0, min(n_hist, k0 + C::SPLIT) - k0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / CH, j = lane % CH;

  int8_t* kc = reinterpret_cast<int8_t*>(smem);  // [SPLIT][HD]
  int8_t* vc = kc + C::SPLIT * HD;
  float* ksc = reinterpret_cast<float*>(vc + C::SPLIT * HD);  // [SPLIT]
  float* vsc = ksc + C::SPLIT;
  int* kps = reinterpret_cast<int*>(vsc + C::SPLIT);

  // the split's codes, scales and positions, all in flight at once
  const int32_t* bt = a.block_table + (size_t)slot * a.nb;
  for (int e = tid; e < n * CH; e += kTcThreads) {
    const int jj = e / CH, c = e % CH, tt = k0 + jj, b = tt / a.page;
    const size_t sl = ((size_t)bt[b] * a.K + kh) * a.page + (tt - b * a.page);
    cp_async16(smem_u32(kc + jj * HD + c * 16), a.k_codes + sl * HD + c * 16,
               true);
    cp_async16(smem_u32(vc + jj * HD + c * 16), a.v_codes + sl * HD + c * 16,
               true);
  }
  for (int jj = tid; jj < n; jj += kTcThreads) {
    const int tt = k0 + jj, b = tt / a.page, off = tt - b * a.page;
    const size_t phys = (size_t)bt[b];
    const size_t sl = (phys * a.K + kh) * a.page + off;
    cp_async4(smem_u32(ksc + jj), a.k_scale + sl, true);
    cp_async4(smem_u32(vsc + jj), a.v_scale + sl, true);
    cp_async4(smem_u32(kps + jj), a.pool_pos + phys * a.page + off, true);
  }
  cp_async_commit();

  // this lane's 16-dim slice of the query, pre-scaled by 1/sqrt(hd)
  const long long qrow = kh * a.q_sk + row * a.q_st + (long long)g * HD;
  float qv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    qv[i] = __bfloat162float(a.q[qrow + j * 16 + i]) * a.sm_scale;
  float m = kNegInf, l = 0.f, acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  // every lane runs every step, so the shuffles see the full warp; a lane
  // group whose key is absent or masked skips the softmax update
  auto fold = [&](const int8_t* kr, const int8_t* vr, float ks, float vs,
                  bool valid) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dot = fmaf(qv[i], (float)kr[i], dot);
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    if (valid) {
      const float s = dot * ks;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float pr = expf(s - m_new);
      l = l * corr + pr;
      const float pv = pr * vs;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[i] = fmaf(pv, (float)vr[i], acc[i] * corr);
      m = m_new;
    }
  };
  for (int base = 0; base < n; base += SPB) {
    const int key = base + warp * SPW + sub;
    const int kk = key < n ? key : 0;
    int4 kraw = *reinterpret_cast<const int4*>(kc + kk * HD + j * 16);
    int4 vraw = *reinterpret_cast<const int4*>(vc + kk * HD + j * 16);
    const int p = key < n ? kps[kk] : -1;
    fold(reinterpret_cast<const int8_t*>(&kraw),
         reinterpret_cast<const int8_t*>(&vraw), ksc[kk], vsc[kk],
         p >= 0 && p < st);
  }
  float* red = reinterpret_cast<float*>(smem);  // after the walk: reused
  if (split == 0 && warp == 0) {  // the row's own fresh key, widened to f32
    const long long at = kh * a.f_sk + row * a.f_st + j * 16;
    float kf[16], vf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      kf[i] = __bfloat162float(a.k_fresh[at + i]);
      vf[i] = __bfloat162float(a.v_fresh[at + i]);
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dot = fmaf(qv[i], kf[i], dot);
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    if (sub == 0 && a.q_pos[row] >= 0) {
      const float m_new = fmaxf(m, dot);
      const float corr = expf(m - m_new);
      const float pr = expf(dot - m_new);
      l = l * corr + pr;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(pr, vf[i], acc[i] * corr);
      m = m_new;
    }
  }

  // merge the lane groups of this warp (same j, different keys); a group
  // that saw no valid key has m = -1e30, l = 0, acc = 0 and weighs nothing
#pragma unroll
  for (int off = CH; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, off);
    const float lo = __shfl_xor_sync(kFull, l, off);
    const float mx = fmaxf(m, mo);
    const float x = expf(m - mx), y = expf(mo - mx);
    l = l * x + lo * y;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float ao = __shfl_xor_sync(kFull, acc[i], off);
      acc[i] = acc[i] * x + ao * y;
    }
    m = mx;
  }
  // then the warps, through shared memory: [warp][HD + 2]
  __syncthreads();  // every warp is done with the staged codes
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp * (HD + 2) + j * 16 + i] = acc[i];
    if (j == 0) {
      red[warp * (HD + 2) + HD] = m;
      red[warp * (HD + 2) + HD + 1] = l;
    }
  }
  __syncthreads();
  const size_t at = (((size_t)slot * a.splits + split) * a.K + kh) * a.G + g;
  const size_t units = (size_t)a.R * a.splits * a.K * a.G;
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < 4; ++w) mx = fmaxf(mx, red[w * (HD + 2) + HD]);
  for (int d = tid; d < HD; d += kTcThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      v += red[w * (HD + 2) + d] * expf(red[w * (HD + 2) + HD] - mx);
    a.part[at * HD + d] = v;
  }
  if (tid == 0) {
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      lsum += red[w * (HD + 2) + HD + 1] * expf(red[w * (HD + 2) + HD] - mx);
    a.part[units * HD + 2 * at] = mx;
    a.part[units * HD + 2 * at + 1] = lsum;
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
tc_varlen_kernel(const __grid_constant__ VarlenArgs a) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  if ((int)blockIdx.x < a.prefill_units)
    prefill_unit<HD>(a, blockIdx.x, blockIdx.y, tc_smem);
  else
    decode_unit<HD>(a, blockIdx.x - a.prefill_units, blockIdx.y, tc_smem);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
varlen_combine_kernel(const __grid_constant__ VarlenArgs a) {
  const int slot = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int* order = a.rows;
  const int* first = a.rows + a.T;
  const int* count = first + a.R + 1;
  if (slot == a.R) {  // the pads: exact zeros
    const int n = count[slot] * a.G * HD;
    for (int e = tid; e < n; e += kTcThreads) {
      const int row = order[first[slot] + e / (a.G * HD)];
      a.out[kh * a.o_sk + row * a.o_st + e % (a.G * HD)] = 0.f;
    }
    return;
  }
  if (count[slot] != 1) return;
  const int row = order[first[slot]];
  const int n_hist = min(a.start[slot], a.nb * a.page);
  const int n_split = max(1, (n_hist + Tc<HD>::SPLIT - 1) / Tc<HD>::SPLIT);
  const size_t units = (size_t)a.R * a.splits * a.K * a.G;
  for (int e = tid; e < a.G * HD; e += kTcThreads) {
    const int g = e / HD, d = e % HD;
    float mx = kNegInf;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t at = (((size_t)slot * a.splits + sp) * a.K + kh) * a.G + g;
      mx = fmaxf(mx, a.part[units * HD + 2 * at]);
    }
    float lsum = 0.f, v = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t at = (((size_t)slot * a.splits + sp) * a.K + kh) * a.G + g;
      const float w = expf(a.part[units * HD + 2 * at] - mx);
      lsum += a.part[units * HD + 2 * at + 1] * w;
      v += a.part[at * HD + d] * w;
    }
    // no valid key in the whole row: exact zeros
    a.out[kh * a.o_sk + row * a.o_st + e] =
        mx > 0.5f * kNegInf ? v / fmaxf(lsum, 1e-30f) : 0.f;
  }
}

template <int HD>
cudaError_t launch_tc(const VarlenArgs& a, cudaStream_t st) {
  constexpr int bytes = Tc<HD>::SMEM;
  static bool opted[kMaxDevices] = {};
  cudaError_t e = smem_opt_in(tc_varlen_kernel<HD>, bytes, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.prefill_units + a.R * a.splits * a.G, a.K);
  tc_varlen_kernel<HD><<<grid, kTcThreads, bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  varlen_combine_kernel<HD><<<dim3(a.R + 1, a.K), kTcThreads, 0, st>>>(a);
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

// The tensor-core route: bf16 q and fresh k/v, T <= 32768, hd 32, 64, 128
// or 256, 16-byte aligned q, codes and fresh k/v with strides of multiples
// of 8 elements; ``rows`` the work list (T + 2 * (R + 1) int32, see
// ``segment_rows``); ``part`` a workspace of R * splits * K * G * (hd + 2)
// f32, splits = ceil(nb * page / the decode split of hd). Launches
// tc_varlen_kernel and varlen_combine_kernel on `stream`.
extern "C" int varlen_attention_tc_launch(
    const void* q, float scale, long long q_sk, long long q_st,
    const void* k_codes, const void* k_scale, const void* v_codes,
    const void* v_scale, const void* pool_pos, const void* block_table,
    const void* q_pos, const void* start, const void* rows,
    const void* k_fresh, const void* v_fresh, long long f_sk, long long f_st,
    void* out, long long o_sk, long long o_st, void* part, int T, int K,
    int G, int HD, int page, int nb, int R, int splits, void* stream) {
  if (T < 1 || K < 1 || G < 1 || nb < 1 || R < 1 || page < 1 ||
      page > 64 || K > 65535 || T > kTcMaxT || splits < 1 ||
      (long long)T * G / kTcRows + R + (long long)R * splits * G >
          2147483647LL ||
      ((uintptr_t)q | (uintptr_t)k_codes | (uintptr_t)v_codes |
       (uintptr_t)k_fresh | (uintptr_t)v_fresh) % 16 ||
      (q_sk | q_st | f_sk | f_st) % 8 || (o_sk | o_st) % 2)
    return (int)cudaErrorInvalidValue;
  const VarlenArgs a{static_cast<const __nv_bfloat16*>(q), scale, q_sk, q_st,
                     static_cast<const int8_t*>(k_codes),
                     static_cast<const float*>(k_scale),
                     static_cast<const int8_t*>(v_codes),
                     static_cast<const float*>(v_scale),
                     static_cast<const int32_t*>(pool_pos),
                     static_cast<const int32_t*>(block_table),
                     static_cast<const int32_t*>(q_pos),
                     static_cast<const int32_t*>(start),
                     static_cast<const int32_t*>(rows),
                     static_cast<const __nv_bfloat16*>(k_fresh),
                     static_cast<const __nv_bfloat16*>(v_fresh), f_sk, f_st,
                     static_cast<float*>(out), o_sk, o_st,
                     static_cast<float*>(part), T, K, G, page, nb, R,
                     (T * G + kTcRows - 1) / kTcRows + R, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fits = [&](int split) {  // the splits cover every history slot
    return (long long)splits * split >= (long long)nb * page;
  };
  switch (HD) {
    case 32:
      return fits(Tc<32>::SPLIT) ? (int)launch_tc<32>(a, st)
                                 : (int)cudaErrorInvalidValue;
    case 64:
      return fits(Tc<64>::SPLIT) ? (int)launch_tc<64>(a, st)
                                 : (int)cudaErrorInvalidValue;
    case 128:
      return fits(Tc<128>::SPLIT) ? (int)launch_tc<128>(a, st)
                                  : (int)cudaErrorInvalidValue;
    case 256:
      return fits(Tc<256>::SPLIT) ? (int)launch_tc<256>(a, st)
                                  : (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}
