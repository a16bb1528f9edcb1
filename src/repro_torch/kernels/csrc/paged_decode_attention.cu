// Decode attention over the paged int8 KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention, pallas_call at line 121). Python wrapper, launch
// count, split plan and plain PyTorch version:
// repro_torch/kernels/paged_decode_attention.py.
//
//   q            (R, K, G, hd)     f32 or bf16
//   k/v_codes    (P, K, page, hd)  int8     k/v_scale (P, K, page) f32
//   pool_pos     (P, page)         int32    (-1 = empty slot)
//   block_table  (R, nb)           int32    (unused entries: trash page 0)
//   q_pos        (R,)              int32    per-row causal bound
//   out          (R, K, G, hd)     f32
//
// Semantics kept from the TPU kernel: the score is q.k/sqrt(hd) in f32; a
// key is attended when 0 <= pos <= q_pos[r]; a row with no valid key gives
// exact zeros (the TPU kernel's `seen` guard). Masking is by select, never
// by arithmetic: a masked key's codes may be garbage (the trash page), so
// it takes no part in the softmax at all.
//
// Page b of a row holds positions [b*page, (b+1)*page), so the walk covers
// only the row's pages 0 .. q_pos / page (the TPU kernel walks all nb
// entries; the rest hold masked slots only), and a row with q_pos < 0
// writes zeros.
//
// Bound: one call reads the codes and scales of the pages its rows need,
// K*page*(2*hd + 8) bytes per page plus its positions, against 4*K*G*hd
// flops per key, so at small G it is bound by device-memory bytes.
//
// Two kernels; the wrapper's route() picks one from shapes alone.
//
// paged_decode_attention_kernel (a table that fits one split): one block a
// (kv-head, row, group of GC query heads) walks the row's pages in one
// pass, in steps of a block's keys, straight from the pool; each lane group
// keeps its own online softmax, merged by shuffles and through shared
// memory. With nothing staged it is the faster design for short rows.
//
// paged_split_kernel (flash-decoding, K4's decode units with K2's head
// groups): a long row is split over blocks. A unit is one row, one split
// of Split<HD>::KEYS logical slots (256, 128 at hd 256) and one kv-head
// with a group of up to GC of its query heads, so the pages are read once
// a group. The grid, (K * ceil(G / GC), R, splits) with splits = ceil(nb *
// page / KEYS), depends on shapes only (no host read-back: a call is
// graph-capturable). A row that needs one split or none is walked by its
// first unit in one pass, as by the single-pass kernel; a unit whose split
// starts past the row's last needed page exits at once. A unit of a longer
// row puts its split's codes, scales and positions in shared memory by
// cp.async, all in flight at once. Lane groups of hd/16 lanes then take
// KEYS / (keys a block step) keys each: first their scores, then one max,
// then the values weighted by 2^(score - max): no rescaling inside a
// split. The lane groups merge by shuffles across the warp and through
// shared memory across warps in warp order. Each unit writes its (max,
// sum, weighted values) to a workspace and takes a ticket for its (row,
// kv-head, group), and the unit that takes the last merges the row's
// splits in split order (a run repeats its bits; no float atomics), writes
// exact zeros where no split saw a valid key, and resets the ticket for
// the next call (or a graph's next replay).
//
// Both: a softmax in f32 and base 2 (the query pre-scaled by
// log2(e)/sqrt(hd), each score times k_scale); codes widen to f32 by a
// byte permute and one FADD.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 16;  // int8 codes per lane per key: one 16-byte chunk
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Split {
  static constexpr int KEYS = HD == 256 ? 128 : 256;  // logical slots a unit
  // a split's k and v codes, k and v scales, positions
  static constexpr int STAGE = KEYS * (2 * HD + 12);
};

template <int HD, int GC>
constexpr int smem_bytes() {
  // the staged split, reused after the walk for the warps' merge
  constexpr int merge = kWarps * GC * (HD + 2) * 4;
  return Split<HD>::STAGE > merge ? Split<HD>::STAGE : merge;
}

// logical slots row r walks: whole pages 0 .. q_pos / page, within the table
__device__ __forceinline__ int row_slots(int qp, int page, int nb) {
  return qp < 0 ? 0 : min(qp / page + 1, nb) * page;
}

struct Args {
  const void* q;
  int q_bf16;
  float scale;
  const int8_t* k_codes;
  const float* k_scale;
  const int8_t* v_codes;
  const float* v_scale;
  const int32_t* pool_pos;
  const int32_t* block_table;
  const int32_t* q_pos;
  float* out;
  float* part;  // (R, splits, K, G) x (hd values), then (max, sum) pairs
  int* tickets;  // (R, K, head groups), zero between calls
  int R, K, G, page, nb, splits;
};

// A row's exact zeros (no valid key: a free slot) for the GC query rows
// from g0 of kv-head kh.
template <int HD, int GC>
__device__ __forceinline__ void write_zeros(const Args& a, size_t rk,
                                            int g0) {
  for (int idx = threadIdx.x; idx < GC * HD; idx += kThreads) {
    const int g = idx / HD;
    if (g0 + g < a.G) a.out[(rk * a.G + g0 + g) * HD + idx % HD] = 0.f;
  }
}

// One block walks a row's n_slots (> 0) logical slots in one pass, in
// steps of a block's keys straight from the pool: slot t lives at page
// block_table[r][t / page], offset t % page; a key's hd codes are split
// over LPS = hd/16 lanes (one 16-byte load each); each lane group keeps
// its own online-softmax state (m, l) per query row and acc for its
// 16-dim slice (base 2: the query is pre-scaled by log2(e)/sqrt(hd)); the
// groups merge with shuffles across the warp, then through ``red``
// ([warp][g][HD + 2] f32) across warps. With nothing to stage it is the
// faster design for a row of one split.
template <int HD, int GC>
__device__ __forceinline__ void single_pass(const Args& a, int kh, int r,
                                            int g0, int n_slots, int qp,
                                            float* red) {
  constexpr int LPS = HD / kVec;     // lanes a key
  constexpr int SPW = 32 / LPS;      // keys a warp a step
  constexpr int SPB = kWarps * SPW;  // keys a block a step
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, j = lane % LPS;
  const size_t rk = (size_t)r * a.K + kh;

  float qv[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const size_t row = (rk * a.G + g0 + g) * HD + j * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float x = 0.f;
      if (g0 + g < a.G)
        x = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                           a.q)[row + i])
                     : reinterpret_cast<const float*>(a.q)[row + i];
      qv[g][i] = x * a.scale;
    }
  }

  float m[GC], l[GC], acc[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  const int32_t* bt = a.block_table + (size_t)r * a.nb;
  // a step's key of this lane group: its codes, scales and position (an
  // absent key: zeros and -1, no load)
  struct Key {
    int4 k, v;
    float ks, vs;
    int p;
  };
  auto fetch = [&](int t) {
    Key key{make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0), 0.f, 0.f, -1};
    if (t < n_slots) {
      const int b = t / a.page, off = t - b * a.page;
      const size_t phys = (size_t)bt[b];
      const size_t slot = (phys * a.K + kh) * a.page + off;
      key.k = *reinterpret_cast<const int4*>(a.k_codes + slot * HD + j * kVec);
      key.v = *reinterpret_cast<const int4*>(a.v_codes + slot * HD + j * kVec);
      key.ks = a.k_scale[slot];
      key.vs = a.v_scale[slot];
      key.p = a.pool_pos[phys * a.page + off];
    }
    return key;
  };
  // every lane runs every step, so the shuffles below always see the full
  // warp; a lane whose key is absent or masked skips the softmax update.
  // The next step's loads are issued before the math on this one's.
  Key cur = fetch(warp * SPW + sub);
  for (int base = 0; base < n_slots; base += SPB) {
    const Key nxt = fetch(base + SPB + warp * SPW + sub);
    float kf[kVec], vf[kVec];
    widen16(cur.k, kf);
    widen16(cur.v, vf);
    const bool valid = cur.p >= 0 && cur.p <= qp;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv[g][i], kf[i], dot);
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (valid) {
        const float s = dot * cur.ks;
        const float m_new = fmaxf(m[g], s);
        const float corr = exp2f(m[g] - m_new);
        const float pr = exp2f(s - m_new);
        l[g] = l[g] * corr + pr;
        const float pv = pr * cur.vs;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][i] = fmaf(pv, vf[i], acc[g][i] * corr);
        m[g] = m_new;
      }
    }
    cur = nxt;
  }

  // merge the lane groups of this warp (same j, different keys); a group
  // that saw no valid key has m = -1e30, l = 0, acc = 0 and weighs nothing
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float x = exp2f(m[g] - mx), y = exp2f(mo - mx);
      l[g] = l[g] * x + lo * y;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * x + ao * y;
      }
      m[g] = mx;
    }
  }

  // then the warps, in warp order through shared memory
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float* w = red + (warp * GC + g) * (HD + 2);
#pragma unroll
      for (int i = 0; i < kVec; ++i) w[j * kVec + i] = acc[g][i];
      if (j == 0) {
        w[HD] = m[g];
        w[HD + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GC * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    if (g0 + g >= a.G) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, red[(w * GC + g) * (HD + 2) + HD]);
    float lsum = 0.f, v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wr = red + (w * GC + g) * (HD + 2);
      const float e = exp2f(wr[HD] - mx);
      lsum += wr[HD + 1] * e;
      v += wr[d] * e;
    }
    // no valid key in the whole row: exact zeros
    a.out[(rk * a.G + g0 + g) * HD + d] =
        mx > 0.5f * kNegInf ? v / fmaxf(lsum, 1e-30f) : 0.f;
  }
}

// The single-pass kernel: one block a (kv-head, row, group of GC query
// heads) walks the row's whole pages. It takes a call whose table fits
// one split (the wrapper's route()): there it needs no workspace, and
// with no staged split it keeps eight blocks an SM where the split kernel
// keeps three.
template <int HD, int GC>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const __grid_constant__ Args a) {
  __shared__ float red[kWarps * GC * (HD + 2)];
  const int kh = blockIdx.x, r = blockIdx.y, g0 = blockIdx.z * GC;
  const int qp = a.q_pos[r];
  const int n_slots = row_slots(qp, a.page, a.nb);
  if (n_slots == 0)
    write_zeros<HD, GC>(a, (size_t)r * a.K + kh, g0);
  else
    single_pass<HD, GC>(a, kh, r, g0, n_slots, qp, red);
}

// The registers of the split kernel are held to what its resident blocks
// can have: three a unit of one head fit the staged split's shared memory
// (the one-pass walk's loads of a step ahead would take more registers and
// cost one); two or one a group of two or four heads.
template <int HD, int GC>
__global__ void __launch_bounds__(kThreads, GC == 1 ? 3 : (GC == 2 ? 2 : 1))
paged_split_kernel(const __grid_constant__ Args a) {
  using S = Split<HD>;
  constexpr int LPS = HD / kVec;     // lanes a key
  constexpr int SPW = 32 / LPS;      // keys a warp a step
  constexpr int SPB = kWarps * SPW;  // keys a block a step
  constexpr int KPL = S::KEYS / SPB;  // keys a lane group
  static_assert(KPL >= 1 && KPL * SPB == S::KEYS, "a split is whole steps");
  extern __shared__ __align__(128) int8_t smem[];

  const int groups = (a.G + GC - 1) / GC;
  const int kh = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int g0 = grp * GC, r = blockIdx.y;
  const int splits = gridDim.z, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPS, j = lane % LPS;
  const size_t rk = (size_t)r * a.K + kh;
  const int k0 = split * S::KEYS;

  // the split's page ids, read beside the row's bound (the split starts on
  // a page boundary when page divides KEYS; else it holds part of one
  // more page); entries past the row's pages are read and not used
  __shared__ int pages[S::KEYS + 1];
  const int b0 = k0 / a.page;
  const int nbk = min(a.nb, (k0 + S::KEYS - 1) / a.page + 1) - b0;
  for (int i = tid; i < nbk; i += kThreads)
    pages[i] = a.block_table[(size_t)r * a.nb + b0 + i];
  const int qp = a.q_pos[r];
  const int n_slots = row_slots(qp, a.page, a.nb);
  if (n_slots <= S::KEYS) {
    // a row of one split (or none: a free slot, exact zeros) is its first
    // unit's, walked in one pass with nothing staged
    if (split > 0) return;
    if (n_slots == 0)
      write_zeros<HD, GC>(a, rk, g0);
    else
      single_pass<HD, GC>(a, kh, r, g0, n_slots, qp,
                          reinterpret_cast<float*>(smem));
    return;
  }
  if (k0 >= n_slots) return;  // past the row's pages
  const int n_split = (n_slots + S::KEYS - 1) / S::KEYS;
  const int n = min(n_slots, k0 + S::KEYS) - k0;

  int8_t* kc = smem;  // [KEYS][HD]
  int8_t* vc = kc + S::KEYS * HD;
  float* ksc = reinterpret_cast<float*>(vc + S::KEYS * HD);  // [KEYS]
  float* vsc = ksc + S::KEYS;
  int* kps = reinterpret_cast<int*>(vsc + S::KEYS);

  __syncthreads();  // the page ids are in

  // the split's codes, scales and positions, all in flight at once; keys
  // of one page are consecutive in the pool
  for (int e = tid; e < n * LPS; e += kThreads) {
    const int jj = e / LPS, c = e % LPS, t = k0 + jj, b = t / a.page;
    const size_t sl =
        ((size_t)pages[b - b0] * a.K + kh) * a.page + (t - b * a.page);
    cp_async16(smem_u32(kc + jj * HD + c * kVec),
               a.k_codes + sl * HD + c * kVec);
    cp_async16(smem_u32(vc + jj * HD + c * kVec),
               a.v_codes + sl * HD + c * kVec);
  }
  for (int jj = tid; jj < n; jj += kThreads) {
    const int t = k0 + jj, b = t / a.page, off = t - b * a.page;
    const size_t phys = (size_t)pages[b - b0];
    const size_t sl = (phys * a.K + kh) * a.page + off;
    cp_async4(smem_u32(ksc + jj), a.k_scale + sl);
    cp_async4(smem_u32(vsc + jj), a.v_scale + sl);
    cp_async4(smem_u32(kps + jj), a.pool_pos + phys * a.page + off);
  }

  // this lane's 16-dim slice of each query row, pre-scaled by
  // log2(e)/sqrt(hd): the softmax runs in base 2
  float qv[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const size_t row = (rk * a.G + g0 + g) * HD + j * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float x = 0.f;
      if (g0 + g < a.G)
        x = a.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                           a.q)[row + i])
                     : reinterpret_cast<const float*>(a.q)[row + i];
      qv[g][i] = x * a.scale;
    }
  }
  cp_async_commit_wait();
  __syncthreads();

  // the lane group's keys: t * SPB + warp * SPW + sub. First their scores
  // and one max (every lane runs every key, so the shuffles see the full
  // warp; an absent or masked key is left out by select)
  float sc[GC][KPL], m[GC];
  unsigned valid = 0;
#pragma unroll
  for (int g = 0; g < GC; ++g) m[g] = kNegInf;
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    if (t * SPB >= n) break;  // the same for every lane of the block
    const int key = t * SPB + warp * SPW + sub;
    const int kk = key < n ? key : 0;
    float kf[kVec];
    widen16(*reinterpret_cast<const int4*>(kc + kk * HD + j * kVec), kf);
    const int p = key < n ? kps[kk] : -1;
    if (p >= 0 && p <= qp) valid |= 1u << t;
    const float ks = ksc[kk];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv[g][i], kf[i], dot);
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      sc[g][t] = dot * ks;
      if (valid >> t & 1) m[g] = fmaxf(m[g], sc[g][t]);
    }
  }
  // then the values, weighted by 2^(score - max)
  float l[GC], acc[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    if (!(valid >> t & 1)) continue;
    const int key = t * SPB + warp * SPW + sub;
    float vf[kVec];
    widen16(*reinterpret_cast<const int4*>(vc + key * HD + j * kVec), vf);
    const float vs = vsc[key];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float pr = exp2f(sc[g][t] - m[g]);
      l[g] += pr;
      const float pv = pr * vs;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
    }
  }

  // merge the lane groups of this warp (same j, different keys); a group
  // that saw no valid key has m = -1e30, l = 0, acc = 0 and weighs nothing
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float x = exp2f(m[g] - mx), y = exp2f(mo - mx);
      l[g] = l[g] * x + lo * y;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * x + ao * y;
      }
      m[g] = mx;
    }
  }

  // then the warps, in warp order through shared memory: [warp][g][HD + 2]
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the staged codes
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float* w = red + (warp * GC + g) * (HD + 2);
#pragma unroll
      for (int i = 0; i < kVec; ++i) w[j * kVec + i] = acc[g][i];
      if (j == 0) {
        w[HD] = m[g];
        w[HD + 1] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t units = (size_t)a.R * splits * a.K * a.G;
  for (int idx = tid; idx < GC * (HD + 1); idx += kThreads) {
    const int g = idx / (HD + 1), d = idx % (HD + 1);  // d == HD: the sum
    if (g0 + g >= a.G) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, red[(w * GC + g) * (HD + 2) + HD]);
    float v = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wr = red + (w * GC + g) * (HD + 2);
      const float e = exp2f(wr[HD] - mx);
      v += wr[d == HD ? HD + 1 : d] * e;
      lsum += wr[HD + 1] * e;
    }
    const size_t at =
        (((size_t)r * splits + split) * a.K + kh) * a.G + g0 + g;
    if (d < HD) {
      a.part[at * HD + d] = v;
    } else {
      a.part[units * HD + 2 * at] = mx;
      a.part[units * HD + 2 * at + 1] = v;
    }
  }
  // the unit that takes the row's last ticket merges its splits in order
  __shared__ int last;
  __threadfence();  // this unit's part is visible before its ticket
  __syncthreads();
  int* ticket = a.tickets + ((size_t)r * a.K + kh) * groups + grp;
  if (tid == 0) last = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = tid; idx < GC * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    if (g0 + g >= a.G) continue;
    const size_t at0 = ((size_t)r * splits * a.K + kh) * a.G + g0 + g;
    const size_t step = (size_t)a.K * a.G;  // from one split to the next
    float mx = kNegInf;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, __ldcg(a.part + units * HD + 2 * (at0 + sp * step)));
    float lsum = 0.f, v = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t at = at0 + sp * step;
      const float w = exp2f(__ldcg(a.part + units * HD + 2 * at) - mx);
      lsum += __ldcg(a.part + units * HD + 2 * at + 1) * w;
      v += __ldcg(a.part + at * HD + d) * w;
    }
    // no valid key in the whole row: exact zeros
    a.out[(rk * a.G + g0 + g) * HD + d] =
        mx > 0.5f * kNegInf ? v / fmaxf(lsum, 1e-30f) : 0.f;
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

template <int HD, int GC>
cudaError_t launch(const Args& a, bool single, cudaStream_t st) {
  if (single) {
    paged_decode_attention_kernel<HD, GC>
        <<<dim3(a.K, a.R, (a.G + GC - 1) / GC), kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  constexpr int bytes = smem_bytes<HD, GC>();
  static bool opted[kMaxDevices] = {};
  cudaError_t e = smem_opt_in(paged_split_kernel<HD, GC>, bytes, opted);
  if (e != cudaSuccess) return e;
  // kv-heads vary fastest: the units of a page's heads, which read one
  // contiguous stretch of the pool, run side by side
  const long long x = (long long)a.K * ((a.G + GC - 1) / GC);
  if (x > 2147483647LL) return cudaErrorInvalidValue;
  paged_split_kernel<HD, GC>
      <<<dim3((unsigned)x, a.R, a.splits), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// GC query rows a unit: 1 and 2 fit exactly, larger groups go 4 at a time
template <int HD>
cudaError_t launch_hd(const Args& a, bool single, cudaStream_t st) {
  if (!single && ((long long)a.nb * a.page >
                      (long long)a.splits * Split<HD>::KEYS ||
                  (long long)a.nb * a.page <=
                      (long long)(a.splits - 1) * Split<HD>::KEYS))
    return cudaErrorInvalidValue;  // not the plan's split count
  if (a.G == 1) return launch<HD, 1>(a, single, st);
  if (a.G == 2) return launch<HD, 2>(a, single, st);
  return launch<HD, 4>(a, single, st);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernels do not take. ``single``
// launches the single-pass kernel (``splits``, ``part`` and ``tickets``
// unused), else the split kernel: ``splits`` is ceil(nb * page / the split
// of hd) (256 keys, 128 at hd 256); with more than one, ``part`` is a
// workspace of R * splits * K * G * (hd + 2) f32 and ``tickets`` R * K *
// ceil(G / group) int32, zero before the call (the kernel leaves them at
// zero; group is G for G <= 2, else 4).
extern "C" int paged_decode_attention_launch(
    const void* q, int q_bf16, float scale, const void* k_codes,
    const void* k_scale, const void* v_codes, const void* v_scale,
    const void* pool_pos, const void* block_table, const void* q_pos,
    void* out, void* part, void* tickets, int R, int K, int G, int HD,
    int page, int nb, int splits, int single, void* stream) {
  if (R < 1 || K < 1 || G < 1 || nb < 1 || page < 1 || page > 64 ||
      R > 65535 || G > 4 * 65535 ||
      (!single && (splits < 1 || splits > 65535 ||
                   (splits > 1 && (part == nullptr || tickets == nullptr)))) ||
      ((uintptr_t)k_codes | (uintptr_t)v_codes) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{q, q_bf16, scale,
               static_cast<const int8_t*>(k_codes),
               static_cast<const float*>(k_scale),
               static_cast<const int8_t*>(v_codes),
               static_cast<const float*>(v_scale),
               static_cast<const int32_t*>(pool_pos),
               static_cast<const int32_t*>(block_table),
               static_cast<const int32_t*>(q_pos), static_cast<float*>(out),
               static_cast<float*>(part), static_cast<int*>(tickets), R, K, G,
               page, nb, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32: return (int)launch_hd<32>(a, single, st);
    case 64: return (int)launch_hd<64>(a, single, st);
    case 128: return (int)launch_hd<128>(a, single, st);
    case 256: return (int)launch_hd<256>(a, single, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
