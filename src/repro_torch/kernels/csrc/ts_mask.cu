// Threshold splitting's whole encode (TS, paper Eq. 4, with the reference's
// fixed-capacity carrier) for Hopper (sm_90a), in one launch a payload.
//
// Replaces the Pallas TPU kernel repro/kernels/ts_mask.py (ts_mask,
// pallas_call at line 32), which computes the dense scan only, and the
// top-capacity selection that the reference (repro/core/ts.py::ts_encode)
// runs around it. Python wrapper, launch count and plain PyTorch version:
// repro_torch/kernels/ts_mask.py.
//
//   x        (N,) = (T, D) flat   f32 or bf16, compared as f32 against tau
//   below    (N,)  f32    x, with +0 at every entry kept in the carrier
//   values   (C,)  f32    the carrier: x at the kept entries, else 0
//   indices  (C,)  int64  their flat indices, else -1
//   count    ()    int32  entries with |x| >= tau, uncapped
//
// The contract (that of the plain version, torch.sort stable and
// descending over |x|, the top C taken):
//  * entries rank by (|x| descending, flat index ascending); NaN ranks
//    above every magnitude, NaNs among themselves by index;
//  * a candidate is an entry with |x| >= tau, or a NaN. The carrier is the
//    top min(candidates, C) candidates in rank order, then (-1, 0) slots;
//    a NaN takes its slot as (-1, 0) and stays in below, as do candidates
//    past the capacity. Only entries below tau can follow the candidates in
//    the plain version's top C, and those are (-1, 0) slots there too.
// One 64-bit key gives that order as plain unsigned order: the bits of |x|
// (NaN made canonical, 0x7FC00000, above +inf) over the complement of the
// flat index, shifted left one bit for x's sign. Keys are unique (and never
// 0), so "kept" is "key >= the C-th largest key", and a key gives back x
// and its index without a read of x.
//
// Design (one route at every T, D and C):
//  1. Each block reads its tile of kTile entries once and writes x into
//     below. It appends its candidates' keys to a workspace (one atomic a
//     block for the place, on the low half of a 64-bit state word), keeps
//     those that fall within the first kCache places in shared memory,
//     adds its NaNs and the OR of its keys and of their complements to
//     three more state words (atomics whose return no one awaits), and
//     takes a ticket (the high half of the first). The state comes from
//     kernels/tickets.py (per device and stream, or the captured call's
//     own) and is zero between calls.
//  2. The block that takes the last ticket (whose return also gives the
//     number of candidates) copies the other blocks' candidates into its
//     shared memory, as far as kCache. S, the keys in play, starts as every
//     candidate; while S holds more than max(C, kChunk) keys, a radix pass
//     narrows it: 8 bits a pass, from the top, over only the bits that
//     differ between keys (bf16-origin data leave most of the 64
//     unvarying), to the keys above the bin that holds the C-th key and
//     that bin. A pass is a histogram (kCopies copies, so fewer atomics
//     hit one address; the copy makes the first pass's) and one warp's
//     scan of it.
//  3. Unless S is every candidate and fits a chunk (then it is in the
//     cache already), S is placed by a block-wide scan: the first kChunk in
//     shared memory, the rest in the workspace. It is sorted a chunk of
//     kChunk = kThreads at a time, a key a thread: each warp sorts its 32
//     (bitonic, by shuffles), then runs merge pairwise, a key's place being
//     its own in its run plus, by binary search, the keys above it in the
//     other run (a chunk is padded with 0 to a power of two; a pad's place
//     needs no search). A key's rank is its place in its chunk plus the
//     keys above it in the other chunks. The top C go to the carrier, with
//     0 at their entries of below; the state goes back to zero.
// The tail's work grows with the number of candidates (a count near N is
// right, and slow: the candidates past kCache are read from the workspace
// in every pass), not with N. At T = 1 the grid is one block, which takes
// its own ticket and finds its candidates in its own shared memory.
//
// Bound: x read once, below written once, the carrier written once:
// device-memory bytes (a few operations a value). At a decode payload the
// launch, the ticket protocol's two round trips to L2 and the tail's chain
// of dependent steps set its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// the keys' type: the one __ldcg, atomicAdd and the shuffles take
using u64 = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;  // entries a block
constexpr int kPer = kTile / kThreads;
constexpr int kCache = 22528;  // candidates the last block holds in smem
constexpr int kChunk = kThreads;  // keys of S sorted at once
// the cache, S's first (or last) chunk, and the merges' two buffers
constexpr int kSmem = (kCache + 3 * kChunk) * 8;
constexpr int kBins = 256;  // a radix pass's digit: 8 bits
constexpr int kCopies = 8;
constexpr uint32_t kNanKey = 0x7FC00000u;
constexpr unsigned kFull = 0xffffffffu;
// flat indices (31 bits of a key) and loop counters are int32
constexpr long long kMaxN = 0x7fffffffLL - kTile;

__device__ __forceinline__ float load_x(const void* x, int bf16, int i) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(x)[i])
              : reinterpret_cast<const float*>(x)[i];
}

__device__ __forceinline__ u64 make_key(float v, uint32_t i) {
  const float a = fabsf(v);
  const uint32_t mag = isnan(a) ? kNanKey : __float_as_uint(a);
  return (u64)mag << 32 | (~i << 1) | (__float_as_uint(v) >> 31);
}

__device__ __forceinline__ uint32_t key_index(u64 key) {
  return ~(static_cast<uint32_t>(key) >> 1) & 0x7fffffffu;
}

__device__ __forceinline__ float key_value(u64 key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32) |
                         static_cast<uint32_t>(key) << 31);
}

__device__ __forceinline__ bool is_nan_key(u64 key) {
  return static_cast<uint32_t>(key >> 32) == kNanKey;
}

// the keys of a run (sorted descending) above ``key``, or with ``ties``
// at least ``key``
__device__ __forceinline__ int keys_above(const u64* run, int len, u64 key,
                                          bool ties = false) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const u64 r = run[mid];
    if (r > key || (ties && r == key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ u64 or64(u64 v) {  // over the warp
  return (u64)__reduce_or_sync(kFull, static_cast<unsigned>(v >> 32)) << 32 |
         __reduce_or_sync(kFull, static_cast<unsigned>(v));
}

__device__ __forceinline__ int warp_scan(int v) {  // inclusive
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// the sum of ``v`` over the threads before this one; ``total`` gets the
// block's. Two barriers; the caller puts a third between this and the
// next write to s_scan (kWarps + 1 ints).
__device__ __forceinline__ int block_scan(int v, int* s_scan, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_scan(v);
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_scan[lane] : 0, wi = warp_scan(w);
    if (lane < kWarps) s_scan[lane] = wi - w;
    if (lane == 31) s_scan[kWarps] = wi;
  }
  __syncthreads();
  total = s_scan[kWarps];
  return s_scan[warp] + incl - v;
}

__global__ void __launch_bounds__(kThreads, 1)
ts_encode_kernel(const void* __restrict__ x, int x_bf16, float tau, int n,
                 int cap, float* __restrict__ below,
                 float* __restrict__ values, int64_t* __restrict__ indices,
                 int32_t* __restrict__ count, u64* state, u64* cand,
                 u64* kept) {
  extern __shared__ u64 smem[];
  u64* s_cache = smem;           // candidate p, for p < kCache
  u64* s_sort = smem + kCache;   // S's first chunk, then its last sorted
  u64* s_merge = s_sort + kChunk;  // the merges' two buffers
  // a radix pass's histogram and the next one's, kCopies of each (a warp
  // adds to copy warp % kCopies: fewer atomics on one address)
  __shared__ int s_hist[2][kCopies][kBins];
  __shared__ int s_scan[kWarps + 1];
  __shared__ u64 s_or[kWarps], s_not_and[kWarps];  // warps' key bits
  __shared__ int s_sel[2][3];  // a pass's bin, keys above it, keys in it
  __shared__ int s_base, s_own, s_last, s_cands;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the state: tickets over candidates, the NaNs, the OR of the keys and
  // the OR of their complements
  unsigned* n_nan = reinterpret_cast<unsigned*>(state + 1);
  u64* or_all = state + 2;
  u64* not_and_all = state + 3;

  // ---- 1. the tile: below and the candidates' keys
  const int first = blockIdx.x * kTile;
  float v[kPer];  // all loads in flight before the first store
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = first + j * kThreads + tid;
    v[j] = i < n ? load_x(x, x_bf16, i) : 0.f;
  }
  // the first radix pass's histogram: the last block fills it as it
  // copies the candidates
  for (int b = tid; b < kCopies * kBins; b += kThreads)
    (&s_hist[0][0][0])[b] = 0;
  u64 key[kPer], k_or = 0, k_not_and = 0;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = first + j * kThreads + tid;
    key[j] = 0;
    if (i < n) {
      const float a = fabsf(v[j]);
      below[i] = v[j];  // the last block zeroes the kept entries
      if (isnan(a) || a >= tau) {
        key[j] = make_key(v[j], i);
        ++mine;
        k_or |= key[j];
        k_not_and |= ~key[j];
        if (isnan(a)) atomicAdd(n_nan, 1u);  // rare; no return awaited
      }
    }
  }
  const int incl = warp_scan(mine);
  if (lane == 31) s_scan[warp] = incl;
  k_or = or64(k_or);
  k_not_and = or64(k_not_and);
  if (lane == 0) {
    s_or[warp] = k_or;
    s_not_and[warp] = k_not_and;
  }
  __syncthreads();
  if (warp == 0) {  // the warps' places, and the block's in the workspace
    const int w = lane < kWarps ? s_scan[lane] : 0, wi = warp_scan(w);
    if (lane < kWarps) s_scan[lane] = wi - w;
    if (lane == 31) {
      s_own = wi;
      s_base = wi ? (int)atomicAdd(state, (u64)wi) : 0;
    }
    // the bits that differ between the keys, across blocks
    k_or = or64(lane < kWarps ? s_or[lane] : 0);
    k_not_and = or64(lane < kWarps ? s_not_and[lane] : 0);
    if (lane == 31 && wi) {  // no return awaited
      atomicOr(or_all, k_or);
      atomicOr(not_and_all, k_not_and);
    }
  }
  __syncthreads();
  int p = s_base + s_scan[warp] + incl - mine;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (key[j]) {
      cand[p] = key[j];
      if (p < kCache) s_cache[p] = key[j];
      ++p;
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const u64 old = atomicAdd(state, 1ull << 32);
    s_last = (uint32_t)(old >> 32) == gridDim.x - 1;
    s_cands = (int)(uint32_t)old;  // every block has appended
  }
  __syncthreads();
  if (!s_last) return;

  // ---- 2. the last block: the other blocks' candidates into shared
  // memory (its own are there), as far as kCache; where the select runs,
  // its first pass's histogram on the way
  const int n_cand = s_cands, own0 = s_base, own1 = s_base + s_own;
  const int k = min(cap, n_cand);
  const bool select = n_cand > max(k, kChunk);
  const unsigned nans = __ldcg(n_nan);  // awaited at the end
  // the bits that differ between candidates
  const u64 vary = select ? __ldcg(or_all) & __ldcg(not_and_all) : 0;
  int hi = 64 - __clzll((long long)vary), lo = max(hi - 8, 0);
  u64 digit = ((1ull << (hi - lo)) - 1) << lo;  // the first pass's
  int* my_hist = s_hist[0][warp % kCopies];
  for (int b = warp * 32; b < n_cand; b += kTile) {  // whole warps
    u64 c[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = b + j * kThreads + lane;
      c[j] = q >= n_cand ? 0
             : q >= own0 && q < own1 && q < kCache ? s_cache[q]
                                                   : __ldcg(cand + q);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = b + j * kThreads + lane;
      if (c[j] && q < kCache) s_cache[q] = c[j];
      if (c[j] && select)
        atomicAdd(&my_hist[(c[j] & digit) >> lo], 1);
    }
  }
  // f(key) for every candidate: those in shared memory, then the rest
  const auto each_key = [&](auto&& f) {
    for (int q = tid; q < min(n_cand, kCache); q += kThreads) f(s_cache[q]);
    for (int q = kCache + tid; q < n_cand; q += kThreads) f(__ldcg(cand + q));
  };
  __syncthreads();  // the candidates are in shared memory
  // S, the keys in play: (key & sel_mask) >= sel_prefix, n_s of them. It
  // holds the top k; the select narrows it until it fits one chunk of the
  // sort (or is the top k), and the sort does the rest.
  u64 sel_mask = 0, sel_prefix = k ? 0 : 1;
  int n_s = k ? n_cand : 0, need = k;
  u64 rest = vary;  // the differing bits not yet resolved
  for (int pass = 0; n_s > max(k, kChunk) && rest; ++pass) {
    hi = 64 - __clzll((long long)rest);
    lo = max(hi - 8, 0);
    digit = ((1ull << (hi - lo)) - 1) << lo;
    int(*hist)[kBins] = s_hist[pass & 1];
    for (int b = tid; b < kCopies * kBins; b += kThreads)
      (&s_hist[~pass & 1][0][0])[b] = 0;
    my_hist = hist[warp % kCopies];
    if (pass > 0) {  // the copy made the first one
      each_key([&](u64 c) {
        if ((c & sel_mask) == sel_prefix)
          atomicAdd(&my_hist[(c & digit) >> lo], 1);
      });
      __syncthreads();
    }
    // warp 0: the bin that holds the need-th key from the top. Lane l
    // holds bin kBins - 1 - 32c - l of each chunk c of 32 bins.
    if (warp == 0) {
      int h[kBins / 32], before = 0, chunk = -1;
#pragma unroll
      for (int c = 0; c < kBins / 32; ++c) {
        h[c] = 0;
#pragma unroll
        for (int cp = 0; cp < kCopies; ++cp)
          h[c] += hist[cp][kBins - 1 - 32 * c - lane];
        int sum = h[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (chunk < 0 && before + sum >= need) chunk = c;
        if (chunk < 0) before += sum;
      }
      int in_bin = 0;
#pragma unroll
      for (int c = 0; c < kBins / 32; ++c)
        if (c == chunk) in_bin = h[c];
      const int incl = before + warp_scan(in_bin);
      if (incl - in_bin < need && need <= incl) {
        s_sel[pass & 1][0] = kBins - 1 - 32 * chunk - lane;
        s_sel[pass & 1][1] = incl - in_bin;
        s_sel[pass & 1][2] = in_bin;
      }
    }
    __syncthreads();
    sel_prefix |= (u64)s_sel[pass & 1][0] << lo;
    sel_mask |= digit;
    need -= s_sel[pass & 1][1];
    n_s = k - need + s_sel[pass & 1][2];
    rest &= (1ull << lo) - 1;
  }

  // ---- 3. S placed by a block-wide scan: in s_sort as far as kChunk, in
  // the workspace after; where S is every candidate and fits a chunk, it
  // is in place in s_cache already
  const bool in_place = sel_mask == 0 && n_s <= kChunk;
  if (!in_place) {
    int n_mine = 0;
    each_key([&](u64 c) { n_mine += (c & sel_mask) >= sel_prefix; });
    int at = block_scan(n_mine, s_scan, n_s);
    each_key([&](u64 c) {
      if ((c & sel_mask) >= sel_prefix) {
        if (at < kChunk) s_sort[at] = c; else kept[at] = c;
        ++at;
      }
    });
  }
  // sort S a chunk of kChunk at a time, descending: thread t holds the
  // chunk's key t; each warp sorts its 32 (bitonic, by shuffles), then
  // runs merge pairwise (a key's place: its own in its run and, by binary
  // search, the keys above it in the other run), one barrier of the
  // sorting warps a level. The last chunk ends in s_sort, the others in
  // the workspace.
  const int n_chunks = (n_s + kChunk - 1) / kChunk, last = n_chunks - 1;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk, len = min(kChunk, n_s - c0);
    int p2 = 32;
    while (p2 < len) p2 <<= 1;
    __syncthreads();  // S is in place; the last chunk's buffers were read
    if (tid >= p2) continue;
    u64 v = 0;
    if (tid < len)
      v = ch > 0 ? kept[c0 + tid] : in_place ? s_cache[tid] : s_sort[tid];
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const u64 other = __shfl_xor_sync(kFull, v, stride);
        // the lower of a pair keeps the larger key where the run is to
        // descend, the smaller where it is to ascend
        v = ((lane & stride) == 0) == ((lane & size) == 0) ? max(v, other)
                                                           : min(v, other);
      }
    }
    u64* buf = s_merge;
    buf[tid] = v;
    for (int w = 32; w < p2; w <<= 1) {
      asm volatile("bar.sync 1, %0;" ::"r"(p2));
      v = buf[tid];  // the key now at this thread's place
      const int start = tid & ~(2 * w - 1);
      const bool left = (tid & w) == 0;  // of the pair of runs
      const int other = start + (left ? w : 0);
      // the other run's keys (its pads, 0, sort below them); a pad goes
      // after them if it is left, after the whole left run if right
      const int real = min(max(len - other, 0), w);
      const int place = tid - start - (left ? 0 : w) +
                        (v ? keys_above(buf + other, real, v, !left)
                           : left ? real : w);
      buf = s_merge + (buf == s_merge ? kChunk : 0);
      buf[start + place] = v;
    }
    asm volatile("bar.sync 1, %0;" ::"r"(p2));
    if (tid < len) {
      v = buf[tid];
      if (ch == last) s_sort[tid] = v; else kept[c0 + tid] = v;
    }
  }
  __syncthreads();
  // the top k of S at their ranks (a key's place in its chunk and the keys
  // above it in the others), each entry of below zeroed; the empty slots
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk;
    if (tid < min(kChunk, n_s - c0)) {
      const u64 c = ch == last ? s_sort[tid] : kept[c0 + tid];
      int rank = tid;
      for (int o = 0; o < n_chunks; ++o)
        if (o != ch)
          rank += keys_above(o == last ? s_sort : kept + o * kChunk,
                             min(kChunk, n_s - o * kChunk), c);
      if (rank < k) {
        const bool nan = is_nan_key(c);
        values[rank] = nan ? 0.f : key_value(c);
        indices[rank] = nan ? -1 : (int64_t)key_index(c);
        if (!nan) below[key_index(c)] = 0.f;
      }
    }
  }
  for (int r = k + tid; r < cap; r += kThreads) {
    values[r] = 0.f;
    indices[r] = -1;
  }
  if (tid == 0) {
    count[0] = n_cand - (int)nans;
    state[0] = state[1] = state[2] = state[3] = 0;
  }
}

}  // namespace

extern "C" int ts_encode_launch(const void* x, int x_bf16, float tau,
                                long long n, int cap, void* below,
                                void* values, void* indices, void* count,
                                void* state, void* work, void* stream) {
  if (n < 1 || n > kMaxN || cap < 0) return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {};
  cudaError_t e = smem_opt_in(ts_encode_kernel, kSmem, opted);
  if (e != cudaSuccess) return (int)e;
  u64* cand = static_cast<u64*>(work);
  ts_encode_kernel<<<(unsigned)((n + kTile - 1) / kTile), kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, tau, (int)n, cap, static_cast<float*>(below),
      static_cast<float*>(values), static_cast<int64_t*>(indices),
      static_cast<int32_t*>(count), static_cast<u64*>(state), cand,
      cand + n);
  return (int)cudaGetLastError();
}
