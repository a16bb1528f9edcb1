// Decode attention over an int8-quantized KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at line 113). Python wrapper, launch count,
// unit plan and plain PyTorch version:
// repro_torch/kernels/decode_attention.py.
//
//   q        (B, K, G, hd)  f32 or bf16
//   k_codes  (B, K, S, hd)  int8      k_scale (B, K, S)  f32
//   v_codes  (B, K, S, hd)  int8      v_scale (B, K, S)  f32
//   kv_pos   (B, S)         int32     (-1 = empty slot)
//   q_pos    one int32 for all rows (stride 0) or one per row (stride 1)
//   out      (B, K, G, hd)  f32
//
// Semantics kept from the TPU kernel: the score is q.k/sqrt(hd) in f32; a
// slot is attended when 0 <= kv_pos <= q_pos; a row with no valid slot
// returns the uniform average of v over its S slots (the TPU kernel's
// -1e30 mask gives every slot the same weight there).
//
// Bound: one call reads the codes and scales of the slots its rows need,
// K*(2*hd + 8) bytes a slot plus its position, against 4*K*G*hd flops a
// slot, so at G <= 8 it is bound by device-memory bytes.
//
// The slot contract: every valid slot of a row lies in 0 .. min(q_pos,
// S - 1). The dense cache writes position p at slot p, so slot t holds t
// or -1; a sliding-window ring of W <= S slots writes p at slot p mod W,
// and once it has wrapped q_pos >= W, so its slots all lie below q_pos
// and hold positions in (q_pos - W, q_pos]: the position mask is the
// window's (models/layers.py::cache_update). The split kernel reads only
// slots 0 .. min(q_pos, S - 1) (the TPU kernel walks all S slots; the
// rest are masked and weigh exactly 0 there).
//
// decode_split_kernel (flash-decoding, K2's split kernel on the dense
// cache): a unit is one row, one run of KEYS consecutive slots (256, 128 at
// hd 256: unit_keys) and one kv-head with a group of up to GC of its query
// heads. The grid, (K * ceil(G / GC), B, ceil(S / KEYS)), depends on
// shapes only (no host read of q_pos: a call is graph-capturable); a unit whose first slot is
// past its row's q_pos exits at once. A live unit puts its slots' codes
// (contiguous in the cache), scales and positions in shared memory by
// cp.async, all in flight at once. Lane groups of hd/16 lanes take KEYS /
// (keys a block step) keys each: first their scores, then one max, then
// the values weighted by 2^(score - max), in base 2 (the query pre-scaled
// by log2(e)/sqrt(hd)). The lane groups merge by shuffles across the warp
// and through shared memory across warps in warp order. A row of one unit
// writes its output there. In a longer row each unit writes its (max,
// sum, weighted values) to a workspace and takes a ticket for its (row,
// kv-head, group), and the unit that takes the last merges the units in
// unit order (a run repeats its bits; no float atomics, no second launch)
// and resets the ticket for the next call (or a graph's next replay). A
// row where no unit saw a valid slot takes the slow branch: the merging
// unit (or the only one) averages v over all S slots. Codes widen to f32
// in registers; no dequantized copy is written.
//
// Head dim 120 (h2o-danube-3-4b) runs the hd-128 lanes (padded_hd: hd
// rounded up to whole 16-code lanes): a unit's rows stay contiguous in
// shared memory, 120 bytes apart, so a lane's 16 codes are two 8-byte
// loads, and the 8 codes past a row's end (the next row's, or bytes never
// staged: any byte widens to a finite code) meet q's tail, which is zero:
// the scores are exact, and the value dims past 120 are never written
// out. A unit stages by 16-byte copies when its first slot
// is 16-byte aligned (an even slot index), else by 8-byte copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 16;  // int8 codes per lane per slot: 16 bytes
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  int q_bf16;
  float scale;
  const int8_t* k_codes;
  const float* k_scale;
  const int8_t* v_codes;
  const float* v_scale;
  const int32_t* kv_pos;
  const int32_t* q_pos;
  int q_pos_stride;
  float* out;
  float* part;   // (B, units, K, G) x (hd values), then (max, sum) pairs
  int* tickets;  // (B, K, head groups), zero between calls
  int B, K, G, S;
};

// the slots of a unit at HD (decode_attention.py::unit_keys): whole block
// steps (the kernel asserts it), and a unit's stage (codes, scales,
// positions) within 69 KB of shared memory, three units an SM (as K2's
// split). On an H100 the fastest size at llama2-7b's decode shapes
// (python -m repro_torch.kernels.decode_probe --only k1)
template <int HD>
__host__ __device__ constexpr int unit_keys() {
  return HD == 256 ? 128 : 256;
}

// the lanes' head dim: hd rounded up to whole 16-code lanes
template <int HD>
__host__ __device__ constexpr int padded_hd() {
  return (HD + kVec - 1) / kVec * kVec;
}

// a lane's 16 codes of a staged row: one 16-byte load, or two 8-byte ones
// where rows are 8-byte aligned (hd 120)
template <int HD>
__device__ __forceinline__ int4 lane_codes(const int8_t* p) {
  if constexpr (HD % kVec == 0) {
    return *reinterpret_cast<const int4*>(p);
  } else {
    const int2 lo = *reinterpret_cast<const int2*>(p);
    const int2 hi = *reinterpret_cast<const int2*>(p + 8);
    return make_int4(lo.x, lo.y, hi.x, hi.y);
  }
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src));
}

template <int HD, int GC>
constexpr int split_smem_bytes() {
  // the staged unit, reused after the walk for the warps' merge
  constexpr int stage = unit_keys<HD>() * (2 * HD + 12);
  static_assert(stage <= 70 * 1024, "three units an SM");
  constexpr int merge = kWarps * GC * (HD + 2) * 4;
  return stage > merge ? stage : merge;
}

// A row's answer when no slot is valid: the uniform average of v over all
// S slots, for the GC query rows from g0 of kv-head row bk (= b * K + kh).
// A slow branch: the serve and split paths never produce such a row.
template <int HD, int GC>
__device__ void uniform_average(const Args& a, size_t bk, int g0) {
  const int8_t* vb = a.v_codes + bk * a.S * HD;
  const float* vsb = a.v_scale + bk * a.S;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < a.S; ++t)
      acc = fmaf(vsb[t], (float)vb[(size_t)t * HD + d], acc);
    const float avg = acc / (float)a.S;
#pragma unroll
    for (int g = 0; g < GC; ++g)
      if (g0 + g < a.G) a.out[(bk * a.G + g0 + g) * HD + d] = avg;
  }
}

// The registers are held to what the resident units can have: three a
// unit of one head, two of two, one of four (as K2's split kernel).
template <int HD, int GC>
__global__ void __launch_bounds__(kThreads, GC == 1 ? 3 : (GC == 2 ? 2 : 1))
decode_split_kernel(const __grid_constant__ Args a) {
  constexpr int KEYS = unit_keys<HD>();
  constexpr int LPS = padded_hd<HD>() / kVec;  // lanes a key
  constexpr int SPW = 32 / LPS;        // keys a warp a step
  constexpr int SPB = kWarps * SPW;    // keys a block a step
  constexpr int KPL = KEYS / SPB;      // keys a lane group
  static_assert(KPL >= 1 && KPL * SPB == KEYS, "a unit is whole steps");
  extern __shared__ __align__(128) int8_t smem[];

  const int groups = (a.G + GC - 1) / GC;
  const int kh = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int g0 = grp * GC, b = blockIdx.y;
  const int units = gridDim.z, unit = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPS, j = lane % LPS;
  const size_t bk = (size_t)b * a.K + kh;

  // the slot contract: the row's valid slots lie in 0 .. q_pos
  const int qp = a.q_pos[(size_t)b * a.q_pos_stride];
  const int n_live = qp < 0 ? 0 : min(qp + 1, a.S);
  const int n_split = (n_live + KEYS - 1) / KEYS;
  if (n_split == 0) {  // no slot to walk: the first unit averages v
    if (unit == 0) uniform_average<HD, GC>(a, bk, g0);
    return;
  }
  if (unit >= n_split) return;  // past the row's q_pos
  const int k0 = unit * KEYS;
  const int n = min(n_live, k0 + KEYS) - k0;

  int8_t* kc = smem;  // [KEYS][HD]
  int8_t* vc = kc + KEYS * HD;
  float* ksc = reinterpret_cast<float*>(vc + KEYS * HD);  // [KEYS]
  float* vsc = ksc + KEYS;
  int* kps = reinterpret_cast<int*>(vsc + KEYS);

  // the unit's codes (n consecutive slots: one contiguous run each of k
  // and v), scales and positions, all in flight at once
  const size_t s0 = bk * a.S + k0;
  const int8_t* kg = a.k_codes + s0 * HD;
  const int8_t* vg = a.v_codes + s0 * HD;
  const int bytes = n * HD;  // a multiple of 8
  if (HD % 16 == 0 || ((uintptr_t)kg | (uintptr_t)vg) % 16 == 0) {
    for (int e = tid; e < bytes / 16; e += kThreads) {
      cp_async16(smem_u32(kc + e * 16), kg + e * 16);
      cp_async16(smem_u32(vc + e * 16), vg + e * 16);
    }
    if (HD % 16 != 0 && bytes % 16 != 0 && tid == 0) {
      cp_async8(smem_u32(kc + bytes - 8), kg + bytes - 8);
      cp_async8(smem_u32(vc + bytes - 8), vg + bytes - 8);
    }
  } else {  // hd 120 from an odd slot index: 8-byte aligned
    for (int e = tid; e < bytes / 8; e += kThreads) {
      cp_async8(smem_u32(kc + e * 8), kg + e * 8);
      cp_async8(smem_u32(vc + e * 8), vg + e * 8);
    }
  }
  for (int jj = tid; jj < n; jj += kThreads) {
    cp_async4(smem_u32(ksc + jj), a.k_scale + s0 + jj);
    cp_async4(smem_u32(vsc + jj), a.v_scale + s0 + jj);
    cp_async4(smem_u32(kps + jj), a.kv_pos + (size_t)b * a.S + k0 + jj);
  }

  // this lane's 16-dim slice of each query row, pre-scaled by
  // log2(e)/sqrt(hd): the softmax runs in base 2; dims past hd are zero
  float qv[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const size_t row = (bk * a.G + g0 + g) * HD + j * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float x = 0.f;
      if (g0 + g < a.G && (HD % kVec == 0 || j * kVec + i < HD))
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
    widen16(lane_codes<HD>(kc + kk * HD + j * kVec), kf);
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
  // a row of one unit with no valid slot: the slow branch, at once
  const int seen = __syncthreads_or(valid != 0u);
  if (n_split == 1 && !seen) {
    uniform_average<HD, GC>(a, bk, g0);
    return;
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
    widen16(lane_codes<HD>(vc + key * HD + j * kVec), vf);
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
      for (int i = 0; i < kVec; ++i)
        if (HD % kVec == 0 || j * kVec + i < HD) w[j * kVec + i] = acc[g][i];
      if (j == 0) {
        w[HD] = m[g];
        w[HD + 1] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t parts = (size_t)a.B * units * a.K * a.G;
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
    if (n_split == 1) {  // the row's only unit: its output
      if (d < HD) a.out[(bk * a.G + g0 + g) * HD + d] = v / fmaxf(lsum, 1e-30f);
      continue;
    }
    const size_t at = (((size_t)b * units + unit) * a.K + kh) * a.G + g0 + g;
    if (d < HD) {
      a.part[at * HD + d] = v;
    } else {
      a.part[parts * HD + 2 * at] = mx;
      a.part[parts * HD + 2 * at + 1] = v;
    }
  }
  if (n_split == 1) return;

  // the unit that takes the row's last ticket merges its units in order
  __shared__ int last, any;
  __threadfence();  // this unit's part is visible before its ticket
  __syncthreads();
  int* ticket = a.tickets + bk * groups + grp;
  if (tid == 0) last = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t at0 = ((size_t)b * units * a.K + kh) * a.G + g0;
  const size_t step = (size_t)a.K * a.G;  // from one unit to the next
  if (tid == 0) {  // did any unit see a valid slot? (the row's answer)
    float mx = kNegInf;
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx, __ldcg(a.part + parts * HD + 2 * (at0 + sp * step)));
    any = mx > 0.5f * kNegInf;
    *ticket = 0;  // ready for the next call
  }
  __syncthreads();
  if (!any) {
    uniform_average<HD, GC>(a, bk, g0);
    return;
  }
  for (int idx = tid; idx < GC * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    if (g0 + g >= a.G) continue;
    float mx = kNegInf;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp)
      mx = fmaxf(mx,
                 __ldcg(a.part + parts * HD + 2 * (at0 + g + sp * step)));
    float lsum = 0.f, v = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t at = at0 + g + sp * step;
      const float w = exp2f(__ldcg(a.part + parts * HD + 2 * at) - mx);
      lsum += __ldcg(a.part + parts * HD + 2 * at + 1) * w;
      v += __ldcg(a.part + at * HD + d) * w;
    }
    a.out[(bk * a.G + g0 + g) * HD + d] = v / fmaxf(lsum, 1e-30f);
  }
}

template <int HD, int GC>
cudaError_t launch_split(const Args& a, int units, cudaStream_t st) {
  constexpr int bytes = split_smem_bytes<HD, GC>();
  static bool opted[kMaxDevices] = {};
  cudaError_t e = smem_opt_in(decode_split_kernel<HD, GC>, bytes, opted);
  if (e != cudaSuccess) return e;
  // kv-heads vary fastest, units slowest: a step's live units (the first
  // ones of every row) are scheduled before the ones that exit at once
  const long long x = (long long)a.K * ((a.G + GC - 1) / GC);
  if (x > 2147483647LL) return cudaErrorInvalidValue;
  decode_split_kernel<HD, GC>
      <<<dim3((unsigned)x, a.B, units), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// ``units`` must be the plan's, ceil(S / unit_keys); GC query rows a unit:
// 1 and 2 fit exactly, larger groups go 4 at a time
template <int HD>
cudaError_t launch_hd(const Args& a, int units, cudaStream_t st) {
  constexpr int keys = unit_keys<HD>();
  if (units < 1 || units > 65535 || (long long)units * keys < a.S ||
      (long long)(units - 1) * keys >= a.S ||
      (units > 1 && (a.part == nullptr || a.tickets == nullptr)))
    return cudaErrorInvalidValue;
  if (a.G == 1) return launch_split<HD, 1>(a, units, st);
  if (a.G == 2) return launch_split<HD, 2>(a, units, st);
  return launch_split<HD, 4>(a, units, st);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernel does not take. ``scale`` is
// log2(e)/sqrt(hd); ``units`` is ceil(S / unit_keys) (256 slots, 128 at hd
// 256); with more than one, ``part`` is a workspace of B * units * K * G *
// (hd + 2) f32 and ``tickets`` B * K * ceil(G / group) int32, zero before
// the call (the kernel leaves them at zero; group is G for G <= 2, else 4).
extern "C" int decode_attention_launch(
    const void* q, int q_bf16, float scale, const void* k_codes,
    const void* k_scale, const void* v_codes, const void* v_scale,
    const void* kv_pos, const void* q_pos, int q_pos_stride, void* out,
    void* part, void* tickets, int B, int K, int G, int S, int HD, int units,
    void* stream) {
  if (B < 1 || K < 1 || G < 1 || S < 1 || B > 65535 || G > 4 * 65535 ||
      ((uintptr_t)k_codes | (uintptr_t)v_codes) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{q, q_bf16, scale,
               static_cast<const int8_t*>(k_codes),
               static_cast<const float*>(k_scale),
               static_cast<const int8_t*>(v_codes),
               static_cast<const float*>(v_scale),
               static_cast<const int32_t*>(kv_pos),
               static_cast<const int32_t*>(q_pos), q_pos_stride,
               static_cast<float*>(out), static_cast<float*>(part),
               static_cast<int*>(tickets), B, K, G, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32: return (int)launch_hd<32>(a, units, st);
    case 64: return (int)launch_hd<64>(a, units, st);
    case 120: return (int)launch_hd<120>(a, units, st);
    case 128: return (int)launch_hd<128>(a, units, st);
    case 256: return (int)launch_hd<256>(a, units, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
