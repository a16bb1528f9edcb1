// Decode attention over the paged int8 KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode_attention.py
// (paged_decode_attention, pallas_call at line 121). Python wrapper, launch
// count and plain PyTorch version: repro_torch/kernels/paged_decode_attention.py.
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
// it takes no part in the online softmax at all.
//
// Page b of a row holds positions [b*page, (b+1)*page), so the walk covers
// only the row's pages 0 .. q_pos / page (the TPU kernel walks all nb
// entries; the rest hold masked slots only), and a row with q_pos < 0
// writes zeros at once.
//
// Bound: one call reads the codes and scales of the pages its rows need,
// K*page*(2*hd + 8) bytes per page plus its positions, against 4*K*G*hd
// flops per key, so at small G it is bound by device-memory bytes.
//
// Design (the dense kernel K1's, re-addressed): one block of 8 warps per
// (row, kv-head, group of GC query rows). The row's logical slots are
// walked in steps; slot t lives at page block_table[r][t / page], offset
// t % page. A slot's hd codes are split over LPS = hd/16 lanes (one 16-byte
// load each); each lane group keeps its own online-softmax state (m, l) per
// query row and acc for its 16-dim slice; the groups are merged with
// shuffles across the warp, then through shared memory across warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 16;  // int8 codes per lane per slot: one 16-byte load
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int HD, int GC>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const void* __restrict__ q, int q_bf16,
                              float scale, const int8_t* __restrict__ k_codes,
                              const float* __restrict__ k_scale,
                              const int8_t* __restrict__ v_codes,
                              const float* __restrict__ v_scale,
                              const int32_t* __restrict__ pool_pos,
                              const int32_t* __restrict__ block_table,
                              const int32_t* __restrict__ q_pos,
                              float* __restrict__ out, int K, int G, int page,
                              int nb) {
  constexpr int LPS = HD / kVec;      // lanes per slot
  constexpr int SPW = 32 / LPS;       // slots per warp per step
  constexpr int SPB = kWarps * SPW;   // slots per block per step

  const int kh = blockIdx.x, r = blockIdx.y, g0 = blockIdx.z * GC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, j = lane % LPS;
  const size_t rk = (size_t)r * K + kh;

  const int qp = q_pos[r];
  // logical slots to walk: whole pages 0 .. qp / page, within the table
  const int n_slots = qp < 0 ? 0 : min(qp / page + 1, nb) * page;
  if (n_slots == 0) {  // a free slot: nothing is attended, exact zeros
    for (int idx = threadIdx.x; idx < GC * HD; idx += kThreads) {
      const int g = idx / HD;
      if (g0 + g < G) out[(rk * G + g0 + g) * HD + idx % HD] = 0.f;
    }
    return;
  }

  // this lane's 16-dim slice of each query row, pre-scaled by 1/sqrt(hd)
  float qv[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const size_t row = (rk * G + g0 + g) * HD + j * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float x = 0.f;
      if (g0 + g < G) {
        x = q_bf16 ? __bfloat162float(
                         reinterpret_cast<const __nv_bfloat16*>(q)[row + i])
                   : reinterpret_cast<const float*>(q)[row + i];
      }
      qv[g][i] = x * scale;
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

  const int32_t* bt = block_table + (size_t)r * nb;
  // every lane runs every step, so the shuffles below always see the full
  // warp; a lane whose slot is absent or masked skips the softmax update
  for (int base = 0; base < n_slots; base += SPB) {
    const int t = base + warp * SPW + sub;
    int4 kraw = make_int4(0, 0, 0, 0), vraw = make_int4(0, 0, 0, 0);
    float ks = 0.f, vs = 0.f;
    int p = -1;
    if (t < n_slots) {
      const int b = t / page, off = t - b * page;
      const size_t phys = (size_t)bt[b];
      const size_t slot = (phys * K + kh) * page + off;
      kraw = *reinterpret_cast<const int4*>(k_codes + slot * HD + j * kVec);
      vraw = *reinterpret_cast<const int4*>(v_codes + slot * HD + j * kVec);
      ks = k_scale[slot];
      vs = v_scale[slot];
      p = pool_pos[phys * page + off];
    }
    const int8_t* kc = reinterpret_cast<const int8_t*>(&kraw);
    const int8_t* vc = reinterpret_cast<const int8_t*>(&vraw);
    const bool valid = p >= 0 && p <= qp;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv[g][i], (float)kc[i], dot);
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (valid) {
        const float s = dot * ks;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
        const float pv = pr * vs;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][i] = fmaf(pv, (float)vc[i], acc[g][i] * corr);
        m[g] = m_new;
      }
    }
  }

  // merge the lane groups of this warp (same j, different slots); a group
  // that saw no valid key has m = -1e30, l = 0, acc = 0 and weighs nothing
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx), c = expf(mo - mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mx;
    }
  }

  // merge the warps through shared memory
  __shared__ float red_m[kWarps][GC], red_l[kWarps][GC];
  __shared__ float red_acc[kWarps][GC][HD];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) red_acc[warp][g][j * kVec + i] = acc[g][i];
      if (j == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GC * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    if (g0 + g >= G) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(red_m[w][g] - mx);
      lsum += red_l[w][g] * e;
      a += red_acc[w][g][d] * e;
    }
    // no valid key in the whole row: exact zeros
    out[(rk * G + g0 + g) * HD + d] =
        mx > 0.5f * kNegInf ? a / fmaxf(lsum, 1e-30f) : 0.f;
  }
}

template <int HD, int GC>
cudaError_t launch(const void* q, int q_bf16, float scale, const void* kc,
                   const void* ks, const void* vc, const void* vs,
                   const void* pool_pos, const void* block_table,
                   const void* q_pos, void* out, int R, int K, int G,
                   int page, int nb, cudaStream_t st) {
  const dim3 grid(K, R, (G + GC - 1) / GC);
  paged_decode_attention_kernel<HD, GC><<<grid, kThreads, 0, st>>>(
      q, q_bf16, scale, static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int32_t*>(pool_pos),
      static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(q_pos), static_cast<float*>(out), K, G,
      page, nb);
  return cudaGetLastError();
}

// GC query rows per block: 1 and 2 fit exactly, larger groups go 4 at a time
template <int HD>
cudaError_t launch_hd(const void* q, int q_bf16, float scale, const void* kc,
                      const void* ks, const void* vc, const void* vs,
                      const void* pool_pos, const void* block_table,
                      const void* q_pos, void* out, int R, int K, int G,
                      int page, int nb, cudaStream_t st) {
  if (G == 1)
    return launch<HD, 1>(q, q_bf16, scale, kc, ks, vc, vs, pool_pos,
                         block_table, q_pos, out, R, K, G, page, nb, st);
  if (G == 2)
    return launch<HD, 2>(q, q_bf16, scale, kc, ks, vc, vs, pool_pos,
                         block_table, q_pos, out, R, K, G, page, nb, st);
  return launch<HD, 4>(q, q_bf16, scale, kc, ks, vc, vs, pool_pos,
                       block_table, q_pos, out, R, K, G, page, nb, st);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_decode_attention_launch(
    const void* q, int q_bf16, float scale, const void* k_codes,
    const void* k_scale, const void* v_codes, const void* v_scale,
    const void* pool_pos, const void* block_table, const void* q_pos,
    void* out, int R, int K, int G, int HD, int page, int nb, void* stream) {
  if (R < 1 || K < 1 || G < 1 || nb < 1 || page < 1 || page > 64 ||
      R > 65535 || G > 4 * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32:
      return (int)launch_hd<32>(q, q_bf16, scale, k_codes, k_scale, v_codes,
                                v_scale, pool_pos, block_table, q_pos, out,
                                R, K, G, page, nb, st);
    case 64:
      return (int)launch_hd<64>(q, q_bf16, scale, k_codes, k_scale, v_codes,
                                v_scale, pool_pos, block_table, q_pos, out,
                                R, K, G, page, nb, st);
    case 128:
      return (int)launch_hd<128>(q, q_bf16, scale, k_codes, k_scale,
                                 v_codes, v_scale, pool_pos, block_table,
                                 q_pos, out, R, K, G, page, nb, st);
    case 256:
      return (int)launch_hd<256>(q, q_bf16, scale, k_codes, k_scale,
                                 v_codes, v_scale, pool_pos, block_table,
                                 q_pos, out, R, K, G, page, nb, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
