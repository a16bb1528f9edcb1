// Decode attention over an int8-quantized KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, pallas_call at line 113). Python wrapper, launch count
// and plain PyTorch version: repro_torch/kernels/decode_attention.py.
//
//   q        (B, K, G, hd)  f32 or bf16
//   k_codes  (B, K, S, hd)  int8      k_scale (B, K, S)  f32
//   v_codes  (B, K, S, hd)  int8      v_scale (B, K, S)  f32
//   kv_pos   (B, S)         int32     (-1 = empty slot)
//   q_pos    one int32 for all rows (stride 0) or one per row (stride 1)
//   out      (B, K, G, hd)  f32
//
// Semantics kept from the TPU kernel: the score is q.k/sqrt(hd) in f32; a
// slot is attended when 0 <= kv_pos <= q_pos, and a masked score is set to
// -1e30 (not -inf), so a row with no valid slot returns the uniform average
// of v over its S slots; the result is acc / max(l, 1e-30).
//
// Bound: one decode call reads the whole cache once, B*K*S*(2*hd + 8) bytes
// of codes and scales plus B*S*4 of positions, and does 4*B*K*G*S*hd flops,
// so at G <= 8 it is bound by device-memory bytes. The design streams the
// codes once with 16-byte loads (neighbouring lanes on neighbouring bytes),
// dequantizes in registers and never writes a dequantized copy.
//
// Design: one block of 8 warps per (b, kv-head, group of GC query rows);
// the TPU grid's sequential S axis becomes a loop inside the block. A slot's
// hd codes are split over LPS = hd/16 lanes; the warp covers 32/LPS slots
// per step. Each lane group keeps its own online-softmax state (m, l) per
// query row and acc for its 16-dim slice, the hd dot is reduced with
// shuffles inside the group, and at the end the groups are merged with
// shuffles across the warp and through shared memory across warps.
// Later work: split S over more blocks (flash-decoding with a combine pass)
// when B*K is small against 132 SMs, and skip tiles past q_pos.

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
decode_attention_kernel(const void* __restrict__ q, int q_bf16, float scale,
                        const int8_t* __restrict__ k_codes,
                        const float* __restrict__ k_scale,
                        const int8_t* __restrict__ v_codes,
                        const float* __restrict__ v_scale,
                        const int32_t* __restrict__ kv_pos,
                        const int32_t* __restrict__ q_pos, int q_pos_stride,
                        float* __restrict__ out, int K, int G, int S) {
  constexpr int LPS = HD / kVec;      // lanes per slot
  constexpr int SPW = 32 / LPS;       // slots per warp per step
  constexpr int SPB = kWarps * SPW;   // slots per block per step

  const int kh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * GC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, j = lane % LPS;
  const size_t bk = (size_t)b * K + kh;

  // this lane's 16-dim slice of each query row, pre-scaled by 1/sqrt(hd)
  float qv[GC][kVec];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const size_t row = (bk * G + g0 + g) * HD + j * kVec;
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

  const int qp = q_pos[(size_t)b * q_pos_stride];
  const int8_t* kb = k_codes + bk * S * HD + j * kVec;
  const int8_t* vb = v_codes + bk * S * HD + j * kVec;
  const float* ksb = k_scale + bk * S;
  const float* vsb = v_scale + bk * S;
  const int32_t* pb = kv_pos + (size_t)b * S;

  // every lane runs every step, so the shuffles below always see the full
  // warp; a slot past S contributes nothing (it is absent, not masked)
  for (int base = 0; base < S; base += SPB) {
    const int t = base + warp * SPW + sub;
    const bool in = t < S;
    int4 kraw = make_int4(0, 0, 0, 0), vraw = make_int4(0, 0, 0, 0);
    float ks = 0.f, vs = 0.f;
    int p = -1;
    if (in) {
      kraw = *reinterpret_cast<const int4*>(kb + (size_t)t * HD);
      vraw = *reinterpret_cast<const int4*>(vb + (size_t)t * HD);
      ks = ksb[t];
      vs = vsb[t];
      p = pb[t];
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
      if (in) {
        const float s = valid ? dot * ks : kNegInf;
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

  // merge the lane groups of this warp (same j, different slots)
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
    out[(bk * G + g0 + g) * HD + d] = a / fmaxf(lsum, 1e-30f);
  }
}

template <int HD, int GC>
cudaError_t launch(const void* q, int q_bf16, float scale, const void* kc,
                   const void* ks, const void* vc, const void* vs,
                   const void* kv_pos, const void* q_pos, int q_pos_stride,
                   void* out, int B, int K, int G, int S, cudaStream_t st) {
  const dim3 grid(K, B, (G + GC - 1) / GC);
  decode_attention_kernel<HD, GC><<<grid, kThreads, 0, st>>>(
      q, q_bf16, scale, static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int32_t*>(kv_pos),
      static_cast<const int32_t*>(q_pos), q_pos_stride,
      static_cast<float*>(out), K, G, S);
  return cudaGetLastError();
}

// GC query rows per block: 1 and 2 fit exactly, larger groups go 4 at a time
template <int HD>
cudaError_t launch_hd(const void* q, int q_bf16, float scale, const void* kc,
                      const void* ks, const void* vc, const void* vs,
                      const void* kv_pos, const void* q_pos, int q_pos_stride,
                      void* out, int B, int K, int G, int S, cudaStream_t st) {
  if (G == 1)
    return launch<HD, 1>(q, q_bf16, scale, kc, ks, vc, vs, kv_pos, q_pos,
                         q_pos_stride, out, B, K, G, S, st);
  if (G == 2)
    return launch<HD, 2>(q, q_bf16, scale, kc, ks, vc, vs, kv_pos, q_pos,
                         q_pos_stride, out, B, K, G, S, st);
  return launch<HD, 4>(q, q_bf16, scale, kc, ks, vc, vs, kv_pos, q_pos,
                       q_pos_stride, out, B, K, G, S, st);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int decode_attention_launch(
    const void* q, int q_bf16, float scale, const void* k_codes,
    const void* k_scale, const void* v_codes, const void* v_scale,
    const void* kv_pos, const void* q_pos, int q_pos_stride, void* out,
    int B, int K, int G, int S, int HD, void* stream) {
  if (B < 1 || K < 1 || G < 1 || S < 1 || B > 65535 || G > 4 * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32:
      return (int)launch_hd<32>(q, q_bf16, scale, k_codes, k_scale, v_codes,
                                v_scale, kv_pos, q_pos, q_pos_stride, out, B,
                                K, G, S, st);
    case 64:
      return (int)launch_hd<64>(q, q_bf16, scale, k_codes, k_scale, v_codes,
                                v_scale, kv_pos, q_pos, q_pos_stride, out, B,
                                K, G, S, st);
    case 128:
      return (int)launch_hd<128>(q, q_bf16, scale, k_codes, k_scale, v_codes,
                                 v_scale, kv_pos, q_pos, q_pos_stride, out, B,
                                 K, G, S, st);
    case 256:
      return (int)launch_hd<256>(q, q_bf16, scale, k_codes, k_scale, v_codes,
                                 v_scale, kv_pos, q_pos, q_pos_stride, out, B,
                                 K, G, S, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
