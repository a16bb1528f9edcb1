// Helpers the port's kernels share, for Hopper (sm_90a). Included by the
// sources under csrc/; build.py hashes this file into every kernel's
// library name, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

// the opt-in to ``bytes`` of dynamic shared memory for ``fn``, made once on
// each device: cudaFuncSetAttribute acts on the current device only
template <typename Fn>
cudaError_t smem_opt_in(Fn fn, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies of 16 and 4 bytes, all of a group in flight
// until cp_async_commit_wait()
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// four int8 codes to f32, exactly: b ^ 0x80 = b + 128 as a byte, put as
// the low mantissa bits of 2^23, gives the float 2^23 + b + 128; less
// 2^23 + 128 that is b
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ void widen16(const int4& raw, float* f) {
  widen4(static_cast<uint32_t>(raw.x), f);
  widen4(static_cast<uint32_t>(raw.y), f + 4);
  widen4(static_cast<uint32_t>(raw.z), f + 8);
  widen4(static_cast<uint32_t>(raw.w), f + 12);
}

}  // namespace
