// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), shared by the paged kernels and the flash kernels.  A copy moves 16 bytes (or 4) without passing through
// registers; with src_bytes == 0 it writes zeros and reads nothing, so a
// masked row is never touched (src must still be a valid address).
// Copies issued since the last commit form one group; wait_all blocks
// until every committed group has landed, and a __syncthreads() after it
// makes the data visible to the whole block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pt_async {

__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Blocks until at most N of the committed groups are still in flight (the
// oldest land first), for a ring of N + 1 or more staged tiles.
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive shared-memory values as float32 (one 16-byte load for
// float32, one 8-byte load widened for bfloat16).
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// acc + a . b over the four lanes, in x, y, z, w order.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

}  // namespace pt_async
