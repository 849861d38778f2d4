// Asynchronous 4-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), for kernels that stage an operand ahead of
// the steps that read it.  A thread's copies are committed as groups; a
// wait returns once at most kPending of that thread's groups are still in
// flight.  The copies a thread waited for are visible to that thread only:
// a block that reads another thread's copies needs a barrier after the wait.

#ifndef CTC_TPU_TORCH_CP_ASYNC_CUH_
#define CTC_TPU_TORCH_CP_ASYNC_CUH_

#include <cuda_runtime.h>

namespace cp_async {

// One 4-byte asynchronous copy, device memory -> shared memory.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst_s),
               "l"(src)
               : "memory");
}

// The shared-window address of a pointer into shared memory, converted
// once (volatile, so that a loop does not convert it again at every copy or
// read through it).
__device__ __forceinline__ unsigned shared_address(const void* p) {
  unsigned a;
  asm volatile(
      "{\n .reg .u64 t;\n cvta.to.shared.u64 t, %1;\n"
      " cvt.u32.u64 %0, t;\n}\n"
      : "=r"(a)
      : "l"(p));
  return a;
}

// One 4-byte asynchronous copy to a shared-window address.
__device__ __forceinline__ void copy4(unsigned dst_s, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst_s),
               "l"(src)
               : "memory");
}

// One 8-byte asynchronous copy to a shared-window address (both addresses
// 8-byte aligned).
__device__ __forceinline__ void copy8(unsigned dst_s, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst_s),
               "l"(src)
               : "memory");
}

// An 8-byte load of two floats from a shared-window address (8-byte
// aligned), kept after the waits before it.
__device__ __forceinline__ float2 load2(unsigned src_s) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(src_s)
               : "memory");
  return v;
}

// A 4-byte load from a shared-window address, kept after the waits before
// it.
__device__ __forceinline__ float load(unsigned src_s) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(src_s) : "memory");
  return v;
}

// Close this thread's uncommitted copies into one group.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace cp_async

#endif  // CTC_TPU_TORCH_CP_ASYNC_CUH_
