// Tensor copies (TMA, sm_90) from device memory into shared memory, and
// the shared-memory barriers (mbarrier) that report their completion.  One
// thread arms a barrier with the bytes it expects and issues the copies;
// every thread that reads the destination waits on the barrier's phase.
// Barriers and destinations are shared-window addresses
// (cp_async::shared_address); a destination is 128-byte aligned.

#ifndef CTC_TPU_TORCH_TMA_CUH_
#define CTC_TPU_TORCH_TMA_CUH_

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tma {

// A barrier that completes a phase once `count` threads have arrived and
// the bytes they expect have landed.
__device__ __forceinline__ void init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers this thread initialized visible to the copy engine.
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on `bar`, expecting `bytes` more to land in this phase.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// that polls 2^30 times traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void wait(unsigned bar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}

// The box of `map` at coordinates {c0, c1, c2} (innermost first) -> dst;
// its bytes count against `bar`'s expected bytes.
__device__ __forceinline__ void load_3d(unsigned dst, const CUtensorMap* map,
                                        int c0, int c1, int c2,
                                        unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

}  // namespace tma

#endif  // CTC_TPU_TORCH_TMA_CUH_
