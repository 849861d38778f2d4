// Forward-lattice probes: stripped variants of the blank-free forward
// recursion, for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).  Layout is the probes' [T, L, B] ("tlb", samples
// innermost), float32, contiguous.  They measure which operation of the
// forward step binds it; no training path runs them.
//
// Replaces probe_fwd_ops.py:make (the six variants "copy", "add", "roll",
// "lse", "lse_manual", "lse_exp2", entry points probe_<variant>) and
// probe_fwd_ops.py:make_noout (entry point probe_noout), both through the
// pallas_call at probe_fwd_ops.py:75 / :129: the kernel fwd_ops_kernel<Body,
// kNoOut, kDepth>; and probe_expdomain_fwd.py:fwd_log_kernel,
// :fwd_exp_kernel, :fwd_exp_renorm_kernel (pallas_call at :119; entry
// points probe_fwd_log, probe_fwd_exp, probe_fwd_exp_renorm): the kernel
// expdomain_kernel<Kind>.
//
// What bounds them on this card: each streams one [T, L, B] f32 tensor in
// and one [T, L_pad, B] out (noout: one row in CHUNK) with a handful of
// flops per cell, so the floor is bytes over HBM bandwidth (T=128, B=1024,
// L=157 -> 160: 82.3 + 83.9 = 166.2 MB, 49.6 us at 3.35 TB/s).  The
// recursion is sequential in T, so each block walks T dependent steps, and
// a step that waits for device memory costs a full HBM latency.
//
// Layout, shared by both families (the probes' point is that variants
// differ only in the body): one block holds kTileB = 8 consecutive samples
// b across its x lanes and a column of threads across the label rows l
// (rows strided by the column's height).  A warp is 8 samples x 4 rows, so
// each row access is one full 32-byte sector of [t, l, b0:b0+8]; B / 8 =
// 128 blocks at the bench shape, one per SM (32-wide tiles would leave 100
// of 132 SMs idle).  The block walks all of T itself: the carried [L_pad x
// 8] slab lives in a shared-memory double buffer, so each step costs one
// __syncthreads and the l-1 read never races the next row's write.
//
// The em ring (fwd_ops_kernel, the skeleton of rows 9a-9g): em is staged
// kDepth steps ahead, as the TPU probe's BlockSpec double-buffers em
// blocks into VMEM ahead of the compute.  Shared memory holds a ring of
// kDepth [L_pad x 8] f32 slots (L_pad * 32 bytes each, 5.0 KB at L_pad
// 160).  Before step t computes, each thread issues 4-byte cp.async copies
// of step t + kDepth - 1 into the slot step t - 1 read, commits one group
// per step (empty past T, so the count stays uniform), and waits until at
// most kDepth - 1 groups are in flight, i.e. until step t's group has
// landed.  So every em value a step reads came into shared memory through
// a cp.async issued kDepth - 1 steps earlier; no em load from device
// memory sits inside the dependent step.  Each thread copies exactly the
// cells it later reads, so its own cp.async.wait_group makes them visible
// and no extra barrier is needed; the step's one __syncthreads orders the
// slot's reuse.  Ring cells of rows l >= L and lanes b >= B are zeroed once
// and never copied into (the JAX probe's _widen; those lanes store
// nothing).  4-byte copies take any B and any L: rows need not be 16-byte
// aligned.  Stores go straight from registers as full 32-byte sectors.
//
// Depth: Little's law at 3.35 TB/s over 132 SMs with about 1 us of
// latency wants ~25 KB in flight per SM, i.e. kDepth - 1 >= 5 slots at
// L_pad 160.  The kernel is built for kDepth 8 and 2 (a power of two, so a
// slot is t & (kDepth - 1), and the wait takes an immediate); the wrapper
// (ops/probe_cuda.py::ring_plan) passes the depth with the shared-memory
// bytes: 8 wherever eight slots fit beside the slab in 227 KB (L_pad up to
// 720; 40 KB of ring, 35 KB in flight, plus the 10 KB slab at the bench
// shape), else 2, whose one slot in flight is then 23 KB or more (L_pad
// 728 to 1816).  The launch refuses any other depth.
//
// Rows per thread: kRingRows = 64 threads per column, 16 warps, 2-3 rows
// each at L_pad 160.  A step's fixed work (the wait, the barrier, the
// loop) is paid per warp and a row's per row, while the lse chain wants
// warps to hide its latency.  Timed side by side on the H100 at the bench
// shape (python -m ctc_tpu_torch.probes.ring_sweep): 32 threads ran copy
// and add 50-70% slower; 64, 80 and 128 ran them within 5% of each other;
// lse was 4% faster at 80 (exactly two rows a thread at L_pad 160 only)
// and 9% slower at 128.  64 is kept: a power of two with no shape behind
// it.  Each thread's rows, their device-memory offsets and its output row
// are set up once and bumped by constant strides, so a step spends no
// instructions on 64-bit index arithmetic.
//
// expdomain_kernel keeps the earlier skeleton: it still loads em from
// device memory inside the dependent step, after the previous barrier.
//
// Numerics are the JAX probes': the -1e13 sentinel, jnp.logaddexp's select
// on isnan(a - s), expf / log1pf / fmaxf, and no fast-math.  The
// exp-renorm variant stores each row before the renormalization and, at
// every chunk's end, divides the carry by its per-column max over all
// L_pad rows (1 where that max is <= 0): a two-level reduction, each
// thread's rows then the 32 partials in shared memory, with two extra
// barriers once per chunk.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNeg = -1.0e13f;
constexpr int kTileB = 8;
constexpr int kRowThreads = 32;  // expdomain_kernel's row threads
constexpr int kRingRows = 64;    // fwd_ops_kernel's row threads

enum class Body { kCopy, kAdd, kRoll, kLse, kLseManual, kLseExp2 };
enum class Kind { kLog, kExp, kExpRenorm };

// jnp.logaddexp: max + log1p(exp(-|a - s|)), and a + s where a - s is NaN
__device__ __forceinline__ float logaddexp(float a, float s) {
  const float d = a - s;
  if (isnan(d)) return a + s;
  return fmaxf(a, s) + log1pf(expf(-fabsf(d)));
}

// One 4-byte asynchronous copy, device memory -> shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned dst_s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst_s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// out[t, l, b] = alpha_t[l, b] (kNoOut: out[t / chunk, l, b] at every
// chunk's last step t only), with alpha(-1) = 0 at l = 0 and the sentinel
// elsewhere, e = em[t, l, b] (0 for l >= L), s[l] = alpha[l - 1] and
// s[0] = the sentinel:
//   copy       alpha = e
//   add        alpha = alpha + e
//   roll       alpha = max(alpha, s) + e
//   lse        alpha = logaddexp(alpha, s) + e
//   lse_manual alpha = max(alpha, s) + log1p(exp(-|alpha - s|)) + e
//   lse_exp2   alpha = max(alpha, s) + exp(-|alpha - s|) + e
template <Body kBody, bool kNoOut, int kDepth>
__global__ void __launch_bounds__(kTileB * kRingRows)
    fwd_ops_kernel(const float* __restrict__ em, float* __restrict__ out,
                   int T, int L, int L_pad, int B, int chunk) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  extern __shared__ float smem[];  // [2][L_pad][kTileB] slab, then the
                                   // [kDepth][L_pad][kTileB] em ring
  constexpr int kRowStep = kRingRows * kTileB;  // a thread's next row
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.x * kTileB + tx;
  const bool col = b < B;
  const int cells = L_pad * kTileB;  // one slab or ring slot
  // this thread's rows are l = ty + k * kRingRows: n_rows below L_pad,
  // n_load of them below L (none off the batch)
  const int n_rows = ty < L_pad ? (L_pad - 1 - ty) / kRingRows + 1 : 0;
  const int n_load = col && ty < L ? (L - 1 - ty) / kRingRows + 1 : 0;
  const size_t row_stride = static_cast<size_t>(kRingRows) * B;
  const size_t in_stride = static_cast<size_t>(L) * B;
  const size_t out_stride = static_cast<size_t>(L_pad) * B;
  float* slab = smem + ty * kTileB + tx;  // this thread's first cell
  float* ring = smem + 2 * cells + ty * kTileB + tx;

  // the next unstaged step's em cells of this thread -> its ring slot, as
  // one group (empty past T, so every step commits one)
  const float* src = em + static_cast<size_t>(ty) * B + b;
  int staged = 0;
  auto stage = [&]() {
    if (staged < T) {
      float* slot = ring + (staged & (kDepth - 1)) * cells;
      const float* p = src;
      for (int k = 0; k < n_load; ++k) {
        cp_async4(slot + k * kRowStep, p);
        p += row_stride;
      }
      src += in_stride;
    }
    cp_async_commit();
    ++staged;
  };

  for (int k = 0; k < n_rows; ++k) {
    slab[k * kRowStep] = (ty == 0 && k == 0) ? 0.0f : kNeg;
    if (k >= n_load) {
      for (int s = 0; s < kDepth; ++s) ring[s * cells + k * kRowStep] = 0.0f;
    }
  }
  for (int s = 0; s + 1 < kDepth; ++s) stage();
  __syncthreads();
  float* dst = out + static_cast<size_t>(ty) * B + b;
  int until_store = chunk;  // steps left in this chunk (kNoOut)
  for (int t = 0; t < T; ++t) {
    stage();                         // step t + kDepth - 1
    cp_async_wait<kDepth - 1>();     // step t's group has landed
    const float* cur = slab + (t & 1) * cells;
    float* nxt = slab + ((t + 1) & 1) * cells;
    const float* e_t = ring + (t & (kDepth - 1)) * cells;
    bool advance = true;  // out's next row after this step
    if constexpr (kNoOut) {
      advance = --until_store == 0;
      if (advance) until_store = chunk;
    }
    const bool store = col && advance;
    float* o = dst;
    for (int k = 0; k < n_rows; ++k) {
      const int c = k * kRowStep;
      const float e = e_t[c];
      const float a = cur[c];
      float v;
      if constexpr (kBody == Body::kCopy) {
        v = e;
      } else if constexpr (kBody == Body::kAdd) {
        v = a + e;
      } else {
        const float s = (ty == 0 && k == 0) ? kNeg : cur[c - kTileB];
        if constexpr (kBody == Body::kRoll) {
          v = fmaxf(a, s) + e;
        } else if constexpr (kBody == Body::kLse) {
          v = logaddexp(a, s) + e;
        } else if constexpr (kBody == Body::kLseManual) {
          v = fmaxf(a, s) + log1pf(expf(-fabsf(a - s))) + e;
        } else {
          v = fmaxf(a, s) + expf(-fabsf(a - s)) + e;
        }
      }
      nxt[c] = v;
      if (store) *o = v;
      o += row_stride;
    }
    if (advance) dst += out_stride;
    __syncthreads();
  }
}

// em [T, L_pad, B], outside [L_pad, B] (a cell is outside where > 0.5);
// out[t] = the row computed at step t.  s[l] = alpha[l - 1], 0 (exp) or
// the sentinel (log) at l = 0 and at t = 0.
//   log        alpha(-1) = 0 at l = 0, the sentinel elsewhere;
//              alpha = (outside ? sentinel : logaddexp(alpha, s)) + em[t]
//   exp        A(-1) = 1 at l = 0, 0 elsewhere;
//              A = outside ? 0 : (A + s) * exp(em[t])
//   exp_renorm as exp; after each chunk's last step the carry (not the
//              stored row) is divided by its column max, 1 where <= 0
template <Kind kKind>
__global__ void expdomain_kernel(const float* __restrict__ em,
                                 const float* __restrict__ outside,
                                 float* __restrict__ out, int T, int L_pad,
                                 int B, int chunk) {
  extern __shared__ float smem[];  // [2][L_pad][kTileB] slab,
                                   // [L_pad][kTileB] mask, [32][kTileB]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.x * kTileB + tx;
  const bool col = b < B;
  const size_t stride = static_cast<size_t>(L_pad) * B;
  const int rows = L_pad * kTileB;
  float* slab = smem;
  float* mask = smem + 2 * rows;
  float* partial = mask + rows;
  constexpr bool kLog = kKind == Kind::kLog;
  constexpr float kZero = kLog ? kNeg : 0.0f;  // what "no source" holds

  for (int l = ty; l < L_pad; l += kRowThreads) {
    slab[l * kTileB + tx] = (l == 0) ? (kLog ? 0.0f : 1.0f) : kZero;
    mask[l * kTileB + tx] =
        col ? outside[static_cast<size_t>(l) * B + b] : 1.0f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = slab + (t & 1) * rows;
    float* nxt = slab + ((t + 1) & 1) * rows;
    const float* em_t = em + t * stride;
    float* out_t = out + t * stride;
    float col_max = -CUDART_INF_F;
    for (int l = ty; l < L_pad; l += kRowThreads) {
      const float e = col ? em_t[static_cast<size_t>(l) * B + b] : 0.0f;
      const float a = cur[l * kTileB + tx];
      const float s = (l == 0 || t == 0) ? kZero : cur[(l - 1) * kTileB + tx];
      const bool out_l = mask[l * kTileB + tx] > 0.5f;
      float v;
      if constexpr (kLog) {
        const float lse = out_l ? kNeg : logaddexp(a, s);
        v = lse + e;
      } else {
        const float ex = expf(e);
        v = (a + s) * ex;
        if (out_l) v = 0.0f;
        col_max = fmaxf(col_max, v);
      }
      nxt[l * kTileB + tx] = v;
      if (col) out_t[static_cast<size_t>(l) * B + b] = v;
    }
    __syncthreads();
    if constexpr (kKind == Kind::kExpRenorm) {
      if ((t + 1) % chunk == 0) {
        partial[ty * kTileB + tx] = col_max;
        __syncthreads();
        float m = partial[tx];
        for (int r = 1; r < kRowThreads; ++r) {
          m = fmaxf(m, partial[r * kTileB + tx]);
        }
        const float scale = m > 0.0f ? m : 1.0f;
        for (int l = ty; l < L_pad; l += kRowThreads) {
          nxt[l * kTileB + tx] = nxt[l * kTileB + tx] / scale;
        }
        __syncthreads();
      }
    }
  }
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <Body kBody, bool kNoOut, int kDepth>
cudaError_t launch_ring(const float* em, float* out, int T, int L, int L_pad,
                        int B, int chunk, int smem, cudaStream_t stream) {
  const size_t need =
      (kDepth + 2) * static_cast<size_t>(L_pad) * kTileB * sizeof(float);
  if (smem < 0 || static_cast<size_t>(smem) < need) {
    return cudaErrorInvalidValue;
  }
  const void* kernel =
      reinterpret_cast<const void*>(fwd_ops_kernel<kBody, kNoOut, kDepth>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kTileB, kRingRows);
  const dim3 grid((B + kTileB - 1) / kTileB);
  fwd_ops_kernel<kBody, kNoOut, kDepth><<<grid, block, smem, stream>>>(
      em, out, T, L, L_pad, B, chunk);
  return cudaGetLastError();
}

// depth: the em ring's slots (8 or 2); smem: the bytes the caller
// planned for the slab and the ring, (depth + 2) * L_pad * kTileB * 4
template <Body kBody, bool kNoOut>
cudaError_t launch_fwd_ops(const float* em, float* out, int T, int L,
                           int L_pad, int B, int chunk, int depth, int smem,
                           cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L_pad <= 0) return cudaSuccess;
  if (L > L_pad || chunk <= 0) return cudaErrorInvalidValue;
  switch (depth) {
    case 2:
      return launch_ring<kBody, kNoOut, 2>(em, out, T, L, L_pad, B, chunk,
                                           smem, stream);
    case 8:
      return launch_ring<kBody, kNoOut, 8>(em, out, T, L, L_pad, B, chunk,
                                           smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <Kind kKind>
cudaError_t launch_expdomain(const float* em, const float* outside,
                             float* out, int T, int L_pad, int B, int chunk,
                             cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L_pad <= 0) return cudaSuccess;
  if (chunk <= 0) return cudaErrorInvalidValue;
  const size_t smem =
      (3 * static_cast<size_t>(L_pad) + kRowThreads) * kTileB * sizeof(float);
  const void* kernel = reinterpret_cast<const void*>(expdomain_kernel<kKind>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kTileB, kRowThreads);
  const dim3 grid((B + kTileB - 1) / kTileB);
  expdomain_kernel<kKind><<<grid, block, smem, stream>>>(em, outside, out, T,
                                                         L_pad, B, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// em [T, L, B] -> out [T, L_pad, B] through a ring of `depth` slots in
// `smem` bytes of shared memory (ops/probe_cuda.py::ring_plan)
cudaError_t probe_copy(const float* em, float* out, int T, int L,
                       int L_pad, int B, int depth, int smem,
                       cudaStream_t stream) {
  return launch_fwd_ops<Body::kCopy, false>(em, out, T, L, L_pad, B, 1,
                                            depth, smem, stream);
}

cudaError_t probe_add(const float* em, float* out, int T, int L,
                      int L_pad, int B, int depth, int smem,
                      cudaStream_t stream) {
  return launch_fwd_ops<Body::kAdd, false>(em, out, T, L, L_pad, B, 1,
                                           depth, smem, stream);
}

cudaError_t probe_roll(const float* em, float* out, int T, int L,
                       int L_pad, int B, int depth, int smem,
                       cudaStream_t stream) {
  return launch_fwd_ops<Body::kRoll, false>(em, out, T, L, L_pad, B, 1,
                                            depth, smem, stream);
}

cudaError_t probe_lse(const float* em, float* out, int T, int L,
                      int L_pad, int B, int depth, int smem,
                      cudaStream_t stream) {
  return launch_fwd_ops<Body::kLse, false>(em, out, T, L, L_pad, B, 1,
                                           depth, smem, stream);
}

cudaError_t probe_lse_manual(const float* em, float* out, int T, int L,
                             int L_pad, int B, int depth, int smem,
                             cudaStream_t stream) {
  return launch_fwd_ops<Body::kLseManual, false>(em, out, T, L, L_pad, B, 1,
                                                 depth, smem, stream);
}

cudaError_t probe_lse_exp2(const float* em, float* out, int T, int L,
                           int L_pad, int B, int depth, int smem,
                           cudaStream_t stream) {
  return launch_fwd_ops<Body::kLseExp2, false>(em, out, T, L, L_pad, B, 1,
                                               depth, smem, stream);
}

// em [T, L, B] -> out [T / chunk, L_pad, B]; T a multiple of chunk
cudaError_t probe_noout(const float* em, float* out, int T, int L, int L_pad,
                        int B, int chunk, int depth, int smem,
                        cudaStream_t stream) {
  if (chunk <= 0 || T % chunk != 0) return cudaErrorInvalidValue;
  return launch_fwd_ops<Body::kLse, true>(em, out, T, L, L_pad, B, chunk,
                                          depth, smem, stream);
}

// em [T, L_pad, B], outside [L_pad, B] -> out [T, L_pad, B]
cudaError_t probe_fwd_log(const float* em, const float* outside, float* out,
                          int T, int L_pad, int B, cudaStream_t stream) {
  return launch_expdomain<Kind::kLog>(em, outside, out, T, L_pad, B, 1,
                                      stream);
}

cudaError_t probe_fwd_exp(const float* em, const float* outside, float* out,
                          int T, int L_pad, int B, cudaStream_t stream) {
  return launch_expdomain<Kind::kExp>(em, outside, out, T, L_pad, B, 1,
                                      stream);
}

cudaError_t probe_fwd_exp_renorm(const float* em, const float* outside,
                                 float* out, int T, int L_pad, int B,
                                 int chunk, cudaStream_t stream) {
  return launch_expdomain<Kind::kExpRenorm>(em, outside, out, T, L_pad, B,
                                            chunk, stream);
}

}  // extern "C"
