// Forward-lattice probes: stripped variants of the blank-free forward
// recursion, for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes).  Layout is the probes' [T, L, B] ("tlb", samples
// innermost), float32, contiguous.  They measure which operation of the
// forward step binds it; no training path runs them.
//
// Replaces probe_fwd_ops.py:make (the six variants "copy", "add", "roll",
// "lse", "lse_manual", "lse_exp2", entry points probe_<variant>) and
// probe_fwd_ops.py:make_noout (entry point probe_noout): the kernel
// fwd_ops_kernel<Body, kNoOut>; and probe_expdomain_fwd.py:fwd_log_kernel,
// :fwd_exp_kernel, :fwd_exp_renorm_kernel (entry points probe_fwd_log,
// probe_fwd_exp, probe_fwd_exp_renorm): the kernel expdomain_kernel<Kind>.
//
// What bounds them on this card: each streams one [T, L, B] f32 tensor in
// and one [T, L_pad, B] out (noout: one row in CHUNK) with a handful of
// flops per cell, so the floor is bytes over HBM bandwidth (T=128, B=1024,
// L=157 -> 160: 82.3 + 83.9 MB, ~50 us at 3.35 TB/s).  The recursion is
// sequential in T, so the real limit is the latency of T dependent steps.
//
// Design, one skeleton for every variant of a family (the probes' point is
// that variants differ only in the body): one block holds kTileB = 8
// consecutive samples b across its x lanes and kRowThreads = 32 threads
// across the label rows l (rows strided by 32).  A warp is 8 samples x 4
// rows, so each row access is one full 32-byte sector of [t, l, b0:b0+8];
// B / 8 = 128 blocks at the bench shape, about one per SM (32-wide tiles
// would leave 100 of 132 SMs idle).  The block walks all of T itself: the
// carried [L_pad x 8] slab lives in a shared-memory double buffer, so each
// step costs one __syncthreads and the l-1 read never races the next
// row's write.  Rows l >= L read 0 (the JAX probe's _widen); lanes b >= B
// compute on zeros and store nothing.  Numerics are the JAX probes': the
// -1e13 sentinel, jnp.logaddexp's select on isnan(a - s), expf / log1pf /
// fmaxf, and no fast-math.  The exp-renorm variant stores each row before
// the renormalization and, at every chunk's end, divides the carry by its
// per-column max over all L_pad rows (1 where that max is <= 0): a
// two-level reduction, each thread's rows then the 32 partials in shared
// memory, with two extra barriers once per chunk.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNeg = -1.0e13f;
constexpr int kTileB = 8;
constexpr int kRowThreads = 32;

enum class Body { kCopy, kAdd, kRoll, kLse, kLseManual, kLseExp2 };
enum class Kind { kLog, kExp, kExpRenorm };

// jnp.logaddexp: max + log1p(exp(-|a - s|)), and a + s where a - s is NaN
__device__ __forceinline__ float logaddexp(float a, float s) {
  const float d = a - s;
  if (isnan(d)) return a + s;
  return fmaxf(a, s) + log1pf(expf(-fabsf(d)));
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
template <Body kBody, bool kNoOut>
__global__ void fwd_ops_kernel(const float* __restrict__ em,
                               float* __restrict__ out, int T, int L,
                               int L_pad, int B, int chunk) {
  extern __shared__ float slab[];  // [2][L_pad][kTileB]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int b = blockIdx.x * kTileB + tx;
  const bool col = b < B;
  const size_t in_stride = static_cast<size_t>(L) * B;
  const size_t out_stride = static_cast<size_t>(L_pad) * B;
  const int rows = L_pad * kTileB;

  for (int l = ty; l < L_pad; l += kRowThreads) {
    slab[l * kTileB + tx] = (l == 0) ? 0.0f : kNeg;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = slab + (t & 1) * rows;
    float* nxt = slab + ((t + 1) & 1) * rows;
    const float* em_t = em + t * in_stride;
    const bool store = !kNoOut || (t + 1) % chunk == 0;
    float* out_t = out + (kNoOut ? t / chunk : t) * out_stride;
    for (int l = ty; l < L_pad; l += kRowThreads) {
      const float e = (col && l < L) ? em_t[static_cast<size_t>(l) * B + b]
                                     : 0.0f;
      const float a = cur[l * kTileB + tx];
      float v;
      if constexpr (kBody == Body::kCopy) {
        v = e;
      } else if constexpr (kBody == Body::kAdd) {
        v = a + e;
      } else {
        const float s = (l == 0) ? kNeg : cur[(l - 1) * kTileB + tx];
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
      nxt[l * kTileB + tx] = v;
      if (col && store) out_t[static_cast<size_t>(l) * B + b] = v;
    }
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

template <Body kBody, bool kNoOut>
cudaError_t launch_fwd_ops(const float* em, float* out, int T, int L,
                           int L_pad, int B, int chunk, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L_pad <= 0) return cudaSuccess;
  if (L > L_pad || chunk <= 0) return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(L_pad) * kTileB * sizeof(float);
  const void* kernel =
      reinterpret_cast<const void*>(fwd_ops_kernel<kBody, kNoOut>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kTileB, kRowThreads);
  const dim3 grid((B + kTileB - 1) / kTileB);
  fwd_ops_kernel<kBody, kNoOut><<<grid, block, smem, stream>>>(
      em, out, T, L, L_pad, B, chunk);
  return cudaGetLastError();
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

// em [T, L, B] -> out [T, L_pad, B]
cudaError_t probe_copy(const float* em, float* out, int T, int L, int L_pad,
                       int B, cudaStream_t stream) {
  return launch_fwd_ops<Body::kCopy, false>(em, out, T, L, L_pad, B, 1,
                                            stream);
}

cudaError_t probe_add(const float* em, float* out, int T, int L, int L_pad,
                      int B, cudaStream_t stream) {
  return launch_fwd_ops<Body::kAdd, false>(em, out, T, L, L_pad, B, 1,
                                           stream);
}

cudaError_t probe_roll(const float* em, float* out, int T, int L, int L_pad,
                       int B, cudaStream_t stream) {
  return launch_fwd_ops<Body::kRoll, false>(em, out, T, L, L_pad, B, 1,
                                            stream);
}

cudaError_t probe_lse(const float* em, float* out, int T, int L, int L_pad,
                      int B, cudaStream_t stream) {
  return launch_fwd_ops<Body::kLse, false>(em, out, T, L, L_pad, B, 1,
                                           stream);
}

cudaError_t probe_lse_manual(const float* em, float* out, int T, int L,
                             int L_pad, int B, cudaStream_t stream) {
  return launch_fwd_ops<Body::kLseManual, false>(em, out, T, L, L_pad, B, 1,
                                                 stream);
}

cudaError_t probe_lse_exp2(const float* em, float* out, int T, int L,
                           int L_pad, int B, cudaStream_t stream) {
  return launch_fwd_ops<Body::kLseExp2, false>(em, out, T, L, L_pad, B, 1,
                                               stream);
}

// em [T, L, B] -> out [T / chunk, L_pad, B]; T a multiple of chunk
cudaError_t probe_noout(const float* em, float* out, int T, int L, int L_pad,
                        int B, int chunk, cudaStream_t stream) {
  if (chunk <= 0 || T % chunk != 0) return cudaErrorInvalidValue;
  return launch_fwd_ops<Body::kLse, true>(em, out, T, L, L_pad, B, chunk,
                                          stream);
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
