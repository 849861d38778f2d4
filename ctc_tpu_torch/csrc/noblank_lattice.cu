// Blank-free CTC lattice: forward (alpha) and backward (d nll / d em)
// kernels for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (ctypes).  Layout is [T, B, L] ("tbl"), float32, contiguous.
//
// Replaces ctc_tpu/ops/lattice_pallas.py:_forward_kernel and
// ctc_tpu/ops/lattice_pallas.py:_backward_kernel (the whole lattice), and
// ctc_tpu/ops/lattice_pallas.py:_forward_kernel_boundary and
// ctc_tpu/ops/lattice_pallas.py:_backward_kernel_boundary (one T-shard of the
// sequence-parallel pipeline, entry points noblank_shard_*).
//
// What bounds them on this card: each kernel streams one [T, B, L] f32
// tensor in and one out (em -> alpha, alpha -> g) and does ~10 flops and
// two transcendentals per cell, so the floor is bytes over HBM bandwidth
// (T=128, B=1024, L=157: 2 x 82.3 MB, ~49 us at 3.35 TB/s).  The recursion
// is sequential in T, so the real limit at small B is the latency of T
// dependent steps inside one block.
//
// Design: one thread block per sample b, threads across the label
// positions l (strided when L exceeds the block).  The block walks all of T
// itself: the carried row lives in a shared-memory double buffer, so each
// step costs one __syncthreads and the l-1 / l+1 neighbour read never races
// the write of the next row.  Row reads and writes of [t, b, :] are
// contiguous in l, so every warp's access is coalesced.  Many samples (B
// blocks, ~10 resident per SM at L=157) are in flight at once, which is
// what hides each step's load latency.  Numerics follow the JAX package: the -1e13 sentinel, a sentinel
// advance at t=0, logaddexp as max + log1p(exp(-|a-b|)), the outside mask
// applied before the emission add, and sigmoid branch weights in the
// backward (degenerate lattices need the exact 1/2, 1/2 split).
//
// The shard kernels are the same loops with the lattice's two boundaries
// handed in (kShard = true): the carry starts from the row stay0[b] instead
// of the l = 0 init, the advance source of local t = 0 is the row adv0[b]
// (shifted; there is no t > 0 gate), the backward adds the cotangent of the
// outgoing boundary row, g_seed[b], at the last local row, and the final
// cell is injected with +bar (the op returns the final log-prob, not the
// NLL).  On shard 0 the pipeline passes the l = 0 init as stay0 and the
// all-sentinel row as adv0, which reproduces the whole-lattice kernel's
// t = 0 step exactly.

#include <cuda_runtime.h>

namespace {

constexpr float kNegSentinel = -1.0e13f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// alpha[t, b, l] = em[t, b, l]
//     + (l >= tgt[b] ? -1e13 : logaddexp(alpha[t-1, b, l], alpha[t-1, b, l-1]))
// with alpha(-1) = 0 at l = 0 and the sentinel elsewhere; no advance at t=0.
// kShard: alpha(-1) = stay0[b], and the advance source at t = 0 is adv0[b].
template <bool kShard>
__global__ void noblank_forward_kernel(const float* __restrict__ em,
                                       const int* __restrict__ tgt,
                                       const float* __restrict__ stay0,
                                       const float* __restrict__ adv0,
                                       float* __restrict__ alpha, int T, int B,
                                       int L) {
  extern __shared__ float rows[];  // [2][L]
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const size_t row_stride = static_cast<size_t>(B) * L;
  const float* em_b = em + static_cast<size_t>(b) * L;
  float* alpha_b = alpha + static_cast<size_t>(b) * L;

  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    if constexpr (kShard) {
      rows[l] = stay0[static_cast<size_t>(b) * L + l];
    } else {
      rows[l] = (l == 0) ? 0.0f : kNegSentinel;
    }
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = rows + (t & 1) * L;
    float* nxt = rows + ((t + 1) & 1) * L;
    const float* em_t = em_b + static_cast<size_t>(t) * row_stride;
    float* alpha_t = alpha_b + static_cast<size_t>(t) * row_stride;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const float e = em_t[l];
      const float stay = cur[l];
      float adv = kNegSentinel;
      if (l > 0) {
        if (t > 0) {
          adv = cur[l - 1];
        } else if constexpr (kShard) {
          adv = adv0[static_cast<size_t>(b) * L + l - 1];
        }
      }
      float lse = logaddexp(stay, adv);
      if (l >= tgt_b) lse = kNegSentinel;
      const float a = lse + e;
      alpha_t[l] = a;
      nxt[l] = a;
    }
    __syncthreads();
  }
}

// Reverse recursion over the lattice:
//   g[t, l] = inject[t, l] + g[t+1, l] * w_stay(t, l)
//             + g[t+1, l+1] * w_adv(t, l+1)
// with w_stay(t, l) = sigmoid(alpha[t, l] - alpha[t, l-1]) * inside(l),
// w_adv = (1 - sigmoid(...)) * inside(l), and inject = -bar[b] at
// (inlen[b]-1, tgt[b]-1).  g is zero above the last row, so every row at or
// past inlen[b] comes out exactly 0.
// kShard: inject = +bar[b] (inlen is shard-local, so a shard that does not
// own the final cell injects nothing), and g_seed[b] is added at t = T-1.
template <bool kShard>
__global__ void noblank_backward_kernel(const float* __restrict__ alpha,
                                        const int* __restrict__ inlen,
                                        const int* __restrict__ tgt,
                                        const float* __restrict__ bar,
                                        const float* __restrict__ g_seed,
                                        float* __restrict__ g, int T, int B,
                                        int L) {
  extern __shared__ float rows[];  // [2][L]
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float inject_val = kShard ? bar[b] : -bar[b];
  const size_t row_stride = static_cast<size_t>(B) * L;
  const float* alpha_b = alpha + static_cast<size_t>(b) * L;
  float* g_b = g + static_cast<size_t>(b) * L;

  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    rows[l] = 0.0f;
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const int step = T - 1 - t;
    const float* g_next = rows + (step & 1) * L;
    float* g_cur = rows + ((step + 1) & 1) * L;
    const float* alpha_t = alpha_b + static_cast<size_t>(t) * row_stride;
    float* g_t = g_b + static_cast<size_t>(t) * row_stride;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      float inject =
          (t == t_inject && l == tgt_b - 1) ? inject_val : 0.0f;
      if constexpr (kShard) {
        if (t == T - 1) inject += g_seed[static_cast<size_t>(b) * L + l];
      }
      float prop = 0.0f;
      if (t < T - 1) {
        const float a_l = alpha_t[l];
        const float a_lm1 = (l > 0) ? alpha_t[l - 1] : kNegSentinel;
        const float in_l = (l < tgt_b) ? 1.0f : 0.0f;
        const float w_l = sigmoid(a_l - a_lm1);
        const float stay = g_next[l] * (w_l * in_l);
        float from_adv = 0.0f;
        if (l + 1 < L) {
          const float a_lp1 = alpha_t[l + 1];
          const float in_lp1 = (l + 1 < tgt_b) ? 1.0f : 0.0f;
          const float w_lp1 = sigmoid(a_lp1 - a_l);
          from_adv = g_next[l + 1] * ((1.0f - w_lp1) * in_lp1);
        }
        prop = stay + from_adv;
      }
      const float v = inject + prop;
      g_t[l] = v;
      g_cur[l] = v;
    }
    __syncthreads();
  }
}

int block_threads(int L) {
  int threads = ((L + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <bool kShard>
cudaError_t launch_forward(const float* em, const int* tgt, const float* stay0,
                           const float* adv0, float* alpha, int T, int B,
                           int L, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(float);
  cudaError_t err = prepare(
      reinterpret_cast<const void*>(noblank_forward_kernel<kShard>), smem);
  if (err != cudaSuccess) return err;
  noblank_forward_kernel<kShard><<<B, block_threads(L), smem, stream>>>(
      em, tgt, stay0, adv0, alpha, T, B, L);
  return cudaGetLastError();
}

template <bool kShard>
cudaError_t launch_backward(const float* alpha, const int* inlen,
                            const int* tgt, const float* bar,
                            const float* g_seed, float* g, int T, int B,
                            int L, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(float);
  cudaError_t err = prepare(
      reinterpret_cast<const void*>(noblank_backward_kernel<kShard>), smem);
  if (err != cudaSuccess) return err;
  noblank_backward_kernel<kShard><<<B, block_threads(L), smem, stream>>>(
      alpha, inlen, tgt, bar, g_seed, g, T, B, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t noblank_lattice_forward(const float* em, const int* tgt,
                                    float* alpha, int T, int B, int L,
                                    cudaStream_t stream) {
  return launch_forward<false>(em, tgt, nullptr, nullptr, alpha, T, B, L,
                               stream);
}

cudaError_t noblank_lattice_backward(const float* alpha, const int* inlen,
                                     const int* tgt, const float* nll_bar,
                                     float* g, int T, int B, int L,
                                     cudaStream_t stream) {
  return launch_backward<false>(alpha, inlen, tgt, nll_bar, nullptr, g, T, B,
                                L, stream);
}

// One T-shard: stay0 / adv0 are [B, L] init rows.
cudaError_t noblank_shard_forward(const float* em, const int* tgt,
                                  const float* stay0, const float* adv0,
                                  float* alpha, int T, int B, int L,
                                  cudaStream_t stream) {
  return launch_forward<true>(em, tgt, stay0, adv0, alpha, T, B, L, stream);
}

// One T-shard: inlen is shard-local, final_bar the cotangent of the final
// log-prob, g_seed [B, L] that of the outgoing boundary row.
cudaError_t noblank_shard_backward(const float* alpha, const int* inlen,
                                   const int* tgt, const float* final_bar,
                                   const float* g_seed, float* g, int T,
                                   int B, int L, cudaStream_t stream) {
  return launch_backward<true>(alpha, inlen, tgt, final_bar, g_seed, g, T, B,
                               L, stream);
}

}  // extern "C"
