// Blank CTC lattice over the blank-expanded sequence z = [b, l1, b, ..., b]
// of S = 2L+1 slots: forward (alpha) and backward (d nll / d em) kernels for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
// Layout is [T, B, S] ("tbl"), float32, contiguous; skip_ok is [B, S] uint8.
//
// Replaces ctc_tpu/ops/blank_lattice_pallas.py:_forward_kernel and
// ctc_tpu/ops/blank_lattice_pallas.py:_backward_kernel (the whole lattice),
// and ctc_tpu/ops/blank_lattice_pallas.py:_forward_kernel_boundary and
// ctc_tpu/ops/blank_lattice_pallas.py:_backward_kernel_boundary (one T-shard
// of the sequence-parallel pipeline, entry points blank_shard_*).
//
// What bounds them on this card: each kernel streams one [T, B, S] f32
// tensor in and one out (em -> alpha, alpha -> g) plus a [B, S] byte mask,
// and does a few dozen flops per cell, so the floor is bytes over HBM
// bandwidth (T=128, B=1024, S=41: 2 x 21.5 MB, ~13 us at 3.35 TB/s).  The
// recursion is sequential in T, so at small B the real limit is the latency
// of T dependent steps inside one block.
//
// Design (that of noblank_lattice.cu): one thread block per sample b,
// threads across the slots s (strided when S exceeds the block).  The block
// walks all of T itself; the carried row lives in a shared-memory double
// buffer, so each step costs one __syncthreads and the s-1 / s-2 (forward)
// and s+1 / s+2 (backward) neighbour reads never race the write of the next
// row.  The sample's skip row is staged in shared memory once.  Row reads
// and writes of [t, b, :] are contiguous in s, so warps coalesce.
//
// Numerics follow the JAX package: the -1e30 sentinel, alpha(-1) = 0 at
// s = 0 and the sentinel elsewhere, the skip branch off at t = 0, the
// three-way log-add as logaddexp(logaddexp(stay, adv), skip) with
// logaddexp = max + log1p(exp(-|a-b|)), and no validity mask (transitions
// only move to higher s, so cells past 2L_b never feed the cells the loss
// reads, and their gradient stays exactly 0).  The backward's branch
// weights are exp(source - lse) with every masked source at the sentinel,
// exactly as the XLA scan's autodiff and the Pallas kernel compute them.
//
// The shard kernels are the same loops with the lattice's two boundaries
// handed in (kShard = true): the carry starts from the row init0[b], the
// skip source of local t = 0 is the row skip0[b] (the carry at every later
// step), the backward adds the cotangent of the outgoing boundary row,
// g_seed[b], at the last local row, and the final cells are injected with
// +bar times their softmax (the op returns the final log-prob).  On shard 0
// the pipeline passes the virtual alpha(-1) row as init0 and the
// all-sentinel row as skip0, which reproduces the t = 0 skip gate exactly.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1.0e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float logaddexp3(float stay, float adv,
                                            float skip) {
  return logaddexp(logaddexp(stay, adv), skip);
}

// alpha[t, b, s] = em[t, b, s] + logaddexp3(alpha[t-1, b, s],
//     alpha[t-1, b, s-1], skip_ok[b, s] && t > 0 ? alpha[t-1, b, s-2] : NEG)
// with alpha(-1) = 0 at s = 0 and NEG elsewhere.
// kShard: alpha(-1) = init0[b], and the skip source at t = 0 is skip0[b].
template <bool kShard>
__global__ void blank_forward_kernel(const float* __restrict__ em,
                                     const unsigned char* __restrict__ skip,
                                     const float* __restrict__ init0,
                                     const float* __restrict__ skip0,
                                     float* __restrict__ alpha, int T, int B,
                                     int S) {
  extern __shared__ float rows[];  // [2][S] floats, then [S] skip bytes
  unsigned char* skip_sh = reinterpret_cast<unsigned char*>(rows + 2 * S);
  const int b = blockIdx.x;
  const size_t row_stride = static_cast<size_t>(B) * S;
  const float* em_b = em + static_cast<size_t>(b) * S;
  float* alpha_b = alpha + static_cast<size_t>(b) * S;
  const unsigned char* skip_b = skip + static_cast<size_t>(b) * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    if constexpr (kShard) {
      rows[s] = init0[static_cast<size_t>(b) * S + s];
    } else {
      rows[s] = (s == 0) ? 0.0f : kNeg;
    }
    skip_sh[s] = skip_b[s];
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = rows + (t & 1) * S;
    float* nxt = rows + ((t + 1) & 1) * S;
    const float* em_t = em_b + static_cast<size_t>(t) * row_stride;
    float* alpha_t = alpha_b + static_cast<size_t>(t) * row_stride;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float e = em_t[s];
      const float stay = cur[s];
      const float adv = (s >= 1) ? cur[s - 1] : kNeg;
      float skp = kNeg;
      if (s >= 2 && skip_sh[s]) {
        if (t > 0) {
          skp = cur[s - 2];
        } else if constexpr (kShard) {
          skp = skip0[static_cast<size_t>(b) * S + s - 2];
        }
      }
      const float a = logaddexp3(stay, adv, skp) + e;
      alpha_t[s] = a;
      nxt[s] = a;
    }
    __syncthreads();
  }
}

// Reverse occupancy recursion:
//   g[t, s] = inject[t, s] + g[t+1, s] * w_stay(s) + g[t+1, s+1] * w_adv(s+1)
//             + g[t+1, s+2] * w_skip(s+2)
// where the weights of target cell s' are the softmax of its three source
// scores read off alpha[t] (the step into t+1, so no t > 0 gate on skip).
// inject = -nll_bar[b] * softmax(final two cells) at t = inlen[b] - 1, on
// s = 2 tgt[b] and (tgt[b] > 0) s = 2 tgt[b] - 1.  g is zero above the last
// row, so every row at or past inlen[b] comes out exactly 0.
// kShard: the inject is +bar[b] times the softmax (inlen is shard-local, so a
// shard that does not own the final cells injects nothing), and g_seed[b]
// is added at t = T-1.
template <bool kShard>
__global__ void blank_backward_kernel(const float* __restrict__ alpha,
                                      const unsigned char* __restrict__ skip,
                                      const int* __restrict__ inlen,
                                      const int* __restrict__ tgt,
                                      const float* __restrict__ nll_bar,
                                      const float* __restrict__ g_seed,
                                      float* __restrict__ g, int T, int B,
                                      int S) {
  extern __shared__ float rows[];  // [2][S] floats, then [S] skip bytes
  unsigned char* skip_sh = reinterpret_cast<unsigned char*>(rows + 2 * S);
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float bar = kShard ? nll_bar[b] : -nll_bar[b];
  const size_t row_stride = static_cast<size_t>(B) * S;
  const float* alpha_b = alpha + static_cast<size_t>(b) * S;
  float* g_b = g + static_cast<size_t>(b) * S;
  const unsigned char* skip_b = skip + static_cast<size_t>(b) * S;

  // the final-cell injection; every thread reads the same two cells
  const int t_f = min(max(t_inject, 0), T - 1);
  const int s_a = min(max(2 * tgt_b, 0), S - 1);
  const int s_b = min(max(2 * tgt_b - 1, 0), S - 1);
  const float* alpha_f = alpha_b + static_cast<size_t>(t_f) * row_stride;
  const float a_a = alpha_f[s_a];
  const float a_b = alpha_f[s_b];
  const float lse_f = (tgt_b > 0) ? logaddexp(a_a, a_b) : a_a;
  const float inj_a = bar * expf(a_a - lse_f);
  const float inj_b = (tgt_b > 0) ? bar * expf(a_b - lse_f) : 0.0f;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    rows[s] = 0.0f;
    skip_sh[s] = skip_b[s];
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const int step = T - 1 - t;
    const float* g_next = rows + (step & 1) * S;
    float* g_cur = rows + ((step + 1) & 1) * S;
    const float* alpha_t = alpha_b + static_cast<size_t>(t) * row_stride;
    float* g_t = g_b + static_cast<size_t>(t) * row_stride;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float inject = 0.0f;
      if (t == t_inject) {
        inject = ((s == s_a) ? inj_a : 0.0f) +
                 ((tgt_b > 0 && s == s_b) ? inj_b : 0.0f);
      }
      if constexpr (kShard) {
        if (t == T - 1) inject += g_seed[static_cast<size_t>(b) * S + s];
      }
      float prop = 0.0f;
      if (t < T - 1) {
        const float a_0 = alpha_t[s];
        const float a_m1 = (s >= 1) ? alpha_t[s - 1] : kNeg;
        const float a_m2 = (s >= 2) ? alpha_t[s - 2] : kNeg;
        // cell s: stay weight
        const float lse_0 =
            logaddexp3(a_0, a_m1, (s >= 2 && skip_sh[s]) ? a_m2 : kNeg);
        const float stay = g_next[s] * expf(a_0 - lse_0);
        // cell s+1: the weight of its advance source, s
        float from_adv = 0.0f;
        float a_p1 = kNeg;
        if (s + 1 < S) {
          a_p1 = alpha_t[s + 1];
          const float lse_p1 = logaddexp3(
              a_p1, a_0, (s + 1 >= 2 && skip_sh[s + 1]) ? a_m1 : kNeg);
          from_adv = g_next[s + 1] * expf(a_0 - lse_p1);
        }
        // cell s+2: the weight of its skip source, s
        float from_skip = 0.0f;
        if (s + 2 < S) {
          const float a_p2 = alpha_t[s + 2];
          const float a_skip = skip_sh[s + 2] ? a_0 : kNeg;
          const float lse_p2 = logaddexp3(a_p2, a_p1, a_skip);
          from_skip = g_next[s + 2] * expf(a_skip - lse_p2);
        }
        prop = (stay + from_adv) + from_skip;
      }
      const float v = inject + prop;
      g_t[s] = v;
      g_cur[s] = v;
    }
    __syncthreads();
  }
}

int block_threads(int S) {
  int threads = ((S + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

size_t shared_bytes(int S) {
  return 2 * static_cast<size_t>(S) * sizeof(float) + static_cast<size_t>(S);
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
cudaError_t launch_forward(const float* em, const unsigned char* skip,
                           const float* init0, const float* skip0,
                           float* alpha, int T, int B, int S,
                           cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaSuccess;
  const size_t smem = shared_bytes(S);
  cudaError_t err = prepare(
      reinterpret_cast<const void*>(blank_forward_kernel<kShard>), smem);
  if (err != cudaSuccess) return err;
  blank_forward_kernel<kShard><<<B, block_threads(S), smem, stream>>>(
      em, skip, init0, skip0, alpha, T, B, S);
  return cudaGetLastError();
}

template <bool kShard>
cudaError_t launch_backward(const float* alpha, const unsigned char* skip,
                            const int* inlen, const int* tgt,
                            const float* bar, const float* g_seed, float* g,
                            int T, int B, int S, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaSuccess;
  const size_t smem = shared_bytes(S);
  cudaError_t err = prepare(
      reinterpret_cast<const void*>(blank_backward_kernel<kShard>), smem);
  if (err != cudaSuccess) return err;
  blank_backward_kernel<kShard><<<B, block_threads(S), smem, stream>>>(
      alpha, skip, inlen, tgt, bar, g_seed, g, T, B, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t blank_lattice_forward(const float* em, const unsigned char* skip,
                                  float* alpha, int T, int B, int S,
                                  cudaStream_t stream) {
  return launch_forward<false>(em, skip, nullptr, nullptr, alpha, T, B, S,
                               stream);
}

cudaError_t blank_lattice_backward(const float* alpha,
                                   const unsigned char* skip, const int* inlen,
                                   const int* tgt, const float* nll_bar,
                                   float* g, int T, int B, int S,
                                   cudaStream_t stream) {
  return launch_backward<false>(alpha, skip, inlen, tgt, nll_bar, nullptr, g,
                                T, B, S, stream);
}

// One T-shard: init0 / skip0 are [B, S] init rows.
cudaError_t blank_shard_forward(const float* em, const unsigned char* skip,
                                const float* init0, const float* skip0,
                                float* alpha, int T, int B, int S,
                                cudaStream_t stream) {
  return launch_forward<true>(em, skip, init0, skip0, alpha, T, B, S, stream);
}

// One T-shard: inlen is shard-local, final_bar the cotangent of the final
// log-prob, g_seed [B, S] that of the outgoing boundary row.
cudaError_t blank_shard_backward(const float* alpha, const unsigned char* skip,
                                 const int* inlen, const int* tgt,
                                 const float* final_bar, const float* g_seed,
                                 float* g, int T, int B, int S,
                                 cudaStream_t stream) {
  return launch_backward<true>(alpha, skip, inlen, tgt, final_bar, g_seed, g,
                               T, B, S, stream);
}

}  // extern "C"
