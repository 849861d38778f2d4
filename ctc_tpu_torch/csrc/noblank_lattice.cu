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
// The shard forward is the same loop with the lattice's two boundaries
// handed in (kShard = true): the carry starts from the row stay0[b] instead
// of the l = 0 init, and the advance source of local t = 0 is the row
// adv0[b] (shifted; there is no t > 0 gate).  On shard 0 the pipeline
// passes the l = 0 init as stay0 and the all-sentinel row as adv0, which
// reproduces the whole-lattice kernel's t = 0 step exactly.
//
// The shard backward (noblank_shard_backward_kernel) adds the cotangent of
// the outgoing boundary row, g_seed[b], at the last local row, injects the
// final cell with +bar (the op returns the final log-prob, not the NLL),
// and also returns the init rows' gradients.  What binds it is not bytes:
// at the main shard shape [16, 32, 64] and the long-T one [1024, 4, 24] one
// block per sample walks T dependent steps, and in the whole-lattice
// kernel's loop each step first loaded alpha[t] at l-1, l, l+1 from device
// memory, then computed two sigmoids (expf and an IEEE divide) off them,
// and only then did the one multiply-add that needs g[t+1]: 10.8 us and
// 0.659 ms of device time against bounds of 0.09 and 0.24 us (NVIDIA H100
// 80GB HBM3, 700.00 W; python -m ctc_tpu_torch.probes.shard_ab).  Neither
// the load nor the weights depend on the carried row, so the design takes
// both off the chain of dependent steps:
//   - alpha is staged into shared memory by 4-byte cp.async copies, in
//     chunks of kChunk rows walking T downward, two buffers: chunk c+2 is
//     issued into the buffer chunk c leaves while chunk c+1 is in flight.
//     Each thread waits for its own copies; the __syncthreads right after
//     that wait ("publishes chunk c") makes the whole chunk visible to the
//     block, since a weight reads its neighbours' cells.  One barrier per
//     chunk, none per step for the copies.
//   - the branch weights of all the chunk's rows, w_stay and w_adv per
//     cell (one sigmoid each), are computed at once into shared memory as
//     independent work spread over every thread of a 512-thread block
//     (SHARD_THREADS; the kernel ran faster with every doubling of the
//     block up to 512), then one more barrier.  Shared memory, not
//     registers: a thread's step reads the weight of cell l+1, which
//     another thread computed, and rows wider than the block stride over it.
//   - a step then reads g[t+1] at l, l+1 and two weights from shared
//     memory, does the multiply-adds, the inject, the g_seed row at t =
//     T-1, the store of g[t], and one __syncthreads.
//   - the init rows' gradients (ops/lattice_cuda.py::init_row_grads, the
//     plain path's torch ops) are row -1 of the same recursion: row -1's
//     weights read stay0[b] against adv0[b] (staged with chunk 0), and the
//     kernel writes d_stay0 / d_adv0 from g[0] after the last barrier.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; probes/shard_ab.py, median
// of 5 profiler windows): 6.21 us at [16, 32, 64] (10.92 before) and
// 0.2615 ms at [1024, 4, 24] (0.6546 before).  What binds it now is the
// step itself, ~0.26 us each at long T (probes/shard_sweep.py: the store
// of g[t] ~0.04 us of it, the barrier ~0.02).  Builds that stepped rows of
// up to 256 cells in one warp (8 cells a lane in registers, shuffles, no
// barrier), or kept g in a shared ring stored once a chunk and weighted
// row k-1 during step k, ran 1.7-2.0x and 1.1-1.4x slower than this one,
// so the block-wide step stays.
// The plan (ops/lattice_cuda.py::shard_backward_plan) takes kChunk 16 up to
// L = 818, 4 up to 2526, 1 up to 5282 (shard_floats_per_cell floats a cell
// in 227 KB); wider rows are refused before any launch.  Numerics are the
// JAX package's: the -1e13 sentinel, the sigmoid as 1 / (1 + expf(-x))
// with an IEEE divide, the exact 1/2, 1/2 split on degenerate cells, no
// fast-math.

#include <cuda_runtime.h>

#include "cp_async.cuh"

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
__global__ void noblank_backward_kernel(const float* __restrict__ alpha,
                                        const int* __restrict__ inlen,
                                        const int* __restrict__ tgt,
                                        const float* __restrict__ bar,
                                        float* __restrict__ g, int T, int B,
                                        int L) {
  extern __shared__ float rows[];  // [2][L]
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float inject_val = -bar[b];
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
      const float inject =
          (t == t_inject && l == tgt_b - 1) ? inject_val : 0.0f;
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

// Shared memory of the shard backward, in floats per lattice cell l: two
// staged alpha chunks, the chunk's two weight rows per alpha row, the
// carried g double buffer, the g_seed row, the two init rows and their two
// weight rows.
__host__ __device__ constexpr int shard_floats_per_cell(int chunk) {
  return 2 * chunk + 2 * chunk + 2 + 1 + 2 + 2;
}

// One T-shard's reverse recursion (the recursion above with kShard's
// boundaries: inject = +bar[b], g_seed[b] added at t = T-1), and the
// gradients of both init rows, in one launch:
//   d_stay0[b, l] = g[0, l] * w_stay(-1, l)
//   d_adv0[b, l]  = g[0, l+1] * w_adv(-1, l+1)   (0 at l = L-1)
// where row -1's weights read stay0[b, l] against adv0[b, l-1] (the
// first local step's advance source), exactly as init_row_grads does.
//
// alpha walks down T in chunks of kChunk rows, staged into shared memory
// by cp.async one chunk ahead (two buffers); each chunk's weights are
// computed from the staged rows before its steps, so a step reads g_next
// and two weights from shared memory and does the multiply-adds only.
template <int kChunk>
__global__ void __launch_bounds__(512)
    noblank_shard_backward_kernel(const float* __restrict__ alpha,
                                  const int* __restrict__ inlen,
                                  const int* __restrict__ tgt,
                                  const float* __restrict__ bar,
                                  const float* __restrict__ g_seed,
                                  const float* __restrict__ stay0,
                                  const float* __restrict__ adv0,
                                  float* __restrict__ g,
                                  float* __restrict__ d_stay0,
                                  float* __restrict__ d_adv0, int T, int B,
                                  int L) {
  extern __shared__ float smem[];
  float* chunks = smem;                      // [2][kChunk][L] alpha
  float* weights = chunks + 2 * kChunk * L;  // [kChunk][2][L] stay, adv
  float* rows = weights + 2 * kChunk * L;    // [2][L] carried g
  float* seed = rows + 2 * L;                // [L] g_seed[b]
  float* init = seed + L;                    // [2][L] stay0[b], adv0[b]
  float* init_w = init + 2 * L;              // [2][L] row -1's weights
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float inject_val = bar[b];
  const size_t row_stride = static_cast<size_t>(B) * L;
  const size_t b_off = static_cast<size_t>(b) * L;
  const float* alpha_b = alpha + b_off;
  float* g_b = g + b_off;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  // Copies and weights spread a chunk's cells over the whole block: where a
  // row is narrower than the block, nt / L rows side by side (threads past
  // the last full row idle), else one row at a time, strided.
  const bool side_by_side = nt >= L;
  const int row_step = side_by_side ? nt / L : 1;
  const int first_row =
      side_by_side ? (tid < row_step * L ? tid / L : kChunk) : 0;
  const int first_cell = side_by_side ? tid % L : tid;
  const int cell_step = side_by_side ? L : nt;

  // chunk c holds rows [lo, hi], hi = T-1 - c*kChunk
  auto chunk_lo = [&](int c) { return max(T - (c + 1) * kChunk, 0); };
  auto stage = [&](int c) {  // chunk c -> its buffer, as one group
    if (c < n_chunks) {
      const int lo = chunk_lo(c);
      const int n = T - c * kChunk - lo;
      float* dst = chunks + (c & 1) * kChunk * L;
      for (int k = first_row; k < n; k += row_step) {
        const float* src = alpha_b + static_cast<size_t>(lo + k) * row_stride;
        for (int l = first_cell; l < L; l += cell_step) {
          cp_async::copy4(dst + k * L + l, src + l);
        }
      }
    }
    cp_async::commit();
  };

  // group 0: the seed and init rows with chunk 0; group 1: chunk 1
  for (int l = tid; l < L; l += nt) {
    cp_async::copy4(seed + l, g_seed + b_off + l);
    cp_async::copy4(init + l, stay0 + b_off + l);
    cp_async::copy4(init + L + l, adv0 + b_off + l);
  }
  stage(0);
  stage(1);
  for (int c = 0; c < n_chunks; ++c) {
    const int lo = chunk_lo(c);
    const int n = T - c * kChunk - lo;
    const float* a = chunks + (c & 1) * kChunk * L;
    cp_async::wait<1>();  // this thread's copies of chunk c have landed
    // This barrier publishes chunk c (and, at c = 0, the seed and init
    // rows): each weight reads its neighbours' cells, copied by other
    // threads.  It also orders this chunk's weight writes after the last
    // step of chunk c-1 read the weights.
    __syncthreads();
    for (int k = first_row; k < n; k += row_step) {
      const float* a_k = a + k * L;
      float* w_k = weights + 2 * k * L;
      for (int l = first_cell; l < L; l += cell_step) {
        const float a_lm1 = (l > 0) ? a_k[l - 1] : kNegSentinel;
        const float w = sigmoid(a_k[l] - a_lm1);
        const float in_l = (l < tgt_b) ? 1.0f : 0.0f;
        w_k[l] = w * in_l;
        w_k[L + l] = (1.0f - w) * in_l;
      }
    }
    if (c == 0) {
      for (int l = tid; l < L; l += nt) {
        const float adv = (l > 0) ? init[L + l - 1] : kNegSentinel;
        const float w = sigmoid(init[l] - adv);
        const float in_l = (l < tgt_b) ? 1.0f : 0.0f;
        init_w[l] = w * in_l;
        init_w[L + l] = (1.0f - w) * in_l;
      }
    }
    // publishes the weights; every read of chunk c's buffer is done
    __syncthreads();
    stage(c + 2);  // into the buffer chunk c leaves
    for (int k = n - 1; k >= 0; --k) {
      const int t = lo + k;
      const int step = T - 1 - t;
      const float* g_next = rows + (step & 1) * L;
      float* g_cur = rows + ((step + 1) & 1) * L;
      const float* w_stay = weights + 2 * k * L;
      const float* w_adv = w_stay + L;
      float* g_t = g_b + static_cast<size_t>(t) * row_stride;
      for (int l = tid; l < L; l += nt) {
        float inject = (t == t_inject && l == tgt_b - 1) ? inject_val : 0.0f;
        if (t == T - 1) inject += seed[l];
        float prop = 0.0f;
        if (t < T - 1) {
          const float stay = g_next[l] * w_stay[l];
          const float from_adv =
              (l + 1 < L) ? g_next[l + 1] * w_adv[l + 1] : 0.0f;
          prop = stay + from_adv;
        }
        const float v = inject + prop;
        g_t[l] = v;
        g_cur[l] = v;
      }
      __syncthreads();
    }
  }
  // g[0], the row the last step wrote, published by that step's barrier
  const float* g0 = rows + (T & 1) * L;
  for (int l = tid; l < L; l += nt) {
    d_stay0[b_off + l] = g0[l] * init_w[l];
    d_adv0[b_off + l] = (l + 1 < L) ? g0[l + 1] * init_w[L + l + 1] : 0.0f;
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

cudaError_t launch_backward(const float* alpha, const int* inlen,
                            const int* tgt, const float* bar, float* g, int T,
                            int B, int L, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(L) * sizeof(float);
  cudaError_t err = prepare(
      reinterpret_cast<const void*>(noblank_backward_kernel), smem);
  if (err != cudaSuccess) return err;
  noblank_backward_kernel<<<B, block_threads(L), smem, stream>>>(
      alpha, inlen, tgt, bar, g, T, B, L);
  return cudaGetLastError();
}

template <int kChunk>
cudaError_t launch_shard_backward_chunk(
    const float* alpha, const int* inlen, const int* tgt, const float* bar,
    const float* g_seed, const float* stay0, const float* adv0, float* g,
    float* d_stay0, float* d_adv0, int T, int B, int L, int threads,
    size_t smem, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(noblank_shard_backward_kernel<kChunk>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  noblank_shard_backward_kernel<kChunk><<<B, threads, smem, stream>>>(
      alpha, inlen, tgt, bar, g_seed, stay0, adv0, g, d_stay0, d_adv0, T, B,
      L);
  return cudaGetLastError();
}

// The plan (chunk, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::shard_backward_plan); a chunk the kernel is not
// built for, or shared bytes that do not match its layout, are refused.
cudaError_t launch_shard_backward(const float* alpha, const int* inlen,
                                  const int* tgt, const float* bar,
                                  const float* g_seed, const float* stay0,
                                  const float* adv0, float* g, float* d_stay0,
                                  float* d_adv0, int T, int B, int L,
                                  int chunk, int threads, int smem,
                                  cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  if (threads < 32 || threads > 512 || threads % 32 != 0 ||
      bytes != sizeof(float) * static_cast<size_t>(L) *
                   shard_floats_per_cell(chunk)) {
    return cudaErrorInvalidValue;
  }
  switch (chunk) {
    case 16:
      return launch_shard_backward_chunk<16>(alpha, inlen, tgt, bar, g_seed,
                                             stay0, adv0, g, d_stay0, d_adv0,
                                             T, B, L, threads, bytes, stream);
    case 4:
      return launch_shard_backward_chunk<4>(alpha, inlen, tgt, bar, g_seed,
                                            stay0, adv0, g, d_stay0, d_adv0,
                                            T, B, L, threads, bytes, stream);
    case 1:
      return launch_shard_backward_chunk<1>(alpha, inlen, tgt, bar, g_seed,
                                            stay0, adv0, g, d_stay0, d_adv0,
                                            T, B, L, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  return launch_backward(alpha, inlen, tgt, nll_bar, g, T, B, L, stream);
}

// One T-shard: stay0 / adv0 are [B, L] init rows.
cudaError_t noblank_shard_forward(const float* em, const int* tgt,
                                  const float* stay0, const float* adv0,
                                  float* alpha, int T, int B, int L,
                                  cudaStream_t stream) {
  return launch_forward<true>(em, tgt, stay0, adv0, alpha, T, B, L, stream);
}

// One T-shard: inlen is shard-local, final_bar the cotangent of the final
// log-prob, g_seed [B, L] that of the outgoing boundary row, stay0 / adv0
// the [B, L] init rows; writes g and the init rows' gradients d_stay0 /
// d_adv0 [B, L].  chunk, threads and smem are the wrapper's plan.
cudaError_t noblank_shard_backward(const float* alpha, const int* inlen,
                                   const int* tgt, const float* final_bar,
                                   const float* g_seed, const float* stay0,
                                   const float* adv0, float* g,
                                   float* d_stay0, float* d_adv0, int T,
                                   int B, int L, int chunk, int threads,
                                   int smem, cudaStream_t stream) {
  return launch_shard_backward(alpha, inlen, tgt, final_bar, g_seed, stay0,
                               adv0, g, d_stay0, d_adv0, T, B, L, chunk,
                               threads, smem, stream);
}

}  // extern "C"
