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
// The first kernels' design, kept as the rows layout of both whole-lattice
// kernels for the widest rows: one thread block per sample b, threads
// across the label positions l (strided when L exceeds the block), the
// carried row in a shared-memory double buffer, one __syncthreads a step.
// Numerics follow the JAX package: the -1e13 sentinel, a sentinel advance
// at t=0, logaddexp as max + log1p(exp(-|a-b|)), the outside mask applied
// before the emission add, and sigmoid branch weights in the backward
// (degenerate lattices need the exact 1/2, 1/2 split).
//
// The whole-lattice forward (noblank_forward_kernel<kLayout, kDepth>, entry
// noblank_lattice_forward) first ran that loop with em[t] read from device
// memory inside each step: 3.7 us at T=10, B=256, L=10 (one warp, 22 of 32
// lanes idle) and 0.106 ms at T=128, B=1024, L=157, and the op gathered the
// NLL after it with about a dozen small torch kernels.  It now writes
// nll[b] = -alpha[inlen-1, b, clamp(tgt-1)] (0 where inlen lies outside
// [1, T]) itself, stages em on a per-thread cp.async ring 8 rows ahead, and
// takes the layout the plan (ops/lattice_cuda.py::forward_plan) picks by
// width:
//   - warp, rows of up to 32 cells: the shard forward's warps body under
//     kWhole, a sample a warp and four a block, a lane a cell, the advance
//     source by __shfl_up_sync, no barrier.
//   - pairs, 33 to 1024 cells: one block a sample, two cells a lane, one
//     exchange slot and barrier a step across warps; where B L is even the
//     pairs are 8-byte aligned (one 8-byte copy, load and store a step);
//     T unrolled in chunks of the ring's depth.
//   - block, wider rows while its ring fits (8 rows up to 5810 cells, 2 up
//     to 14527): the shard forward's block body under kWhole (em on a ring
//     of shared rows; it ran 0.043 and 0.112 ms against the row loop's
//     0.095 and 0.193 at [64, 132, 1500] and [32, 132, 9000]).
//   - rows, wider rows to the 29056 cells the first kernel took.
// Its log-add (logaddexp_flat, log_add.cuh) is libm's, bit for bit, with
// log1pf's one branch taken out (log1p_unit), which had kept a lane's two log-adds from
// overlapping.  (A log-add
// in base 2 ran 0.0673 ms at L=157, but rounds otherwise: over T=4096 the
// 4-shard chain's gradient left the unsharded kernel's tolerance.)
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; python -m
// ctc_tpu_torch.probes.lattice_ab --pass forward, median of 5 profiler
// windows, in turns with the first kernel, max |dev| 0.0): 2.86 us at
// T=10, B=256, L=10 (3.66 before, 0.78x) and 0.0712 ms at T=128, B=1024,
// L=157 (0.1060 before, 0.67x; 69% of the bytes bound).  At L=157 a step
// pays for its em copy, its store and its log-add alike: the one-place
// builds of lattice_ab --builds ran 58.5 us without the copy, 61.0
// without the store and 66.6 without the log-add (71.4 with all).
//
// The whole-lattice backward (noblank_backward_kernel<kLayout, kChunk>,
// entry noblank_lattice_backward) first had that design: each of T steps
// loaded alpha[t] at l-1, l, l+1 from device memory after the step before's
// barrier and computed two sigmoids a cell (each cell's weight twice)
// before the one multiply-add that needs g[t+1]: 7.0 us at T=10, B=256,
// L=10 (one warp, 22 of 32 lanes idle) and 0.147 ms at T=128, B=1024,
// L=157, against bounds of 0.06 and 49 us.  Neither the load nor the
// weights depend on g, so every layout takes them off the dependent chain:
// alpha is staged by cp.async a chunk of rows ahead and each cell's
// weights are computed once, before the chunk's steps.  The plan
// (ops/lattice_cuda.py::backward_plan) picks the layout by width:
//   - chunks-warp, rows of up to 32 cells: the chunked body below with 128
//     threads staging and weighting each 16-row chunk, its rows side by
//     side, and one warp running the steps with g in registers, the right
//     neighbour's term by __shfl_down_sync, no barrier a step (weighting a
//     chunk's rows lane by lane in one warp put ten IEEE divides one after
//     another on the path: 4.3-4.7 us).
//   - warps, 33 to 1024 cells: one block a sample, two cells a lane, alpha
//     staged into each lane's own columns 8 rows ahead, the weights in
//     registers, one shuffle and (across warps) one exchange slot and one
//     barrier a step.  One cell a lane read 0.102-0.120 ms at L=157: its
//     ~55-instruction step and 62 registers (6 blocks of 160 threads an
//     SM, two waves) made it issue-bound; two cells a lane halve the
//     step's cost per cell and the warps.
//   - rows, wider rows to the 29056 cells the first kernel took: its row
//     loop unchanged.  (The shard backward's chunked body with 512 threads
//     and 4- or 1-row chunks lost to it at L=157, 0.217 and 0.287 ms
//     against 0.146 on the card below, lattice_ab --plans, so it takes no
//     whole-lattice width.)
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; python -m
// ctc_tpu_torch.probes.lattice_ab, median of 5 profiler windows, in turns
// with the first kernel): 3.75 us at T=10, B=256, L=10 (6.99 before,
// 0.536x) and 0.0848 ms at T=128, B=1024, L=157 (0.1470 before, 0.577x;
// 58% of the bytes bound).  At L=157 a step of the warps layout is ~84 SASS
// instructions for two cells (their two IEEE divides, sunk into the step
// by the compiler, the shuffle, exchange and barrier), ~950 SM cycles with
// ~23 warps an SM.
//
// The shard forward (noblank_shard_forward_kernel<kDepth, kHalo>, entry
// noblank_shard_forward; replaces lattice_pallas.py:_forward_kernel_boundary)
// runs one T-shard from the lattice's two boundaries: the carry starts from
// the row stay0[b] and the advance source of local t = 0 is the row adv0[b]
// (shifted; no t > 0 gate).  The same launch writes the shard's outputs,
// final[b] = alpha[inlen-1, b, clamp(tgt-1)] (0 unless 1 <= inlen <= T) and
// the boundary row alpha[T-1, b], which torch ops gathered and copied
// before, and it reads the pipeline's batch slice of em in place through
// its row stride (no contiguous copy).  What binds it is not bytes (0.08
// and 0.24 us of bound at [16, 32, 64] and [1024, 4, 24]) but T dependent
// steps, one block per sample.  The earlier kernel (the whole-lattice loop
// under a shard flag) took ~505-540 SM cycles a step at the 1980 MHz the
// card ran (python -m ctc_tpu_torch.probes.shard_sweep --pass forward
// --parent DIR): its em load was already off the chain (the SASS issues it
// first in the step and adds it last), and the log-add's ~30 dependent
// instructions, the shared-memory round trip and the barrier made the step.
// So this kernel takes the carried row out of shared memory:
//   - the warps layout, rows of up to kWarpsMaxWidth = 768 cells: one lane
//     a cell, the carried cell in a register, the advance source from the
//     lane before by __shfl_up_sync, no barrier in a step.  A row of up to
//     32 cells is one warp (kHalo 0).  A wider row takes warps that own 24
//     cells each and carry the kHalo = 8 cells before them in their first
//     lanes; those go stale one lane a step and are refreshed from their
//     owners every 8 steps through shared memory, with one barrier.
//   - em staged on a per-thread cp.async ring, kDepth - 1 steps ahead: each
//     thread copies and reads only its column of a [kDepth][threads] ring,
//     so its own wait makes the cell visible (no barrier for em).  The ring
//     is addressed by a shared-window address taken once: converting the
//     pointer in the step put an S2UR of the CTA id on the step's path.
//   - step 0 and the last step are peeled: the init rows come into
//     registers with the first group, and the boundary row leaves from them.
//   - rows wider than 768 cells take the block layout: a block across the
//     row, the carried row in a shared double buffer, the ring in shared
//     rows, one barrier a step (no rows that wide are on the seq path).
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; python -m
// ctc_tpu_torch.probes.shard_ab, median of 5 profiler windows): 5.02 us at
// [16, 32, 64] in three warps (5.48 before) and 0.1713 ms at [1024, 4, 24]
// in one (0.2721 before): 466 and 332 cycles a step.  A step now is the
// shuffle, the log-add chain, the ring read and the store (dropping the
// store saves 5-12%, python -m ctc_tpu_torch.probes.shard_sweep --pass
// forward), and in a wider row the refresh.
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

#include <cstdint>

#include "cp_async.cuh"
#include "log_add.cuh"

namespace {

constexpr float kNegSentinel = -1.0e13f;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The whole-lattice forward:
//   alpha[t, b, l] = em[t, b, l] + (l >= tgt[b] ? -1e13
//       : logaddexp(alpha[t-1, b, l], alpha[t-1, b, l-1]))
// with alpha(-1) = 0 at l = 0 and the sentinel elsewhere, no advance at
// t = 0, and nll[b] = -alpha[inlen[b]-1, b, clamp(tgt[b]-1, 0, L-1)], 0
// where inlen[b] lies outside [1, T] (the wrapper's gather_nll).
//
// The rows layout (the first design, for rows wider than the block layout
// takes): one block a sample, the carried row in a shared double buffer,
// em[t] read from device memory inside the step, one __syncthreads a step;
// the final cell's thread writes nll[b] at its step.
__device__ __forceinline__ void noblank_forward_rows(
    const float* __restrict__ em, const int* __restrict__ inlen,
    const int* __restrict__ tgt, float* __restrict__ alpha,
    float* __restrict__ nll, int T, int B, int L) {
  extern __shared__ float rows[];  // [2][L]
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int l_fin = min(max(tgt_b - 1, 0), L - 1);
  const size_t row_stride = static_cast<size_t>(B) * L;
  const float* em_b = em + static_cast<size_t>(b) * L;
  float* alpha_b = alpha + static_cast<size_t>(b) * L;

  if (t_fin < 0 && threadIdx.x == 0) nll[b] = 0.0f;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    rows[l] = (l == 0) ? 0.0f : kNegSentinel;
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
      const float adv = (l > 0 && t > 0) ? cur[l - 1] : kNegSentinel;
      float lse = logaddexp_flat(stay, adv);
      if (l >= tgt_b) lse = kNegSentinel;
      const float a = lse + e;
      if (t == t_fin && l == l_fin) nll[b] = -a;
      alpha_t[l] = a;
      nxt[l] = a;
    }
    __syncthreads();
  }
}

// Shared memory of the shard forward, in floats per lattice cell l: the
// carried alpha double buffer and the em ring of kDepth rows.
__host__ __device__ constexpr int shard_forward_floats_per_cell(int depth) {
  return 2 + depth;
}

// A compile-time flag passed to the step lambdas (which step is peeled).
template <bool kValue>
struct Flag {
  static constexpr bool value = kValue;
};

// The warps layout of the shard forward (rows of up to kWarpsMaxWidth
// cells): one lane per cell.  A row of up to 32 cells is one warp.  A wider
// row takes 32-lane warps of which warp w owns the kOwn = 32 - kWarpsHalo cells
// from w * kOwn on, and carries the kWarpsHalo cells before them (the last ones
// of warp w-1) in its first lanes.
constexpr int kWarpsHalo = 8;
constexpr int kOwn = 32 - kWarpsHalo;
constexpr int kWarpsMaxWidth = 32 * kOwn;  // 32 warps of a 1024-thread block
constexpr unsigned kFullMask = 0xffffffffu;

// The threads of the warps layout at width L.
__host__ __device__ constexpr int warps_threads(int L) {
  return L <= 32 ? 32 : 32 * ((L + kOwn - 1) / kOwn);
}

// The shard forward of noblank_shard_forward_block (below) in the warps
// layout.  Each lane keeps its cell of the carried row in a register and
// takes its advance source from the lane before it by __shfl_up_sync, so a
// step has no barrier and no shared-memory row: the shuffle, the log-add,
// the mask, the add and the store.  A warp's first lane has no source in
// the warp, so after j steps its first j lanes are stale; the halo lanes
// are refreshed from their owners' registers every kHalo steps, through
// shared memory and one barrier (none in a one-warp row).  em comes through
// the per-thread cp.async ring (kDepth slots a thread); the init rows come
// into registers with the first group.  Only a cell's owner stores it; the
// final cell goes through shared memory to thread 0.
//
// kWhole runs the whole lattice instead (the forward's warp layout, rows of
// up to 32 cells, kHalo 0): a sample a warp, blockDim.x / 32 samples a
// block; the carry starts at 0 at l = 0 and the sentinel elsewhere, made in
// registers, the advance source of t = 0 is the sentinel, no boundary row is
// written, and final_out is nll: the final cell's lane writes -alpha at its
// step, lane 0 the 0 of a sample whose inlen lies outside [1, T].
template <int kDepth, int kHalo, bool kWhole = false>
__device__ __forceinline__ void noblank_shard_forward_warps(
    const float* __restrict__ em, const int* __restrict__ inlen,
    const int* __restrict__ tgt, const float* __restrict__ stay0,
    const float* __restrict__ adv0, float* __restrict__ alpha,
    float* __restrict__ final_out, float* __restrict__ boundary, int T, int B,
    int L, int em_stride) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  static_assert(!kWhole || kHalo == 0, "the whole lattice: one-warp rows");
  extern __shared__ float smem[];
  __shared__ float fin;  // alpha at the final cell
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int b = kWhole ? blockIdx.x * (nt >> 5) + (tid >> 5) : blockIdx.x;
  if (kWhole && b >= B) return;  // warps past the batch
  // this lane's cell
  const int l = kWhole ? lane : (tid >> 5) * (32 - kHalo) - kHalo + lane;
  const bool real = l >= 0 && l < L;
  const bool owner = real && lane >= kHalo;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const bool fin_cell = owner && l == min(max(tgt_b - 1, 0), L - 1);
  const bool outside = l >= tgt_b;
  const size_t b_off = static_cast<size_t>(b) * L;
  const size_t row_stride = static_cast<size_t>(B) * L;

  // the next unstaged step's em cell of this thread -> its ring slot (this
  // thread's column of the [kDepth][nt] ring, slot bytes apart)
  const unsigned ring_s = cp_async::shared_address(smem + tid);
  const unsigned slot = 4 * nt;
  const float* src = em + b_off + l;
  int staged = 0;
  auto stage = [&]() {
    if (staged < T) {
      if (real) cp_async::copy4(ring_s + (staged & (kDepth - 1)) * slot, src);
      src += em_stride;
    }
    cp_async::commit();
    ++staged;
  };

  // the carried cell, and step 0's advance source adv0[b, l-1]
  float a = kWhole ? ((l == 0) ? 0.0f : kNegSentinel)
                   : (real ? stay0[b_off + l] : kNegSentinel);
  const float adv_first =
      (!kWhole && real && l > 0) ? adv0[b_off + l - 1] : kNegSentinel;
  if (kWhole && t_fin < 0 && l == 0) final_out[b] = 0.0f;
  float* out = alpha + b_off + l;
  auto step = [&](int t, auto first, auto last) {
    float adv;
    if constexpr (decltype(first)::value) {
      adv = adv_first;
    } else {
      const float left = __shfl_up_sync(kFullMask, a, 1);
      adv = (l > 0) ? left : kNegSentinel;
    }
    const float e = cp_async::load(ring_s + (t & (kDepth - 1)) * slot);
    if (real) {
      float lse = kWhole ? logaddexp_flat(a, adv) : logaddexp(a, adv);
      if (outside) lse = kNegSentinel;
      a = lse + e;
      if (owner) {
        *out = a;
        if (t == t_fin && fin_cell) {
          if constexpr (kWhole) {
            final_out[b] = -a;
          } else {
            fin = a;
          }
        }
        if constexpr (!kWhole && decltype(last)::value) {
          boundary[b_off + l] = a;
        }
      }
    }
    out += row_stride;
  };

  // after step t: every kHalo steps, the halo lanes from their owners
  int refresh = kHalo;  // steps until the halo lanes go stale
  int buf = 0;
  auto after = [&](int t) {
    if (kHalo > 0 && --refresh == 0 && t + 1 < T) {
      refresh = kHalo;
      // the owners' cells, in one of two rows: one barrier a refresh
      float* x = smem + kDepth * nt + buf * L;
      buf ^= 1;
      if (owner) x[l] = a;
      __syncthreads();
      if (real && !owner) a = x[l];
    }
  };

  // groups 0 .. kDepth-1: steps 0 .. kDepth-1; each later step stages one
  // more, into the slot the step before it read
  for (int k = 0; k < kDepth; ++k) stage();
  cp_async::wait<kDepth - 1>();  // step 0's group has landed
  if (T == 1) {
    step(0, Flag<true>{}, Flag<true>{});
  } else {
    step(0, Flag<true>{}, Flag<false>{});
  }
  after(0);
  for (int t = 1; t < T - 1; ++t) {
    stage();
    cp_async::wait<kDepth - 1>();  // step t's group has landed
    step(t, Flag<false>{}, Flag<false>{});
    after(t);
  }
  if (T > 1) {
    stage();
    cp_async::wait<kDepth - 1>();
    step(T - 1, Flag<false>{}, Flag<true>{});
  }
  if constexpr (kWhole) return;  // nll is written
  __syncthreads();  // publishes fin
  if (tid == 0) final_out[b] = (t_fin >= 0) ? fin : 0.0f;
}

// One T-shard's forward: the recursion above from the init rows, with the
// shard's epilogue in the same launch:
//   alpha(-1) = stay0[b]; the advance source of local t = 0 is adv0[b]
//   (shifted, no t > 0 gate), the carry at every later step;
//   final[b] = alpha[inlen[b]-1, b, clamp(tgt[b]-1)], 0 unless 1 <= inlen[b]
//   <= T (inlen is shard-local);  boundary[b] = alpha[T-1, b].
// em [T, B, L] is read through its row stride em_stride (floats between
// em[t, b] and em[t+1, b]); rows and samples are contiguous.
//
// Each thread owns the cells l = tid, tid + nt, ... for the whole shard,
// and stages exactly those cells of em into a ring of kDepth rows in shared
// memory, kDepth - 1 steps ahead: one cp.async group per step (empty past
// T, so the count stays uniform), waited for with an immediate.  Its own
// wait makes its own copies visible, so em needs no barrier; the step's
// __syncthreads orders a slot's reuse.  Group 0 also brings stay0[b, l]
// into the carry row and adv0[b, l-1] into the other row at l, so step 0
// (peeled) reads only this thread's copies; the last step (peeled) writes
// the boundary row from registers.  The final cell's value goes through
// shared memory at its step's barrier; thread 0 writes final[b].  kWhole
// runs the whole lattice (the forward's block layout): the init rows are
// written by each thread at its cells, not copied, no boundary row is
// written, and final_out is nll.
template <int kDepth, bool kWhole = false>
__device__ __forceinline__ void noblank_shard_forward_block(
    const float* __restrict__ em, const int* __restrict__ inlen,
    const int* __restrict__ tgt, const float* __restrict__ stay0,
    const float* __restrict__ adv0, float* __restrict__ alpha,
    float* __restrict__ final_out, float* __restrict__ boundary, int T, int B,
    int L, int em_stride) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  extern __shared__ float smem[];
  float* rows = smem;          // [2][L] carried alpha
  float* ring = rows + 2 * L;  // [kDepth][L] em, step t in slot t % kDepth
  __shared__ float fin;        // alpha at the final cell
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int l_fin = min(max(tgt_b - 1, 0), L - 1);
  const size_t b_off = static_cast<size_t>(b) * L;
  const size_t row_stride = static_cast<size_t>(B) * L;

  // the next unstaged step's em cells of this thread -> its ring slot
  const float* src = em + b_off;
  int staged = 0;
  auto stage = [&]() {
    if (staged < T) {
      float* slot = ring + (staged & (kDepth - 1)) * L;
      for (int l = tid; l < L; l += nt) cp_async::copy4(slot + l, src + l);
      src += em_stride;
    }
    cp_async::commit();
    ++staged;
  };

  float* alpha_t = alpha + b_off;
  auto step = [&](int t, auto first, auto last) {
    const float* cur = rows + (t & 1) * L;
    float* nxt = rows + ((t + 1) & 1) * L;
    const float* e_t = ring + (t & (kDepth - 1)) * L;
    for (int l = tid; l < L; l += nt) {
      const float e = e_t[l];
      const float stay = cur[l];
      float adv;
      if constexpr (decltype(first)::value) {
        adv = (l > 0) ? nxt[l] : kNegSentinel;  // adv0[b, l-1], staged
      } else {
        adv = (l > 0) ? cur[l - 1] : kNegSentinel;
      }
      float lse = kWhole ? logaddexp_flat(stay, adv) : logaddexp(stay, adv);
      if (l >= tgt_b) lse = kNegSentinel;
      const float a = lse + e;
      alpha_t[l] = a;
      nxt[l] = a;
      if (t == t_fin && l == l_fin) fin = a;
      if constexpr (!kWhole && decltype(last)::value) boundary[b_off + l] = a;
    }
    alpha_t += row_stride;
  };

  // group 0: step 0's em and the init rows; then steps 1 .. kDepth-2
  for (int l = tid; l < L; l += nt) {
    if constexpr (kWhole) {
      rows[l] = (l == 0) ? 0.0f : kNegSentinel;
      rows[L + l] = kNegSentinel;
    } else {
      cp_async::copy4(rows + l, stay0 + b_off + l);
      if (l > 0) cp_async::copy4(rows + L + l, adv0 + b_off + l - 1);
    }
  }
  for (int s = 0; s + 1 < kDepth; ++s) stage();
  cp_async::wait<kDepth - 2>();  // group 0 has landed
  if (T == 1) {
    step(0, Flag<true>{}, Flag<true>{});
  } else {
    step(0, Flag<true>{}, Flag<false>{});
  }
  __syncthreads();
  stage();  // step kDepth-1, into slot kDepth-1
  for (int t = 1; t < T - 1; ++t) {
    stage();                      // step t + kDepth-1, into step t-1's slot
    cp_async::wait<kDepth - 1>();  // step t's group has landed
    step(t, Flag<false>{}, Flag<false>{});
    __syncthreads();
  }
  if (T > 1) {
    stage();
    cp_async::wait<kDepth - 1>();
    step(T - 1, Flag<false>{}, Flag<true>{});
    __syncthreads();  // publishes fin
  }
  if (tid == 0) final_out[b] = kWhole ? ((t_fin >= 0) ? -fin : 0.0f)
                                      : ((t_fin >= 0) ? fin : 0.0f);
}

// The shard forward kernel: the warps layout (kHalo halo lanes a warp:
// 0 for a one-warp row, kWarpsHalo for wider ones) for rows of up to
// kWarpsMaxWidth cells, else the block layout (kHalo -1).
template <int kDepth, int kHalo>
__global__ void __launch_bounds__(1024)
    noblank_shard_forward_kernel(const float* __restrict__ em,
                                 const int* __restrict__ inlen,
                                 const int* __restrict__ tgt,
                                 const float* __restrict__ stay0,
                                 const float* __restrict__ adv0,
                                 float* __restrict__ alpha,
                                 float* __restrict__ final_out,
                                 float* __restrict__ boundary, int T, int B,
                                 int L, int em_stride) {
  if constexpr (kHalo >= 0) {
    noblank_shard_forward_warps<kDepth, kHalo>(em, inlen, tgt, stay0, adv0,
                                               alpha, final_out, boundary, T,
                                               B, L, em_stride);
  } else {
    noblank_shard_forward_block<kDepth>(em, inlen, tgt, stay0, adv0, alpha,
                                        final_out, boundary, T, B, L,
                                        em_stride);
  }
}

// The pairs layout of the whole-lattice forward, rows of 33 to
// kForwardPairsWidth cells: one block a sample, two cells a lane, the row
// in whole warps, both carried cells in registers.  Where a step's rows
// [b, :] span an even number of floats (B L even: every row of a sample
// then starts at the same parity), the pairs are 8-byte aligned in em and
// alpha (whose bases are): lane i holds cells l0 = 2i - off and l0 + 1,
// off = 1 where the sample's row starts at an odd float, and then lane 0's
// first cell is the cell before the row (the sample before's last: read,
// never written; its carry is held at the sentinel); a step copies em by
// one 8-byte cp.async (4 bytes for a pair the row ends in), reads it by one
// 8-byte shared load and stores alpha by one 8-byte store.  Where B L is
// odd a row's parity changes with t, so lane i holds cells 2i and 2i + 1
// and copies and stores them 4 bytes at a time (at every B L that ran 2%
// slower at T=128, B=1024, L=157: lattice_ab --builds pairs4).
// Cell l0 + 1's advance source is the lane's own cell l0; cell l0's is the
// lane before's cell l0 - 1, by __shfl_up_sync, which lane 0 of a later
// warp takes from the warp before's lane 31 through a shared exchange slot
// (two rows, toggled a step) after one __syncthreads a step (none in a
// one-warp row).  em comes through the per-thread cp.async ring, kDepth - 1
// steps ahead: each thread copies and reads only its own [kDepth] column of
// pairs, so em needs no barrier.  T runs in unrolled chunks of kDepth
// steps (the ring slots constants).  The thread that stored the final cell
// reads it back after the last step and writes nll[b], thread 0 the 0 of a
// sample whose inlen lies outside [1, T].
template <int kDepth>
__device__ __forceinline__ void noblank_forward_pairs(
    const float* __restrict__ em, const int* __restrict__ inlen,
    const int* __restrict__ tgt, float* __restrict__ alpha,
    float* __restrict__ nll, int T, int B, int L) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  extern __shared__ float smem[];
  const int i = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = nt >> 5;
  const int b = blockIdx.x;
  const size_t b_off = static_cast<size_t>(b) * L;
  const size_t row_stride = static_cast<size_t>(B) * L;
  const bool paired = (row_stride & 1) == 0;  // 8-byte pairs
  // this lane's cells l0 and l0 + 1
  const int l0 = 2 * i - (paired ? static_cast<int>(b_off & 1) : 0);
  const bool real0 = l0 >= 0 && l0 < L;
  const bool real1 = l0 + 1 < L;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int l_fin = min(max(tgt_b - 1, 0), L - 1);
  // the cell before the row counts as outside: its carry stays at the
  // sentinel, the advance source cell 0 lacks
  const bool outside0 = l0 < 0 || l0 >= tgt_b;
  const bool outside1 = l0 + 1 >= tgt_b;

  // step r's pair of this thread (r < T; an empty group past T) -> ring
  // slot j (its column of the [kDepth][nt] ring of pairs, slot bytes apart)
  const unsigned ring_s = cp_async::shared_address(smem + 2 * i);
  const unsigned slot = 8 * nt;
  const float* src = em + b_off + l0;
  auto stage = [&](int r, int j) {
    if (r < T) {
      const unsigned dst = ring_s + j * slot;
      if (paired && real1) {
        cp_async::copy8(dst, src);
      } else {
        if (real0) cp_async::copy4(dst, src);
        if (real1) cp_async::copy4(dst + 4, src + 1);
      }
      src += row_stride;
    }
    cp_async::commit();
  };
  // groups 0 .. kDepth-1: steps 0 .. kDepth-1
  for (int k = 0; k < kDepth; ++k) stage(k, k);

  if (t_fin < 0 && i == 0) nll[b] = 0.0f;
  const bool wide = n_warps > 1;
  const bool takes_prev = lane == 0 && warp > 0;
  // the [2][n_warps] exchange rows after the ring: this warp's slot and the
  // warp before's, in the row at offset x_row
  float* x_mine = smem + kDepth * 2 * nt + warp;
  const float* x_prev = x_mine - 1;
  int x_row = 0;

  // alpha(-1) at l0 and l0 + 1: 0 at cell 0, the sentinel elsewhere
  float a0 = (l0 == 0) ? 0.0f : kNegSentinel;
  float a1 = (l0 + 1 == 0) ? 0.0f : kNegSentinel;
  float* out = alpha + b_off + l0;
  // step t, whose em is in ring slot k = t % kDepth
  auto step = [&](int t, int k) {
    // step t + kDepth-1, into the slot step t-1 read
    if (t > 0) stage(t + kDepth - 1, (k + kDepth - 1) & (kDepth - 1));
    cp_async::wait<kDepth - 1>();  // step t's group has landed
    const float2 e = cp_async::load2(ring_s + k * slot);
    // cell l0 + 1 first: its sources are the lane's own (no advance at
    // t = 0), so it does not wait for the exchange
    float lse1 = logaddexp_flat(a1, (t > 0) ? a0 : kNegSentinel);
    if (outside1) lse1 = kNegSentinel;
    const float n1 = lse1 + e.y;
    float adv0 = kNegSentinel;
    if (t > 0) {
      float left = __shfl_up_sync(kFullMask, a1, 1);  // cell l0 - 1
      if (wide) {
        if (lane == 31) x_mine[x_row] = a1;
        __syncthreads();
        if (takes_prev) left = x_prev[x_row];
        x_row = n_warps - x_row;
      }
      if (l0 > 0) adv0 = left;
    }
    // both cells branch-free (a lane past the row computes on whatever
    // its ring slots hold and stores nothing), so the two log-adds overlap
    float lse0 = logaddexp_flat(a0, adv0);
    if (outside0) lse0 = kNegSentinel;
    // the cell before the row stays at the sentinel, whatever em holds there
    a0 = (l0 < 0) ? kNegSentinel : lse0 + e.x;
    a1 = n1;
    if (paired && real0 && real1) {
      *reinterpret_cast<float2*>(out) = make_float2(a0, a1);
    } else {
      if (real0) out[0] = a0;
      if (real1) out[1] = a1;
    }
    out += row_stride;
  };
  // T in chunks of kDepth steps, unrolled, so that the ring slots are
  // constants; then the steps past the last whole chunk
  int t = 0;
  for (; t + kDepth <= T; t += kDepth) {
#pragma unroll
    for (int k = 0; k < kDepth; ++k) step(t + k, k);
  }
  for (int k = 0; t < T; ++t, ++k) step(t, k);
  // the final cell, read back by the thread that stored it
  if (t_fin >= 0 && (l0 == l_fin || l0 + 1 == l_fin)) {
    nll[b] = -alpha[t_fin * row_stride + b_off + l_fin];
  }
}

// The whole-lattice forward's layouts (kLayout), picked by the wrapper's
// plan (ops/lattice_cuda.py::forward_plan, FORWARD_LAYOUTS):
constexpr int kForwardRows = 0;   // noblank_forward_rows
// noblank_shard_forward_warps<kDepth, 0, true>
constexpr int kForwardWarp = 1;
constexpr int kForwardPairs = 2;  // noblank_forward_pairs<kDepth>
constexpr int kForwardBlock = 3;  // noblank_shard_forward_block<kDepth, true>
// the widest row of the pairs layout (two cells a lane, 16 warps) and its
// exchange slots a warp
constexpr int kForwardPairsWidth = 1024;
constexpr int kForwardExchange = 1;

// The most threads a block of each layout may have (its launch bounds):
// the warp layout 8 samples a block, the pairs layout 17 warps (the pairs
// of cells -1 .. 1023).
__host__ __device__ constexpr int forward_max_threads(int layout) {
  return layout == kForwardWarp ? 256 : layout == kForwardPairs ? 544 : 1024;
}

template <int kLayout, int kDepth>
__global__ void __launch_bounds__(forward_max_threads(kLayout))
    noblank_forward_kernel(const float* __restrict__ em,
                           const int* __restrict__ inlen,
                           const int* __restrict__ tgt,
                           float* __restrict__ alpha, float* __restrict__ nll,
                           int T, int B, int L) {
  if constexpr (kLayout == kForwardWarp) {
    noblank_shard_forward_warps<kDepth, 0, true>(
        em, inlen, tgt, nullptr, nullptr, alpha, nll, nullptr, T, B, L,
        B * L);
  } else if constexpr (kLayout == kForwardPairs) {
    noblank_forward_pairs<kDepth>(em, inlen, tgt, alpha, nll, T, B, L);
  } else if constexpr (kLayout == kForwardBlock) {
    noblank_shard_forward_block<kDepth, true>(em, inlen, tgt, nullptr,
                                              nullptr, alpha, nll, nullptr, T,
                                              B, L, B * L);
  } else {
    noblank_forward_rows(em, inlen, tgt, alpha, nll, T, B, L);
  }
}

// Reverse recursion over the lattice:
//   g[t, l] = inject[t, l] + g[t+1, l] * w_stay(t, l)
//             + g[t+1, l+1] * w_adv(t, l+1)
// with w_stay(t, l) = sigmoid(alpha[t, l] - alpha[t, l-1]) * inside(l),
// w_adv = (1 - sigmoid(...)) * inside(l), and inject = -bar[b] at
// (inlen[b]-1, tgt[b]-1).  g is zero above the last row, so every row at or
// past inlen[b] comes out exactly 0.
//
// The rows layout (the first design, for rows wider than the warps layout
// takes): one block per sample, the carried row in a shared double buffer,
// alpha[t] at l-1, l, l+1 read from device memory and both sigmoids of a
// cell computed inside the step, one __syncthreads a step.
__device__ __forceinline__ void noblank_backward_rows(
    const float* __restrict__ alpha, const int* __restrict__ inlen,
    const int* __restrict__ tgt, const float* __restrict__ bar,
    float* __restrict__ g, int T, int B, int L) {
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

// Shared memory of the chunked backward, in floats per lattice cell l: two
// staged alpha chunks, the chunk's two weight rows per alpha row and the
// carried g double buffer; the shard backward adds the g_seed row, the two
// init rows and their two weight rows.
__host__ __device__ constexpr int chunked_floats_per_cell(int chunk) {
  return 2 * chunk + 2 * chunk + 2;
}
__host__ __device__ constexpr int shard_floats_per_cell(int chunk) {
  return chunked_floats_per_cell(chunk) + 1 + 2 + 2;
}

// The reverse recursion above with alpha staged in chunks: the chunks-warp
// layout of the whole-lattice backward (kShard false: inject = -bar[b],
// the shard pointers unused) and the shard backward (kShard true: the
// recursion with the shard's boundaries, inject = +bar[b] and g_seed[b]
// added at t = T-1, and the gradients of both init rows):
//   d_stay0[b, l] = g[0, l] * w_stay(-1, l)
//   d_adv0[b, l]  = g[0, l+1] * w_adv(-1, l+1)   (0 at l = L-1)
// where row -1's weights read stay0[b, l] against adv0[b, l-1] (the
// first local step's advance source), exactly as init_row_grads does.
//
// alpha walks down T in chunks of kChunk rows, staged into shared memory
// by cp.async one chunk ahead (two buffers); each chunk's weights are
// computed from the staged rows before its steps, so a step reads g_next
// and two weights from shared memory and does the multiply-adds only.
// With kWarpSteps (rows of up to 32 cells, not kShard) the block stages
// and weights each chunk, its rows side by side, and warp 0 alone runs the
// steps: a lane a cell, the carried g in a register, the right
// neighbour's g[t+1, l+1] * w_adv(t, l+1) by __shfl_down_sync, no barrier
// a step; the next chunk's first barrier orders its reads of the weights
// before they are overwritten.
template <int kChunk, bool kShard, bool kWarpSteps = false>
__device__ __forceinline__ void noblank_backward_chunked(
    const float* __restrict__ alpha, const int* __restrict__ inlen,
    const int* __restrict__ tgt, const float* __restrict__ bar,
    const float* __restrict__ g_seed, const float* __restrict__ stay0,
    const float* __restrict__ adv0, float* __restrict__ g,
    float* __restrict__ d_stay0, float* __restrict__ d_adv0, int T, int B,
    int L) {
  extern __shared__ float smem[];
  float* chunks = smem;                      // [2][kChunk][L] alpha
  float* weights = chunks + 2 * kChunk * L;  // [kChunk][2][L] stay, adv
  float* rows = weights + 2 * kChunk * L;    // [2][L] carried g
  float* seed = rows + 2 * L;                // [L] g_seed[b] (kShard)
  float* init = seed + L;                    // [2][L] stay0[b], adv0[b]
  float* init_w = init + 2 * L;              // [2][L] row -1's weights
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float inject_val = kShard ? bar[b] : -bar[b];
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
  if constexpr (kShard) {
    for (int l = tid; l < L; l += nt) {
      cp_async::copy4(seed + l, g_seed + b_off + l);
      cp_async::copy4(init + l, stay0 + b_off + l);
      cp_async::copy4(init + L + l, adv0 + b_off + l);
    }
  }
  stage(0);
  stage(1);
  float g_lane = 0.0f;  // kWarpSteps: warp 0's g[t+1, b, tid]
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
    if (kShard && c == 0) {
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
    if constexpr (kWarpSteps) {
      stage(c + 2);  // into the buffer this chunk leaves
      if (tid < 32) {
        const bool real = tid < L;
#pragma unroll
        for (int k = kChunk - 1; k >= 0; --k) {
          if (k < n) {
            const int t = lo + k;
            const float* w_k = weights + 2 * k * L;
            const float w_stay = real ? w_k[tid] : 0.0f;
            const float w_adv = real ? w_k[L + tid] : 0.0f;
            const float inject =
                (t == t_inject && tid == tgt_b - 1) ? inject_val : 0.0f;
            float prop = 0.0f;
            if (t < T - 1) {
              const float right =
                  __shfl_down_sync(kFullMask, g_lane * w_adv, 1);
              const float stay = g_lane * w_stay;
              prop = stay + ((tid + 1 < L) ? right : 0.0f);
            }
            g_lane = inject + prop;
            if (real) g_b[static_cast<size_t>(t) * row_stride + tid] = g_lane;
          }
        }
      }
      continue;
    }
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
        if (kShard && t == T - 1) inject += seed[l];
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
  if constexpr (kShard) {
    const float* g0 = rows + (T & 1) * L;
    for (int l = tid; l < L; l += nt) {
      d_stay0[b_off + l] = g0[l] * init_w[l];
      d_adv0[b_off + l] = (l + 1 < L) ? g0[l + 1] * init_w[L + l + 1] : 0.0f;
    }
  }
}

// The warps layout of the whole-lattice backward, rows of 33 to
// kBackwardWarpsWidth cells: one block a sample, two cells a lane (cells
// 2i and 2i+1 of lane i, the row in whole warps), the carried g[t+1, 2i]
// and g[t+1, 2i+1] in registers.  alpha comes by cp.async into the lane's
// own columns of a [2][kChunk][2][threads] staging buffer, chunk c+1 in
// flight while chunk c's steps run; a lane copies and reads only its own
// cells, so its own wait makes them visible (lane 0 of each warp also
// stages the cell before the warp's first, kHalo = 1).  A chunk's weights
// are computed before its steps, into registers: all its alpha rows are
// read first, then alpha[t, 2i-1] comes from the lane before by
// __shfl_up_sync (lane 0: its halo cell), then one sigmoid a cell.  A step
// adds cell 2i+1's advance term to cell 2i in the lane, and takes the next
// lane's g[t+1, 2i+2] * w_adv(t, 2i+2) for cell 2i+1 by one
// __shfl_down_sync; lane 31 takes the next warp's lane 0's through a shared
// exchange slot (two buffers) after the step's one __syncthreads (none in a
// one-warp row).
template <int kChunk>
__device__ __forceinline__ void noblank_backward_warps(
    const float* __restrict__ alpha, const int* __restrict__ inlen,
    const int* __restrict__ tgt, const float* __restrict__ bar,
    float* __restrict__ g, int T, int B, int L) {
  extern __shared__ float smem[];
  const int i = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = nt >> 5;
  const int b = blockIdx.x;
  const int l0 = 2 * i;  // this lane's cells l0 and l0 + 1
  const bool real0 = l0 < L;
  const bool real1 = l0 + 1 < L;
  const bool stage_halo = lane == 0 && l0 > 0;
  const size_t row_stride = static_cast<size_t>(B) * L;
  const float* src = alpha + static_cast<size_t>(b) * L + l0;
  const int chunk_count = (T + kChunk - 1) / kChunk;
  // [2][kChunk][2][nt] staged cells, [2][kChunk][n_warps] halo cells, and
  // the [2][n_warps] exchange slots
  float* halo = smem + 2 * kChunk * 2 * nt;
  float* xch = halo + 2 * kChunk * n_warps;
  const unsigned mine = cp_async::shared_address(smem + i);
  const unsigned mine_halo = cp_async::shared_address(halo + warp);
  const unsigned slot = 4 * nt;
  const unsigned halo_slot = 4 * n_warps;
  auto lo_of = [&](int c) { return max(T - (c + 1) * kChunk, 0); };
  auto stage = [&](int c) {  // chunk c's cells of this lane, one group
    if (c < chunk_count) {
      const int lo = lo_of(c);
      const int n = T - c * kChunk - lo;
      const float* row = src + static_cast<size_t>(lo) * row_stride;
      unsigned dst = mine + (c & 1) * kChunk * 2 * slot;
      unsigned dst_halo = mine_halo + (c & 1) * kChunk * halo_slot;
      for (int k = 0; k < n; ++k) {
        if (real0) cp_async::copy4(dst, row);
        if (real1) cp_async::copy4(dst + slot, row + 1);
        if (stage_halo) cp_async::copy4(dst_halo, row - 1);
        row += row_stride;
        dst += 2 * slot;
        dst_halo += halo_slot;
      }
    }
    cp_async::commit();
  };
  stage(0);
  stage(1);
  // read while the first chunks are in flight
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float bar_b = -bar[b];
  const float inj0 = (l0 == tgt_b - 1) ? bar_b : 0.0f;
  const float inj1 = (l0 + 1 == tgt_b - 1) ? bar_b : 0.0f;
  const float in0 = (l0 < tgt_b) ? 1.0f : 0.0f;
  const float in1 = (l0 + 1 < tgt_b) ? 1.0f : 0.0f;
  const bool wide = n_warps > 1;
  const bool takes_next = lane == 31 && warp + 1 < n_warps;
  // this warp's exchange slot and the next warp's; a step uses the row at
  // offset x_row, toggled a step
  float* x_mine = xch + warp;
  const float* x_next = xch + warp + 1;
  int x_row = 0;

  float g0 = 0.0f, g1 = 0.0f;  // g[t+1, b, l0], g[t+1, b, l0+1]
  float* out = g + static_cast<size_t>(T - 1) * row_stride +
               static_cast<size_t>(b) * L + l0;  // g[t, b, l0], t = T-1 first
  for (int c = 0; c < chunk_count; ++c) {
    const int lo = lo_of(c);
    const int n = T - c * kChunk - lo;
    const int u = (c & 1) * kChunk;
    cp_async::wait<1>();  // this lane's copies of chunk c have landed
    float a0[kChunk], a1[kChunk], h[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float v0 = smem[((u + k) * 2) * nt + i];
      const float v1 = smem[((u + k) * 2 + 1) * nt + i];
      a0[k] = (real0 && k < n) ? v0 : kNegSentinel;
      a1[k] = (real1 && k < n) ? v1 : kNegSentinel;
      h[k] = halo[(u + k) * n_warps + warp];  // lane 0's halo cell
    }
    stage(c + 2);  // into the buffer this lane has read
    float w_stay0[kChunk], w_adv0[kChunk], w_stay1[kChunk], w_adv1[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float left = __shfl_up_sync(kFullMask, a1[k], 1);
      const float a_lm1 =
          (l0 == 0) ? kNegSentinel : ((lane == 0) ? h[k] : left);
      const float w0 = sigmoid(a0[k] - a_lm1);
      const float w1 = sigmoid(a1[k] - a0[k]);
      w_stay0[k] = w0 * in0;
      w_adv0[k] = (1.0f - w0) * in0;
      w_stay1[k] = w1 * in1;
      w_adv1[k] = (1.0f - w1) * in1;
    }
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      if (k < n) {
        const int t = lo + k;
        const bool at_inject = t == t_inject;
        float prop0 = 0.0f, prop1 = 0.0f;
        if (t < T - 1) {
          const float x = g0 * w_adv0[k];
          float right = __shfl_down_sync(kFullMask, x, 1);
          if (wide) {
            if (lane == 0) x_mine[x_row] = x;
            __syncthreads();
            if (takes_next) right = x_next[x_row];
            x_row = n_warps - x_row;
          }
          const float stay0 = g0 * w_stay0[k];
          const float stay1 = g1 * w_stay1[k];
          prop0 = stay0 + (real1 ? g1 * w_adv1[k] : 0.0f);
          prop1 = stay1 + ((l0 + 2 < L) ? right : 0.0f);
        }
        g0 = (at_inject ? inj0 : 0.0f) + prop0;
        g1 = (at_inject ? inj1 : 0.0f) + prop1;
        if (real0) out[0] = g0;
        if (real1) out[1] = g1;
        out -= row_stride;
      }
    }
  }
}

// The whole-lattice backward's layouts (kLayout), picked by the wrapper's
// plan (ops/lattice_cuda.py::backward_plan, BACKWARD_LAYOUTS):
constexpr int kRowsLayout = 0;   // noblank_backward_rows
constexpr int kWarpsLayout = 1;  // noblank_backward_warps<kChunk>
// noblank_backward_chunked<kChunk, false, true>
constexpr int kChunksWarpLayout = 2;
// the widest row of the warps layout: two cells a lane, 16 warps
constexpr int kBackwardWarpsWidth = 1024;
// the warps layout's halo cells (before a warp's first) and exchange slots
// a warp
constexpr int kBackwardHalo = 1;
constexpr int kBackwardExchange = 1;

// The most threads a block of each layout may have (its launch bounds).
__host__ __device__ constexpr int backward_max_threads(int layout) {
  return layout == kRowsLayout ? 1024 : 512;
}

template <int kLayout, int kChunk>
__global__ void __launch_bounds__(backward_max_threads(kLayout))
    noblank_backward_kernel(const float* __restrict__ alpha,
                            const int* __restrict__ inlen,
                            const int* __restrict__ tgt,
                            const float* __restrict__ bar,
                            float* __restrict__ g, int T, int B, int L) {
  if constexpr (kLayout == kWarpsLayout) {
    noblank_backward_warps<kChunk>(alpha, inlen, tgt, bar, g, T, B, L);
  } else if constexpr (kLayout == kChunksWarpLayout) {
    noblank_backward_chunked<kChunk, false, true>(
        alpha, inlen, tgt, bar, nullptr, nullptr, nullptr, g, nullptr,
        nullptr, T, B, L);
  } else {
    noblank_backward_rows(alpha, inlen, tgt, bar, g, T, B, L);
  }
}

// One T-shard's reverse recursion and the gradients of both init rows, in
// one launch (noblank_backward_chunked<kChunk, true>).
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
  noblank_backward_chunked<kChunk, true>(alpha, inlen, tgt, bar, g_seed,
                                         stay0, adv0, g, d_stay0, d_adv0, T,
                                         B, L);
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// Shared bytes of a whole-lattice forward block in layout `layout`: the
// warp layout's em ring, depth slots a thread; the pairs layout's ring of
// two cells a thread and its two exchange rows; the block layout's
// shard_forward_floats_per_cell floats a cell; the rows layout's two rows.
size_t forward_bytes(int layout, int L, int depth, int threads) {
  const size_t n = static_cast<size_t>(threads);
  const size_t ring = static_cast<size_t>(depth) * n;
  switch (layout) {
    case kForwardWarp:
      return sizeof(float) * ring;
    case kForwardPairs:
      return sizeof(float) * 2 * (ring + (n / 32) * kForwardExchange);
    case kForwardBlock:
      return sizeof(float) * static_cast<size_t>(L) *
             shard_forward_floats_per_cell(depth);
    default:
      return sizeof(float) * 2 * static_cast<size_t>(L);
  }
}

// Whether a block of `threads` in `layout` fits rows of L cells: the warp
// layout takes rows of up to one warp (threads / 32 samples a block), the
// pairs layout rows of up to kForwardPairsWidth cells, two a lane, in
// whole warps; the block and rows layouts stride over any row.
bool forward_threads_fit(int layout, int L, int threads) {
  switch (layout) {
    case kForwardWarp:
      return L <= 32;
    case kForwardPairs:  // the pairs of cells -1 .. L-1
      return L <= kForwardPairsWidth && threads == 32 * ((L + 64) / 64);
    default:
      return true;
  }
}

// The pairs layout reads em and writes alpha in 8-byte pairs: both bases
// 8-byte aligned (the wrapper copies an em that is not).
bool pairs_aligned(const float* em, const float* alpha) {
  return ((reinterpret_cast<uintptr_t>(em) |
           reinterpret_cast<uintptr_t>(alpha)) & 7) == 0;
}

template <int kLayout, int kDepth>
cudaError_t launch_forward_layout(const float* em, const int* inlen,
                                  const int* tgt, float* alpha, float* nll,
                                  int T, int B, int L, int threads,
                                  size_t smem, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(noblank_forward_kernel<kLayout, kDepth>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // the warp layout: a sample a warp
  const int per_block = kLayout == kForwardWarp ? threads / 32 : 1;
  const int grid = (B + per_block - 1) / per_block;
  noblank_forward_kernel<kLayout, kDepth><<<grid, threads, smem, stream>>>(
      em, inlen, tgt, alpha, nll, T, B, L);
  return cudaGetLastError();
}

// The plan (layout, depth, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::forward_plan).  A layout or ring depth the kernel
// is not built for, a block past the layout's launch bounds or that does
// not fit the row (forward_threads_fit), or shared bytes that do not match
// the layout are refused.
cudaError_t launch_forward(const float* em, const int* inlen, const int* tgt,
                           float* alpha, float* nll, int T, int B, int L,
                           int layout, int depth, int threads, int smem,
                           cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  if (layout < kForwardRows || layout > kForwardBlock || threads < 32 ||
      threads % 32 != 0 || threads > forward_max_threads(layout) ||
      !forward_threads_fit(layout, L, threads) ||
      bytes != forward_bytes(layout, L, depth, threads) ||
      (layout == kForwardPairs && !pairs_aligned(em, alpha))) {
    return cudaErrorInvalidValue;
  }
  switch (layout * 16 + depth) {
    case kForwardWarp * 16 + 8:
      return launch_forward_layout<kForwardWarp, 8>(
          em, inlen, tgt, alpha, nll, T, B, L, threads, bytes, stream);
    case kForwardPairs * 16 + 8:
      return launch_forward_layout<kForwardPairs, 8>(
          em, inlen, tgt, alpha, nll, T, B, L, threads, bytes, stream);
    case kForwardBlock * 16 + 8:
      return launch_forward_layout<kForwardBlock, 8>(
          em, inlen, tgt, alpha, nll, T, B, L, threads, bytes, stream);
    case kForwardBlock * 16 + 2:
      return launch_forward_layout<kForwardBlock, 2>(
          em, inlen, tgt, alpha, nll, T, B, L, threads, bytes, stream);
    case kForwardRows * 16 + 0:
      return launch_forward_layout<kForwardRows, 0>(
          em, inlen, tgt, alpha, nll, T, B, L, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kDepth, int kHalo>
cudaError_t launch_shard_forward_kernel(
    const float* em, const int* inlen, const int* tgt, const float* stay0,
    const float* adv0, float* alpha, float* final_out, float* boundary,
    int T, int B, int L, int em_stride, int threads, size_t smem,
    cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(
      noblank_shard_forward_kernel<kDepth, kHalo>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  noblank_shard_forward_kernel<kDepth, kHalo><<<B, threads, smem, stream>>>(
      em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
      em_stride);
  return cudaGetLastError();
}

// The plan (depth, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::shard_forward_plan).  Rows of up to
// kWarpsMaxWidth cells take the warps layout, with warps_threads(L)
// threads and the ring and exchange rows in shared memory; wider rows take
// the block layout, whose block holds the ring and the carried rows.  A
// depth the kernels are not built for, or threads or shared bytes that do
// not match the layout, are refused.
cudaError_t launch_shard_forward(const float* em, const int* inlen,
                                 const int* tgt, const float* stay0,
                                 const float* adv0, float* alpha,
                                 float* final_out, float* boundary, int T,
                                 int B, int L, int em_stride, int depth,
                                 int threads, int smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  const bool warps = L <= kWarpsMaxWidth;
  const size_t want =
      warps ? sizeof(float) * (static_cast<size_t>(depth) * threads + 2 * L)
            : sizeof(float) * static_cast<size_t>(L) *
                  shard_forward_floats_per_cell(depth);
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || bytes != want ||
      (warps && threads != warps_threads(L))) {
    return cudaErrorInvalidValue;
  }
  // the layout: 0 block, 1 one warp, 2 warps with halo lanes
  const int layout = !warps ? 0 : (L <= 32 ? 1 : 2);
  switch (depth * 4 + layout) {
    case 8 * 4 + 0:
      return launch_shard_forward_kernel<8, -1>(
          em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
          em_stride, threads, bytes, stream);
    case 8 * 4 + 1:
      return launch_shard_forward_kernel<8, 0>(
          em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
          em_stride, threads, bytes, stream);
    case 8 * 4 + 2:
      return launch_shard_forward_kernel<8, kWarpsHalo>(
          em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
          em_stride, threads, bytes, stream);
    case 2 * 4 + 0:
      return launch_shard_forward_kernel<2, -1>(
          em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
          em_stride, threads, bytes, stream);
    case 2 * 4 + 1:
      return launch_shard_forward_kernel<2, 0>(
          em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
          em_stride, threads, bytes, stream);
    case 2 * 4 + 2:
      return launch_shard_forward_kernel<2, kWarpsHalo>(
          em, inlen, tgt, stay0, adv0, alpha, final_out, boundary, T, B, L,
          em_stride, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared bytes of a whole-lattice backward block in layout `layout`: the
// warps layout's staging columns, halo cells and exchange slots; the
// chunks-warp layout's chunked_floats_per_cell floats a cell; the rows
// layout's two rows.
size_t backward_bytes(int layout, int L, int chunk, int threads) {
  if (layout == kWarpsLayout) {
    const size_t warps = threads / 32;
    return sizeof(float) * 2 *
           (static_cast<size_t>(chunk) *
                (2 * threads + warps * kBackwardHalo) +
            warps * kBackwardExchange);
  }
  if (layout == kChunksWarpLayout) {
    return sizeof(float) * static_cast<size_t>(L) *
           chunked_floats_per_cell(chunk);
  }
  return sizeof(float) * 2 * static_cast<size_t>(L);
}

// Whether a block of `threads` in `layout` fits rows of L cells: the
// warps layout takes a row of up to kBackwardWarpsWidth cells, two a
// lane, in whole warps; the chunks-warp layout rows of up to one warp.
bool threads_fit(int layout, int L, int threads) {
  if (layout == kWarpsLayout) {
    return L <= kBackwardWarpsWidth && threads == 32 * ((L + 63) / 64);
  }
  return layout != kChunksWarpLayout || L <= 32;
}

template <int kLayout, int kChunk>
cudaError_t launch_backward_layout(const float* alpha, const int* inlen,
                                   const int* tgt, const float* bar, float* g,
                                   int T, int B, int L, int threads,
                                   size_t smem, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(noblank_backward_kernel<kLayout, kChunk>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  noblank_backward_kernel<kLayout, kChunk><<<B, threads, smem, stream>>>(
      alpha, inlen, tgt, bar, g, T, B, L);
  return cudaGetLastError();
}

// The plan (layout, chunk, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::backward_plan).  A layout or chunk the kernel is
// not built for, a block past the layout's launch bounds or that does not
// fit the row (threads_fit), or shared bytes that do not match the layout
// are refused.
cudaError_t launch_backward(const float* alpha, const int* inlen,
                            const int* tgt, const float* bar, float* g, int T,
                            int B, int L, int layout, int chunk, int threads,
                            int smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  if (layout < kRowsLayout || layout > kChunksWarpLayout || threads < 32 ||
      threads % 32 != 0 || threads > backward_max_threads(layout) ||
      !threads_fit(layout, L, threads) ||
      bytes != backward_bytes(layout, L, chunk, threads)) {
    return cudaErrorInvalidValue;
  }
  switch (layout * 32 + chunk) {
    case kWarpsLayout * 32 + 8:
      return launch_backward_layout<kWarpsLayout, 8>(
          alpha, inlen, tgt, bar, g, T, B, L, threads, bytes, stream);
    case kChunksWarpLayout * 32 + 16:
      return launch_backward_layout<kChunksWarpLayout, 16>(
          alpha, inlen, tgt, bar, g, T, B, L, threads, bytes, stream);
    case kRowsLayout * 32 + 0:
      return launch_backward_layout<kRowsLayout, 0>(
          alpha, inlen, tgt, bar, g, T, B, L, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
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

// Writes alpha [T, B, L] and nll [B]; layout, depth, threads and smem are
// the wrapper's plan.
cudaError_t noblank_lattice_forward(const float* em, const int* inlen,
                                    const int* tgt, float* alpha, float* nll,
                                    int T, int B, int L, int layout,
                                    int depth, int threads, int smem,
                                    cudaStream_t stream) {
  return launch_forward(em, inlen, tgt, alpha, nll, T, B, L, layout, depth,
                        threads, smem, stream);
}

// layout, chunk, threads and smem are the wrapper's plan.
cudaError_t noblank_lattice_backward(const float* alpha, const int* inlen,
                                     const int* tgt, const float* nll_bar,
                                     float* g, int T, int B, int L,
                                     int layout, int chunk, int threads,
                                     int smem, cudaStream_t stream) {
  return launch_backward(alpha, inlen, tgt, nll_bar, g, T, B, L, layout,
                         chunk, threads, smem, stream);
}

// One T-shard: inlen is shard-local, stay0 / adv0 are the [B, L] init
// rows; writes alpha [T, B, L], final [B] and the boundary row [B, L].  em
// is read with em_stride floats between its rows (samples contiguous);
// depth, threads and smem are the wrapper's plan.
cudaError_t noblank_shard_forward(const float* em, const int* inlen,
                                  const int* tgt, const float* stay0,
                                  const float* adv0, float* alpha,
                                  float* final_out, float* boundary, int T,
                                  int B, int L, int em_stride, int depth,
                                  int threads, int smem,
                                  cudaStream_t stream) {
  return launch_shard_forward(em, inlen, tgt, stay0, adv0, alpha, final_out,
                              boundary, T, B, L, em_stride, depth, threads,
                              smem, stream);
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
