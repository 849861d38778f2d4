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
// The first kernels' design (that of noblank_lattice.cu), kept as the rows
// layout of both whole-lattice kernels for the widest rows: one thread
// block per sample b, threads across the slots s (strided when S exceeds
// the block), the carried row in a shared-memory double buffer, one
// __syncthreads a step, the sample's skip row staged in shared memory once.
//
// The whole-lattice forward (blank_forward_kernel<kLayout, kDepth>, entry
// blank_lattice_forward) first ran that loop with em[t] read inside each
// step: 4.3 us at T=10, B=256, S=11 and 0.067 ms at T=128, B=1024, S=41,
// and the op gathered the NLL after it with about twenty torch kernels.  It
// now writes nll[b] = -logaddexp(alpha[t_f, b, 2 tgt], alpha[t_f, b, 2 tgt
// - 1]) (the first cell alone when tgt = 0; 0 where inlen lies outside [1,
// T]) itself, stages em on a per-thread cp.async ring 8 rows ahead, and has
// noblank_lattice.cu's layouts by width: warp up to 32 slots (a sample a
// warp, the two final cells joined by __shfl_sync), pairs to 1024 (two
// slots a lane, three neighbours from two shuffles, T unrolled by the
// ring's depth; 4-byte copies: 8-byte pairs, timed at S=41 with another
// log-add, ran 0.0499 against 0.0385 ms), block while its ring fits (8
// rows to 5669 slots, 2 to 13672), rows to the 25827 slots the first kernel
// took.  Its three-way log-add is logaddexp3_flat, libm's bit for bit with
// log1pf's branch taken out (log1p_unit, log_add.cuh).  Measured (NVIDIA H100 80GB HBM3,
// 700.00 W; python -m ctc_tpu_torch.probes.lattice_ab --pass forward,
// median of 5 profiler windows, in turns with the first kernel, max |dev|
// 0.0): 3.81 us at S=11 (4.23 before, 0.90x) and 0.0416 ms at S=41 (0.0678
// before, 0.61x; 31% of the bytes bound: one warp a sample, the log-adds'
// chain binds, 22.3 us without them in lattice_ab --builds).
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
// The whole-lattice backward (blank_backward_kernel<kLayout, kChunk>,
// entry blank_lattice_backward) first had that design too: each step
// loaded alpha[t] at s-2 .. s+2 after the step before's barrier and ran
// three three-way log-adds and three expf a slot (a slot's lse three
// times, ~15 transcendentals) before its multiply-adds: 9.8 us at T=10,
// B=256, S=11 and 0.160 ms at T=128, B=1024, S=41, against bounds of 0.07
// and 12.9 us.  It now has the layouts of noblank_lattice.cu's backward,
// picked by width (ops/lattice_cuda.py::backward_plan): chunks-warp up to
// 32 slots (128 threads stage and weight a 16-row chunk, one log-add and
// three expf a slot, the rows side by side; one warp steps with shuffles
// by 1 and 2), warps from 33 to 1024 slots (two slots a lane: three
// shuffles serve both, as a skip reaches only the next lane; S=41 is one
// warp, no barrier) and rows, the first kernel's row loop, beyond them to
// the 25827 slots it took (the shard backward's chunked body at 512
// threads and 4- or 1-row chunks, as it would run past 1024 slots, lost
// to it at S=41: 0.191 and 0.354 ms against 0.167 on the card below,
// lattice_ab --plans).  Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// python -m ctc_tpu_torch.probes.lattice_ab, median of 5 profiler
// windows, in turns with the first kernel): 3.71 us at S=11 (9.79 before, 0.379x) and
// 0.0680 ms at S=41 (0.1597 before, 0.426x).  A first design that
// weighted a chunk's rows lane by lane in one warp ran 5.4-6.3 us at S=11:
// two dependent log1pf a row, ten rows one after another.
//
// The shard forward (blank_shard_forward_kernel<kDepth, kHalo>, entry
// blank_shard_forward; replaces
// blank_lattice_pallas.py:_forward_kernel_boundary) runs one T-shard from
// the lattice's two boundaries: the carry starts from the row init0[b] and
// the skip source of local t = 0 is the row skip0[b] (the carry at every
// later step).  The same launch writes final[b], the log-add of the cells
// 2 tgt and 2 tgt - 1 (the first alone when tgt = 0; indices clamped) at
// local row inlen - 1, 0 unless 1 <= inlen <= T, and the boundary row
// alpha[T-1, b]; it reads the pipeline's batch slice of em in place.  It
// has noblank_lattice.cu's design, for the same reason (T dependent steps
// bind it, not bytes: 0.17 and 0.48 us of bound at [16, 64, 65] and [1024,
// 4, 49]): the warps layout up to kWarpsMaxWidth = 512 slots, a lane a slot
// with its skip permission in a register, the advance and skip sources
// from the lanes one and two before by __shfl_up_sync; a wider row takes
// warps that own 16 slots and carry the kHalo = 16 before them, which go
// stale two lanes a step and are refreshed every 8 steps; em on the
// per-thread cp.async ring; steps 0 and T-1 peeled; the block layout
// beyond 512 slots.  The two final cells may lie in different warps: their
// owners write them to shared memory and thread 0 log-adds them after the
// last barrier.  A step carries two dependent log-adds (~60 dependent
// instructions), and the earlier kernel's step (~575-630 SM cycles at 1980
// MHz) was already close to that chain, so the redesign gains little here.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; python -m
// ctc_tpu_torch.probes.shard_ab, median of 5 profiler windows): 6.127 us
// at [16, 64, 65] in five warps (6.077 before: 0.8% slower) and 0.2877 ms
// at [1024, 4, 49] in four (0.2999 before).
//
// The shard backward (blank_shard_backward_kernel) adds the cotangent of
// the outgoing boundary row, g_seed[b], at the last local row, injects the
// final cells with +bar times their softmax (the op returns the final
// log-prob), and also returns the init rows' gradients.  It has the design
// of noblank_lattice.cu's shard backward, for the same reason: T dependent
// steps bind it, not bytes (15.0 us and 0.912 ms of device time at [16,
// 64, 65] and [1024, 4, 49] against bounds of 0.19 and 0.48 us, NVIDIA H100
// 80GB HBM3, 700.00 W; python -m ctc_tpu_torch.probes.shard_ab, the kernel
// before this design), and here each step of the whole-lattice loop
// loaded alpha at s-2 .. s+2 and ran three three-way log-adds and three
// expf (about 15 transcendentals a cell) before its multiply-adds.  So:
//   - alpha is staged by cp.async in chunks of kChunk rows walking T down,
//     two buffers; the __syncthreads after each chunk's wait publishes the
//     chunk to the block (weights read neighbouring slots).
//   - the three branch weights into each slot (stay, advance from s-1,
//     skip from s-2: exp(source - lse), masked sources at the sentinel)
//     are computed once per slot for all the chunk's rows, 2 log1pf and 5
//     expf a slot, by the whole 512-thread block into shared memory, then
//     one barrier; a step reads g at s, s+1, s+2 and three weights and
//     does the multiply-adds only, then one __syncthreads.
//   - the init rows' gradients (ops/blank_lattice_cuda.py::init_row_grads)
//     are row -1: its weights read stay and advance off init0[b] and skip
//     off skip0[b]; d_init0 / d_skip0 come from g[0] after the last
//     barrier.
// Measured (same card and script): 7.49 us at [16, 64, 65] (15.04 before)
// and 0.3086 ms at [1024, 4, 49] (0.9075 before); a step costs ~0.30 us
// at long T.
// The plan (ops/lattice_cuda.py::shard_backward_plan) takes kChunk 16 up to
// S = 658, 4 up to 2057, 1 up to 4385 (which covers S = 4097, L = 2048),
// and refuses wider rows before any launch.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "log_add.cuh"

namespace {

constexpr float kNeg = -1.0e30f;

__device__ __forceinline__ float logaddexp3(float stay, float adv,
                                            float skip) {
  return logaddexp(logaddexp(stay, adv), skip);
}

__device__ __forceinline__ float logaddexp3_flat(float stay, float adv,
                                                 float skip) {
  return logaddexp_flat(logaddexp_flat(stay, adv), skip);
}

// The final-cell injection of one sample: bar times the softmax of alpha's
// two final cells at row t_inject (indices clamped into the lattice), on
// s = 2 tgt and (tgt > 0) s = 2 tgt - 1.  Every thread reads the same two
// cells.
struct FinalInject {
  int s_a, s_b;
  bool has_label;
  float inj_a, inj_b;

  __device__ FinalInject(const float* alpha_b, size_t row_stride, int T,
                         int S, int t_inject, int tgt_b, float bar) {
    const int t_f = min(max(t_inject, 0), T - 1);
    s_a = min(max(2 * tgt_b, 0), S - 1);
    s_b = min(max(2 * tgt_b - 1, 0), S - 1);
    has_label = tgt_b > 0;
    const float* alpha_f = alpha_b + static_cast<size_t>(t_f) * row_stride;
    const float a_a = alpha_f[s_a];
    const float a_b = alpha_f[s_b];
    const float lse_f = has_label ? logaddexp(a_a, a_b) : a_a;
    inj_a = bar * expf(a_a - lse_f);
    inj_b = has_label ? bar * expf(a_b - lse_f) : 0.0f;
  }

  __device__ float at(int s) const {
    return ((s == s_a) ? inj_a : 0.0f) +
           ((has_label && s == s_b) ? inj_b : 0.0f);
  }
};

// The whole-lattice forward:
//   alpha[t, b, s] = em[t, b, s] + logaddexp3(alpha[t-1, b, s],
//       alpha[t-1, b, s-1], skip_ok[b, s] && t > 0 ? alpha[t-1, b, s-2] : NEG)
// with alpha(-1) = 0 at s = 0 and NEG elsewhere, and
//   nll[b] = -logaddexp(alpha[t_f, b, 2 tgt], alpha[t_f, b, 2 tgt - 1])
// (the first cell alone when tgt[b] = 0; indices clamped into the row),
// t_f = inlen[b] - 1, and 0 where inlen[b] lies outside [1, T] (the
// wrapper's gather_nll).
//
// The rows layout (the first design, for rows wider than the block layout
// takes): one block a sample, the carried row in a shared double buffer,
// em[t] read from device memory inside the step, one __syncthreads a step;
// after the barrier of step inlen - 1, thread 0 reads the two final cells
// off the carried row (no other shared memory: the widest row fills the
// 227 KB).
__device__ __forceinline__ void blank_forward_rows(
    const float* __restrict__ em, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    float* __restrict__ alpha, float* __restrict__ nll, int T, int B,
    int S) {
  extern __shared__ float rows[];  // [2][S] floats, then [S] skip bytes
  unsigned char* skip_sh = reinterpret_cast<unsigned char*>(rows + 2 * S);
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int s_a = min(max(2 * tgt_b, 0), S - 1);
  const int s_b = min(max(2 * tgt_b - 1, 0), S - 1);
  const size_t row_stride = static_cast<size_t>(B) * S;
  const float* em_b = em + static_cast<size_t>(b) * S;
  float* alpha_b = alpha + static_cast<size_t>(b) * S;
  const unsigned char* skip_b = skip + static_cast<size_t>(b) * S;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    rows[s] = (s == 0) ? 0.0f : kNeg;
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
      const float skp = (s >= 2 && skip_sh[s] && t > 0) ? cur[s - 2] : kNeg;
      const float a = logaddexp3_flat(stay, adv, skp) + e;
      alpha_t[s] = a;
      nxt[s] = a;
    }
    __syncthreads();
    // alpha[t] stays in nxt until step t + 2 writes it, after the barrier
    // of step t + 1, which thread 0 reaches only after this read
    if (t == t_fin && threadIdx.x == 0) {
      nll[b] = tgt_b > 0 ? -logaddexp(nxt[s_a], nxt[s_b]) : -nxt[s_a];
    }
  }
  if (t_fin < 0 && threadIdx.x == 0) nll[b] = 0.0f;
}

// Shared memory of the shard forward, in floats per slot s: the carried
// alpha double buffer and the em ring of kDepth rows; then one skip byte
// per slot.
__host__ __device__ constexpr int shard_forward_floats_per_cell(int depth) {
  return 2 + depth;
}

// A compile-time flag passed to the step lambdas (which step is peeled).
template <bool kValue>
struct Flag {
  static constexpr bool value = kValue;
};

// The warps layout of the shard forward (rows of up to kWarpsMaxWidth
// slots): one lane per slot.  A row of up to 32 slots is one warp.  A wider
// row takes 32-lane warps of which warp w owns the kOwn = 32 - kWarpsHalo slots
// from w * kOwn on, and carries the kWarpsHalo slots before them (the last ones
// of warp w-1) in its first lanes.
constexpr int kWarpsHalo = 16;
constexpr int kOwn = 32 - kWarpsHalo;
constexpr int kWarpsMaxWidth = 32 * kOwn;  // 32 warps of a 1024-thread block
constexpr unsigned kFullMask = 0xffffffffu;

// The threads of the warps layout at width S.
__host__ __device__ constexpr int warps_threads(int S) {
  return S <= 32 ? 32 : 32 * ((S + kOwn - 1) / kOwn);
}

// The shard forward of blank_shard_forward_block (below) in the warps
// layout (that of noblank_lattice.cu's shard forward): each lane keeps its
// slot of the carried row and its skip permission in registers and takes
// its advance and skip sources from the lanes one and two before it by
// __shfl_up_sync, so a step has no barrier and no shared-memory row.  A
// warp's first lanes lack those sources, so after j steps its first 2j
// lanes are stale; the kHalo = 16 halo lanes are refreshed from their
// owners every kHalo / 2 steps, through shared memory and one barrier
// (none in a one-warp row).  em comes through the per-thread cp.async ring
// (kDepth slots a thread); the init rows and the skip mask come into
// registers with the first group.  Only a slot's owner stores it; the two
// final cells go through shared memory to thread 0.
//
// kWhole runs the whole lattice instead (the forward's warp layout, rows of
// up to 32 slots, kHalo 0): a sample a warp, blockDim.x / 32 samples a
// block; the carry starts at 0 at s = 0 and the sentinel elsewhere, made in
// registers, the advance source of t = 0 is that carry shifted and its skip
// source the sentinel, no boundary row is written, and final_out is nll: at
// the final step the lane of slot 2 tgt takes the other final cell by
// __shfl_sync and writes nll[b], lane 0 the 0 of a sample whose inlen lies
// outside [1, T].
template <int kDepth, int kHalo, bool kWhole = false>
__device__ __forceinline__ void blank_shard_forward_warps(
    const float* __restrict__ em, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    const float* __restrict__ init0, const float* __restrict__ skip0,
    float* __restrict__ alpha, float* __restrict__ final_out,
    float* __restrict__ boundary, int T, int B, int S, int em_stride) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  static_assert(!kWhole || kHalo == 0, "the whole lattice: one-warp rows");
  extern __shared__ float smem[];
  __shared__ float fin[2];  // alpha at the two final cells
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int b = kWhole ? blockIdx.x * (nt >> 5) + (tid >> 5) : blockIdx.x;
  if (kWhole && b >= B) return;  // warps past the batch
  // this lane's slot
  const int s = kWhole ? lane : (tid >> 5) * (32 - kHalo) - kHalo + lane;
  const bool real = s >= 0 && s < S;
  const bool owner = real && lane >= kHalo;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int s_fa = min(max(2 * tgt_b, 0), S - 1);
  const int s_fb = min(max(2 * tgt_b - 1, 0), S - 1);
  const bool fin_a = owner && s == s_fa;
  const bool fin_b = owner && s == s_fb;
  const size_t b_off = static_cast<size_t>(b) * S;
  const size_t row_stride = static_cast<size_t>(B) * S;

  // the next unstaged step's em slot of this thread -> its ring slot (this
  // thread's column of the [kDepth][nt] ring, slot bytes apart)
  const unsigned ring_s = cp_async::shared_address(smem + tid);
  const unsigned slot = 4 * nt;
  const float* src = em + b_off + s;
  int staged = 0;
  auto stage = [&]() {
    if (staged < T) {
      if (real) cp_async::copy4(ring_s + (staged & (kDepth - 1)) * slot, src);
      src += em_stride;
    }
    cp_async::commit();
    ++staged;
  };

  // the carried slot, its skip permission, and step 0's advance and skip
  // sources init0[b, s-1] and skip0[b, s-2]
  float a = kWhole ? ((s == 0) ? 0.0f : kNeg)
                   : (real ? init0[b_off + s] : kNeg);
  // (four independent loads: skip0's is not made to wait for the mask's)
  const bool skip_s = real && s >= 2 && skip[b_off + s];
  const float adv_first =
      kWhole ? ((s == 1) ? 0.0f : kNeg)
             : ((real && s >= 1) ? init0[b_off + s - 1] : kNeg);
  const float skip0_s =
      (!kWhole && real && s >= 2) ? skip0[b_off + s - 2] : kNeg;
  const float skip_first = skip_s ? skip0_s : kNeg;
  if (kWhole && t_fin < 0 && s == 0) final_out[b] = 0.0f;
  float* out = alpha + b_off + s;
  auto step = [&](int t, auto first, auto last) {
    float adv, skp;
    if constexpr (decltype(first)::value) {
      adv = adv_first;
      skp = skip_first;
    } else {
      const float left1 = __shfl_up_sync(kFullMask, a, 1);
      const float left2 = __shfl_up_sync(kFullMask, a, 2);
      adv = (s >= 1) ? left1 : kNeg;
      skp = skip_s ? left2 : kNeg;
    }
    const float e = cp_async::load(ring_s + (t & (kDepth - 1)) * slot);
    if (real) {
      a = (kWhole ? logaddexp3_flat(a, adv, skp) : logaddexp3(a, adv, skp)) +
          e;
      if (owner) {
        *out = a;
        if (!kWhole && t == t_fin) {
          if (fin_a) fin[0] = a;
          if (fin_b) fin[1] = a;
        }
        if constexpr (!kWhole && decltype(last)::value) {
          boundary[b_off + s] = a;
        }
      }
    }
    if constexpr (kWhole) {
      if (t == t_fin) {  // the same step in every lane of the sample's warp
        const float cell_b = __shfl_sync(kFullMask, a, s_fb);
        if (fin_a) final_out[b] = -(tgt_b > 0 ? logaddexp(a, cell_b) : a);
      }
    }
    out += row_stride;
  };

  // after step t: every kHalo / 2 steps, the halo lanes from their owners
  int refresh = kHalo / 2;  // steps until the halo lanes go stale
  int buf = 0;
  auto after = [&](int t) {
    if (kHalo > 0 && --refresh == 0 && t + 1 < T) {
      refresh = kHalo / 2;
      // the owners' slots, in one of two rows: one barrier a refresh
      float* x = smem + kDepth * nt + buf * S;
      buf ^= 1;
      if (owner) x[s] = a;
      __syncthreads();
      if (real && !owner) a = x[s];
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
  if (tid == 0) {
    final_out[b] = (t_fin < 0)   ? 0.0f
                   : tgt_b > 0 ? logaddexp(fin[0], fin[1])
                               : fin[0];
  }
}

// One T-shard's forward: the recursion above from the init rows, with the
// shard's epilogue in the same launch:
//   alpha(-1) = init0[b]; the skip source of local t = 0 is skip0[b] (the
//   carry at every later step);
//   final[b] = logaddexp(alpha[t_f, b, 2 tgt], alpha[t_f, b, 2 tgt - 1])
//   (the first cell alone when tgt[b] = 0; indices clamped into the row),
//   t_f = inlen[b] - 1, and 0 unless 1 <= inlen[b] <= T (inlen is
//   shard-local);  boundary[b] = alpha[T-1, b].
// em [T, B, S] is read through its row stride em_stride (floats between
// em[t, b] and em[t+1, b]); slots and samples are contiguous.
//
// The design of noblank_shard_forward_kernel: each thread stages its own
// slots of em into a ring of kDepth rows, kDepth - 1 steps ahead, one
// cp.async group per step, and needs no barrier for them.  Group 0 also
// brings init0[b, s] into the carry row, init0[b, s-1] into the other row
// at s and skip0[b, s-2] into ring slot kDepth-1 at s (no step's em lands
// there before step 0 is done), so step 0 (peeled) reads only this
// thread's copies; the skip mask is loaded into shared memory by the same
// thread.  The last step (peeled) writes the boundary row from registers.
// The two final cells lie in different threads' hands: each owner writes
// its cell to shared memory at its step, the step's barrier publishes
// both, and thread 0 log-adds them into final[b].  kWhole runs the whole
// lattice (the forward's block layout): the init rows are written by each
// thread at its slots, not copied, no boundary row is written, and
// final_out is nll.
template <int kDepth, bool kWhole = false>
__device__ __forceinline__ void blank_shard_forward_block(
    const float* __restrict__ em, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    const float* __restrict__ init0, const float* __restrict__ skip0,
    float* __restrict__ alpha, float* __restrict__ final_out,
    float* __restrict__ boundary, int T, int B, int S, int em_stride) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  extern __shared__ float smem[];
  float* rows = smem;          // [2][S] carried alpha
  float* ring = rows + 2 * S;  // [kDepth][S] em, step t in slot t % kDepth
  unsigned char* skip_sh =     // [S] skip_ok[b]
      reinterpret_cast<unsigned char*>(ring + kDepth * S);
  __shared__ float fin[2];     // alpha at the two final cells
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int s_a = min(max(2 * tgt_b, 0), S - 1);
  const int s_b = min(max(2 * tgt_b - 1, 0), S - 1);
  const size_t b_off = static_cast<size_t>(b) * S;
  const size_t row_stride = static_cast<size_t>(B) * S;
  float* skip_row0 = ring + (kDepth - 1) * S;  // skip0[b, s-2] at s

  // the next unstaged step's em slots of this thread -> its ring slot
  const float* src = em + b_off;
  int staged = 0;
  auto stage = [&]() {
    if (staged < T) {
      float* slot = ring + (staged & (kDepth - 1)) * S;
      for (int s = tid; s < S; s += nt) cp_async::copy4(slot + s, src + s);
      src += em_stride;
    }
    cp_async::commit();
    ++staged;
  };

  float* alpha_t = alpha + b_off;
  auto step = [&](int t, auto first, auto last) {
    const float* cur = rows + (t & 1) * S;
    float* nxt = rows + ((t + 1) & 1) * S;
    const float* e_t = ring + (t & (kDepth - 1)) * S;
    for (int s = tid; s < S; s += nt) {
      const float e = e_t[s];
      const float stay = cur[s];
      const bool skip_s = s >= 2 && skip_sh[s];
      float adv, skp;
      if constexpr (decltype(first)::value) {
        // init0[b, s-1] and skip0[b, s-2], staged by this thread
        adv = (s >= 1) ? nxt[s] : kNeg;
        skp = skip_s ? skip_row0[s] : kNeg;
      } else {
        adv = (s >= 1) ? cur[s - 1] : kNeg;
        skp = skip_s ? cur[s - 2] : kNeg;
      }
      const float a = (kWhole ? logaddexp3_flat(stay, adv, skp)
                              : logaddexp3(stay, adv, skp)) +
                      e;
      alpha_t[s] = a;
      nxt[s] = a;
      if (t == t_fin) {
        if (s == s_a) fin[0] = a;
        if (s == s_b) fin[1] = a;
      }
      if constexpr (!kWhole && decltype(last)::value) boundary[b_off + s] = a;
    }
    alpha_t += row_stride;
  };

  // group 0: step 0's em and the init rows; then steps 1 .. kDepth-2
  for (int s = tid; s < S; s += nt) {
    if constexpr (kWhole) {
      rows[s] = (s == 0) ? 0.0f : kNeg;
      rows[S + s] = (s == 1) ? 0.0f : kNeg;
      skip_row0[s] = kNeg;
    } else {
      cp_async::copy4(rows + s, init0 + b_off + s);
      if (s >= 1) cp_async::copy4(rows + S + s, init0 + b_off + s - 1);
      if (s >= 2) cp_async::copy4(skip_row0 + s, skip0 + b_off + s - 2);
    }
    skip_sh[s] = skip[b_off + s];
  }
  for (int k = 0; k + 1 < kDepth; ++k) stage();
  cp_async::wait<kDepth - 2>();  // group 0 has landed
  if (T == 1) {
    step(0, Flag<true>{}, Flag<true>{});
  } else {
    step(0, Flag<true>{}, Flag<false>{});
  }
  // also orders step 0's read of ring slot kDepth-1 before its refill
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
  if (tid == 0) {
    const float v = (t_fin < 0)   ? 0.0f
                    : tgt_b > 0 ? logaddexp(fin[0], fin[1])
                                : fin[0];
    final_out[b] = kWhole ? -v : v;
  }
}

// The shard forward kernel: the warps layout (kHalo halo lanes a warp:
// 0 for a one-warp row, kWarpsHalo for wider ones) for rows of up to
// kWarpsMaxWidth slots, else the block layout (kHalo -1).
template <int kDepth, int kHalo>
__global__ void __launch_bounds__(1024)
    blank_shard_forward_kernel(const float* __restrict__ em,
                               const unsigned char* __restrict__ skip,
                               const int* __restrict__ inlen,
                               const int* __restrict__ tgt,
                               const float* __restrict__ init0,
                               const float* __restrict__ skip0,
                               float* __restrict__ alpha,
                               float* __restrict__ final_out,
                               float* __restrict__ boundary, int T, int B,
                               int S, int em_stride) {
  if constexpr (kHalo >= 0) {
    blank_shard_forward_warps<kDepth, kHalo>(em, skip, inlen, tgt, init0,
                                             skip0, alpha, final_out,
                                             boundary, T, B, S, em_stride);
  } else {
    blank_shard_forward_block<kDepth>(em, skip, inlen, tgt, init0, skip0,
                                      alpha, final_out, boundary, T, B, S,
                                      em_stride);
  }
}

// The pairs layout of the whole-lattice forward, rows of 33 to
// kForwardPairsWidth slots (that of noblank_lattice.cu, with 4-byte copies
// and stores: 8-byte pairs, which took S=41 from 0.0385 to 0.0499 ms on
// the card, are not used here): one block a sample, two slots a lane (s0 =
// 2i and s0 + 1 of lane i, the row in whole warps), both carried slots and
// their skip permissions in registers.  Slot s0 + 1's advance source is the
// lane's own slot s0 and its skip source the lane before's slot s0 - 1;
// slot s0's advance and skip sources are the lane before's slots s0 - 1 and
// s0 - 2: two __shfl_up_sync serve both, and lane 0 of a later warp takes
// them from the warp before's lane 31 through two shared exchange slots
// (two rows, toggled a step) after one __syncthreads a step (none in a
// one-warp row).  em comes through the per-thread cp.async ring, two slots
// a thread; T runs in unrolled chunks of kDepth steps (the ring slots
// constants).  After a last barrier, thread 0 reads the two final cells
// back from alpha and writes nll[b].
template <int kDepth>
__device__ __forceinline__ void blank_forward_pairs(
    const float* __restrict__ em, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    float* __restrict__ alpha, float* __restrict__ nll, int T, int B,
    int S) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  extern __shared__ float smem[];
  const int i = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = nt >> 5;
  const int b = blockIdx.x;
  const int s0 = 2 * i;  // this lane's slots s0 and s0 + 1
  const bool real0 = s0 < S;
  const bool real1 = s0 + 1 < S;
  const int tgt_b = tgt[b];
  const int inlen_b = inlen[b];
  const int t_fin = (inlen_b >= 1 && inlen_b <= T) ? inlen_b - 1 : -1;
  const int s_a = min(max(2 * tgt_b, 0), S - 1);
  const int s_b = min(max(2 * tgt_b - 1, 0), S - 1);
  const size_t b_off = static_cast<size_t>(b) * S;
  const size_t row_stride = static_cast<size_t>(B) * S;

  // step r's two em slots of this thread (r < T; an empty group past T) ->
  // ring slot j (its two columns of the [kDepth][2][nt] ring, slot bytes
  // apart)
  const unsigned ring_s = cp_async::shared_address(smem + i);
  const unsigned slot = 4 * nt;
  const float* src = em + b_off + s0;
  auto stage = [&](int r, int j) {
    if (r < T) {
      const unsigned dst = ring_s + j * 2 * slot;
      if (real0) cp_async::copy4(dst, src);
      if (real1) cp_async::copy4(dst + slot, src + 1);
      src += row_stride;
    }
    cp_async::commit();
  };
  // groups 0 .. kDepth-1: steps 0 .. kDepth-1
  for (int k = 0; k < kDepth; ++k) stage(k, k);

  // the skip permissions, read while the first groups are in flight
  const bool skip0 = real0 && s0 >= 2 && skip[b_off + s0];
  const bool skip1 = real1 && s0 + 1 >= 2 && skip[b_off + s0 + 1];
  const bool wide = n_warps > 1;
  const bool takes_prev = lane == 0 && warp > 0;
  // the [2][n_warps][2] exchange rows after the ring: this warp's two
  // slots and the warp before's, in the row at offset x_row
  float* x_mine = smem + kDepth * 2 * nt + 2 * warp;
  const float* x_prev = x_mine - 2;
  int x_row = 0;

  float a0 = (s0 == 0) ? 0.0f : kNeg;  // alpha(-1) at s0, s0 + 1
  float a1 = kNeg;
  float* out = alpha + b_off + s0;
  // step t, whose em is in ring slot k = t % kDepth
  auto step = [&](int t, int k) {
    // step t + kDepth-1, into the slot step t-1 read
    if (t > 0) stage(t + kDepth - 1, (k + kDepth - 1) & (kDepth - 1));
    cp_async::wait<kDepth - 1>();  // step t's group has landed
    // the lane before's slots s0 - 1 and s0 - 2 (at t = 0 the carry there is
    // the sentinel, as a lane 0's own slots are)
    float left1 = __shfl_up_sync(kFullMask, a1, 1);
    float left0 = __shfl_up_sync(kFullMask, a0, 1);
    if (wide && t > 0) {
      if (lane == 31) {
        x_mine[x_row] = a0;
        x_mine[x_row + 1] = a1;
      }
      __syncthreads();
      if (takes_prev) {
        left0 = x_prev[x_row];
        left1 = x_prev[x_row + 1];
      }
      x_row = 2 * n_warps - x_row;
    }
    const bool open = t > 0;  // no skip at t = 0
    const float adv0 = (s0 >= 1) ? left1 : kNeg;
    const float skp0 = (open && skip0) ? left0 : kNeg;
    const float skp1 = (open && skip1) ? left1 : kNeg;
    const unsigned e_s = ring_s + k * 2 * slot;
    const float e0 = cp_async::load(e_s);
    const float e1 = cp_async::load(e_s + slot);
    // both slots branch-free (a lane past the row computes on whatever its
    // ring slots hold and stores nothing), so the two log-adds overlap
    const float n0 = logaddexp3_flat(a0, adv0, skp0) + e0;
    a1 = logaddexp3_flat(a1, a0, skp1) + e1;
    a0 = n0;
    if (real0) out[0] = a0;
    if (real1) out[1] = a1;
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
  __syncthreads();  // publishes the final cells, stored by their threads
  if (i == 0) {
    float v = 0.0f;
    if (t_fin >= 0) {
      const float* fin = alpha + t_fin * row_stride + b_off;
      v = tgt_b > 0 ? -logaddexp(fin[s_a], fin[s_b]) : -fin[s_a];
    }
    nll[b] = v;
  }
}

// The whole-lattice forward's layouts (kLayout), picked by the wrapper's
// plan (ops/lattice_cuda.py::forward_plan, FORWARD_LAYOUTS):
constexpr int kForwardRows = 0;   // blank_forward_rows
constexpr int kForwardWarp = 1;   // blank_shard_forward_warps<kDepth, 0, true>
constexpr int kForwardPairs = 2;  // blank_forward_pairs<kDepth>
constexpr int kForwardBlock = 3;  // blank_shard_forward_block<kDepth, true>
// the widest row of the pairs layout (two slots a lane, 16 warps) and its
// exchange slots a warp
constexpr int kForwardPairsWidth = 1024;
constexpr int kForwardExchange = 2;

// The most threads a block of each layout may have (its launch bounds):
// the warp layout 8 samples a block, the pairs layout 16 warps.
__host__ __device__ constexpr int forward_max_threads(int layout) {
  return layout == kForwardWarp ? 256 : layout == kForwardPairs ? 512 : 1024;
}

template <int kLayout, int kDepth>
__global__ void __launch_bounds__(forward_max_threads(kLayout))
    blank_forward_kernel(const float* __restrict__ em,
                         const unsigned char* __restrict__ skip,
                         const int* __restrict__ inlen,
                         const int* __restrict__ tgt,
                         float* __restrict__ alpha, float* __restrict__ nll,
                         int T, int B, int S) {
  if constexpr (kLayout == kForwardWarp) {
    blank_shard_forward_warps<kDepth, 0, true>(em, skip, inlen, tgt, nullptr,
                                               nullptr, alpha, nll, nullptr,
                                               T, B, S, B * S);
  } else if constexpr (kLayout == kForwardPairs) {
    blank_forward_pairs<kDepth>(em, skip, inlen, tgt, alpha, nll, T, B, S);
  } else if constexpr (kLayout == kForwardBlock) {
    blank_shard_forward_block<kDepth, true>(em, skip, inlen, tgt, nullptr,
                                            nullptr, alpha, nll, nullptr, T,
                                            B, S, B * S);
  } else {
    blank_forward_rows(em, skip, inlen, tgt, alpha, nll, T, B, S);
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
//
// The rows layout (the first design, for rows wider than the warps layout
// takes): one block per sample, the carried row in a shared double buffer,
// alpha[t] at s-2 .. s+2 read from device memory and the three weights
// into s, s+1 and s+2 (three three-way log-adds, three expf) computed
// inside the step, one __syncthreads a step.
__device__ __forceinline__ void blank_backward_rows(
    const float* __restrict__ alpha, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    const float* __restrict__ nll_bar, float* __restrict__ g, int T, int B,
    int S) {
  extern __shared__ float rows[];  // [2][S] floats, then [S] skip bytes
  unsigned char* skip_sh = reinterpret_cast<unsigned char*>(rows + 2 * S);
  const int b = blockIdx.x;
  const int tgt_b = tgt[b];
  const int t_inject = inlen[b] - 1;
  const float* alpha_b = alpha + static_cast<size_t>(b) * S;
  const size_t row_stride = static_cast<size_t>(B) * S;
  float* g_b = g + static_cast<size_t>(b) * S;
  const unsigned char* skip_b = skip + static_cast<size_t>(b) * S;
  const FinalInject fin(alpha_b, row_stride, T, S, t_inject, tgt_b,
                        -nll_bar[b]);

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
      const float inject = (t == t_inject) ? fin.at(s) : 0.0f;
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

// Shared memory of the chunked backward, in floats per slot s: two staged
// alpha chunks, the chunk's three weight rows per alpha row and the
// carried g double buffer; the shard backward adds the g_seed row, the two
// init rows and their three weight rows.  Then one skip byte per slot.
__host__ __device__ constexpr int chunked_floats_per_cell(int chunk) {
  return 2 * chunk + 3 * chunk + 2;
}
__host__ __device__ constexpr int shard_floats_per_cell(int chunk) {
  return chunked_floats_per_cell(chunk) + 1 + 2 + 3;
}

// The three branch weights into slot s of one step, read off the row the
// step leaves: stay and advance sources from `row`, the skip source from
// `skip_row` (the row itself, or skip0 for the init row), the sentinel
// where a source does not exist or skip_ok forbids it.
//   w[0][s] = exp(row[s] - lse),  w[1][s] = exp(row[s-1] - lse),
//   w[2][s] = exp(skip source - lse),  lse = logaddexp3 of the three.
__device__ __forceinline__ void branch_weights(const float* row,
                                               const float* skip_row,
                                               const unsigned char* skip_sh,
                                               int s, int S, float* w) {
  const float a_0 = row[s];
  const float a_m1 = (s >= 1) ? row[s - 1] : kNeg;
  const float a_skip = (s >= 2 && skip_sh[s]) ? skip_row[s - 2] : kNeg;
  const float lse = logaddexp3(a_0, a_m1, a_skip);
  w[s] = expf(a_0 - lse);
  w[S + s] = expf(a_m1 - lse);
  w[2 * S + s] = expf(a_skip - lse);
}

// The reverse recursion above with alpha staged in chunks: the chunks-warp
// layout of the whole-lattice backward (kShard false: the inject is -nll_bar[b] times the softmax, the shard pointers unused) and
// the shard backward (kShard true: the recursion with the shard's
// boundaries, the inject +bar[b] times the softmax and g_seed[b] added at
// t = T-1, and the gradients of both init rows):
//   d_init0[b, s] = g[0, s] * w_stay(-1, s) + g[0, s+1] * w_adv(-1, s+1)
//   d_skip0[b, s] = g[0, s+2] * w_skip(-1, s+2)
// (terms past S-1 are 0) where row -1's weights read stay and advance off
// init0[b] and skip off skip0[b], exactly as init_row_grads does.
//
// alpha walks down T in chunks of kChunk rows, staged into shared memory
// by cp.async one chunk ahead (two buffers); each chunk's weights are
// computed from the staged rows before its steps, so a step reads g_next
// and three weights from shared memory and does the multiply-adds only.
// With kWarpSteps (rows of up to 32 slots, not kShard) the block stages and
// weights each chunk, its rows side by side, and warp 0 alone runs the
// steps: a lane a slot, the carried g in a register, the right neighbours'
// advance and skip terms by __shfl_down_sync by 1 and 2, no barrier a
// step; the next chunk's first barrier orders its reads of the weights
// before they are overwritten.
template <int kChunk, bool kShard, bool kWarpSteps = false>
__device__ __forceinline__ void blank_backward_chunked(
    const float* __restrict__ alpha, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    const float* __restrict__ bar, const float* __restrict__ g_seed,
    const float* __restrict__ init0, const float* __restrict__ skip0,
    float* __restrict__ g, float* __restrict__ d_init0,
    float* __restrict__ d_skip0, int T, int B, int S) {
  extern __shared__ float smem[];
  float* chunks = smem;                      // [2][kChunk][S] alpha
  float* weights = chunks + 2 * kChunk * S;  // [kChunk][3][S]
  float* rows = weights + 3 * kChunk * S;    // [2][S] carried g
  float* seed = rows + 2 * S;                // [S] g_seed[b] (kShard)
  float* init = seed + S;                    // [2][S] init0[b], skip0[b]
  float* init_w = init + 2 * S;              // [3][S] row -1's weights
  unsigned char* skip_sh =                   // [S] skip_ok[b]
      reinterpret_cast<unsigned char*>(kShard ? init_w + 3 * S : seed);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int t_inject = inlen[b] - 1;
  const size_t row_stride = static_cast<size_t>(B) * S;
  const size_t b_off = static_cast<size_t>(b) * S;
  const float* alpha_b = alpha + b_off;
  float* g_b = g + b_off;
  const int n_chunks = (T + kChunk - 1) / kChunk;

  // Copies and weights spread a chunk's cells over the whole block: where a
  // row is narrower than the block, nt / S rows side by side (threads past
  // the last full row idle), else one row at a time, strided.
  const bool side_by_side = nt >= S;
  const int row_step = side_by_side ? nt / S : 1;
  const int first_row =
      side_by_side ? (tid < row_step * S ? tid / S : kChunk) : 0;
  const int first_cell = side_by_side ? tid % S : tid;
  const int cell_step = side_by_side ? S : nt;

  // chunk c holds rows [lo, hi], hi = T-1 - c*kChunk
  auto chunk_lo = [&](int c) { return max(T - (c + 1) * kChunk, 0); };
  auto stage = [&](int c) {  // chunk c -> its buffer, as one group
    if (c < n_chunks) {
      const int lo = chunk_lo(c);
      const int n = T - c * kChunk - lo;
      float* dst = chunks + (c & 1) * kChunk * S;
      for (int k = first_row; k < n; k += row_step) {
        const float* src = alpha_b + static_cast<size_t>(lo + k) * row_stride;
        for (int s = first_cell; s < S; s += cell_step) {
          cp_async::copy4(dst + k * S + s, src + s);
        }
      }
    }
    cp_async::commit();
  };

  // group 0: the seed and init rows with chunk 0; group 1: chunk 1
  for (int s = tid; s < S; s += nt) {
    if constexpr (kShard) {
      cp_async::copy4(seed + s, g_seed + b_off + s);
      cp_async::copy4(init + s, init0 + b_off + s);
      cp_async::copy4(init + S + s, skip0 + b_off + s);
    }
    skip_sh[s] = skip[b_off + s];
  }
  stage(0);
  stage(1);
  // the final-cell injection, read from device memory while chunk 0 flies
  const FinalInject fin(alpha_b, row_stride, T, S, t_inject, tgt[b],
                        kShard ? bar[b] : -bar[b]);
  float g_lane = 0.0f;  // kWarpSteps: warp 0's g[t+1, b, tid]
  for (int c = 0; c < n_chunks; ++c) {
    const int lo = chunk_lo(c);
    const int n = T - c * kChunk - lo;
    const float* a = chunks + (c & 1) * kChunk * S;
    cp_async::wait<1>();  // this thread's copies of chunk c have landed
    // This barrier publishes chunk c (and, at c = 0, the seed, init and
    // skip rows): each weight reads its neighbours' cells, copied by other
    // threads.  It also orders this chunk's weight writes after the last
    // step of chunk c-1 read the weights.
    __syncthreads();
    for (int k = first_row; k < n; k += row_step) {
      for (int s = first_cell; s < S; s += cell_step) {
        branch_weights(a + k * S, a + k * S, skip_sh, s, S,
                       weights + 3 * k * S);
      }
    }
    if (kShard && c == 0) {
      for (int s = tid; s < S; s += nt) {
        branch_weights(init, init + S, skip_sh, s, S, init_w);
      }
    }
    // publishes the weights; every read of chunk c's buffer is done
    __syncthreads();
    if constexpr (kWarpSteps) {
      stage(c + 2);  // into the buffer this chunk leaves
      if (tid < 32) {
        const bool real = tid < S;
        const float inj = fin.at(tid);
#pragma unroll
        for (int k = kChunk - 1; k >= 0; --k) {
          if (k < n) {
            const int t = lo + k;
            const float* w = weights + 3 * k * S;
            const float w_stay = real ? w[tid] : 0.0f;
            const float w_adv = real ? w[S + tid] : 0.0f;
            const float w_skip = real ? w[2 * S + tid] : 0.0f;
            const float inject = (t == t_inject) ? inj : 0.0f;
            float prop = 0.0f;
            if (t < T - 1) {
              const float right1 =
                  __shfl_down_sync(kFullMask, g_lane * w_adv, 1);
              const float right2 =
                  __shfl_down_sync(kFullMask, g_lane * w_skip, 2);
              const float stay = g_lane * w_stay;
              prop = (stay + ((tid + 1 < S) ? right1 : 0.0f)) +
                     ((tid + 2 < S) ? right2 : 0.0f);
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
      const float* g_next = rows + (step & 1) * S;
      float* g_cur = rows + ((step + 1) & 1) * S;
      const float* w = weights + 3 * k * S;
      float* g_t = g_b + static_cast<size_t>(t) * row_stride;
      for (int s = tid; s < S; s += nt) {
        float inject = (t == t_inject) ? fin.at(s) : 0.0f;
        if (kShard && t == T - 1) inject += seed[s];
        float prop = 0.0f;
        if (t < T - 1) {
          const float stay = g_next[s] * w[s];
          const float from_adv =
              (s + 1 < S) ? g_next[s + 1] * w[S + s + 1] : 0.0f;
          const float from_skip =
              (s + 2 < S) ? g_next[s + 2] * w[2 * S + s + 2] : 0.0f;
          prop = (stay + from_adv) + from_skip;
        }
        const float v = inject + prop;
        g_t[s] = v;
        g_cur[s] = v;
      }
      __syncthreads();
    }
  }
  // g[0], the row the last step wrote, published by that step's barrier
  if constexpr (kShard) {
    const float* g0 = rows + (T & 1) * S;
    for (int s = tid; s < S; s += nt) {
      const float from_adv =
          (s + 1 < S) ? g0[s + 1] * init_w[S + s + 1] : 0.0f;
      d_init0[b_off + s] = g0[s] * init_w[s] + from_adv;
      d_skip0[b_off + s] = (s + 2 < S) ? g0[s + 2] * init_w[2 * S + s + 2]
                                       : 0.0f;
    }
  }
}

// The warps layout of the whole-lattice backward, rows of 33 to
// kBackwardWarpsWidth slots (that of noblank_lattice.cu): one block a
// sample, two slots a lane (slots 2i and 2i+1 of lane i), the carried g and
// the skip permissions in registers, alpha by cp.async into the lane's own
// staging columns, chunk c+1 in flight while chunk c's steps run (lane 0 of
// each warp also stages the two slots before the warp's first, kHalo = 2).
// A chunk's weights are computed before its steps, into registers: its
// alpha rows are read first, alpha[t, 2i-1] and alpha[t, 2i-2] come from the
// lane before by __shfl_up_sync (lane 0: its halo slots), then one
// three-way log-add and three expf a slot.  A step adds slot 2i+1's advance
// term to slot 2i in the lane, and takes the next lane's advance and skip
// terms of slot 2i+2 and skip term of slot 2i+3 by three __shfl_down_sync;
// lane 31 takes the next warp's lane 0's through shared exchange slots
// (two buffers) after the step's one __syncthreads (none in a one-warp
// row).
template <int kChunk>
__device__ __forceinline__ void blank_backward_warps(
    const float* __restrict__ alpha, const unsigned char* __restrict__ skip,
    const int* __restrict__ inlen, const int* __restrict__ tgt,
    const float* __restrict__ nll_bar, float* __restrict__ g, int T, int B,
    int S) {
  extern __shared__ float smem[];
  const int i = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = nt >> 5;
  const int b = blockIdx.x;
  const int s0 = 2 * i;  // this lane's slots s0 and s0 + 1
  const bool real0 = s0 < S;
  const bool real1 = s0 + 1 < S;
  const bool stage_halo = lane == 0 && s0 > 0;  // slots s0-1 and s0-2
  const size_t row_stride = static_cast<size_t>(B) * S;
  const size_t b_off = static_cast<size_t>(b) * S;
  const float* src = alpha + b_off + s0;
  const int chunk_count = (T + kChunk - 1) / kChunk;
  // [2][kChunk][2][nt] staged slots, [2][kChunk][n_warps][2] halo slots,
  // and the [2][n_warps][3] exchange slots
  float* halo = smem + 2 * kChunk * 2 * nt;
  float* xch = halo + 2 * kChunk * n_warps * 2;
  const unsigned mine = cp_async::shared_address(smem + i);
  const unsigned mine_halo = cp_async::shared_address(halo + 2 * warp);
  const unsigned slot = 4 * nt;
  const unsigned halo_slot = 4 * 2 * n_warps;
  auto lo_of = [&](int c) { return max(T - (c + 1) * kChunk, 0); };
  auto stage = [&](int c) {  // chunk c's slots of this lane, one group
    if (c < chunk_count) {
      const int lo = lo_of(c);
      const int n = T - c * kChunk - lo;
      const float* row = src + static_cast<size_t>(lo) * row_stride;
      unsigned dst = mine + (c & 1) * kChunk * 2 * slot;
      unsigned dst_halo = mine_halo + (c & 1) * kChunk * halo_slot;
      for (int k = 0; k < n; ++k) {
        if (real0) cp_async::copy4(dst, row);
        if (real1) cp_async::copy4(dst + slot, row + 1);
        if (stage_halo) {
          cp_async::copy4(dst_halo, row - 1);
          cp_async::copy4(dst_halo + 4, row - 2);
        }
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
  const bool skip0 = real0 && s0 >= 2 && skip[b_off + s0];
  const bool skip1 = real1 && s0 + 1 >= 2 && skip[b_off + s0 + 1];
  const int t_inject = inlen[b] - 1;
  const FinalInject fin(alpha + b_off, row_stride, T, S, t_inject, tgt[b],
                        -nll_bar[b]);
  const float inj0 = fin.at(s0);
  const float inj1 = fin.at(s0 + 1);
  const bool wide = n_warps > 1;
  const bool takes_next = lane == 31 && warp + 1 < n_warps;
  // this warp's exchange slots and the next warp's; a step uses the row at
  // offset x_row, toggled a step
  float* x_mine = xch + 3 * warp;
  const float* x_next = xch + 3 * (warp + 1);
  int x_row = 0;

  float g0 = 0.0f, g1 = 0.0f;  // g[t+1, b, s0], g[t+1, b, s0+1]
  float* out = g + static_cast<size_t>(T - 1) * row_stride + b_off +
               s0;  // g[t, b, s0], t = T-1 first
  for (int c = 0; c < chunk_count; ++c) {
    const int lo = lo_of(c);
    const int n = T - c * kChunk - lo;
    const int u = (c & 1) * kChunk;
    cp_async::wait<1>();  // this lane's copies of chunk c have landed
    float a0[kChunk], a1[kChunk], h1[kChunk], h2[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float v0 = smem[((u + k) * 2) * nt + i];
      const float v1 = smem[((u + k) * 2 + 1) * nt + i];
      a0[k] = (real0 && k < n) ? v0 : kNeg;
      a1[k] = (real1 && k < n) ? v1 : kNeg;
      // lane 0's halo slots s0-1 and s0-2
      h1[k] = halo[((u + k) * n_warps + warp) * 2];
      h2[k] = halo[((u + k) * n_warps + warp) * 2 + 1];
    }
    stage(c + 2);  // into the buffer this lane has read
    float w_stay0[kChunk], w_adv0[kChunk], w_skip0[kChunk];
    float w_stay1[kChunk], w_adv1[kChunk], w_skip1[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float left1 = __shfl_up_sync(kFullMask, a1[k], 1);  // s0-1
      const float left0 = __shfl_up_sync(kFullMask, a0[k], 1);  // s0-2
      const float a_m1 = (s0 < 1) ? kNeg : ((lane == 0) ? h1[k] : left1);
      const float a_m2 = (lane == 0) ? h2[k] : left0;
      const float skip_src0 = skip0 ? a_m2 : kNeg;
      const float lse0 = logaddexp3(a0[k], a_m1, skip_src0);
      w_stay0[k] = expf(a0[k] - lse0);
      w_adv0[k] = expf(a_m1 - lse0);
      w_skip0[k] = expf(skip_src0 - lse0);
      const float skip_src1 = skip1 ? a_m1 : kNeg;
      const float lse1 = logaddexp3(a1[k], a0[k], skip_src1);
      w_stay1[k] = expf(a1[k] - lse1);
      w_adv1[k] = expf(a0[k] - lse1);
      w_skip1[k] = expf(skip_src1 - lse1);
    }
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      if (k < n) {
        const int t = lo + k;
        const bool at_inject = t == t_inject;
        float prop0 = 0.0f, prop1 = 0.0f;
        if (t < T - 1) {
          // the next lane's terms: slot s0+2's advance and skip, s0+3's skip
          const float xa = g0 * w_adv0[k];
          const float xs0 = g0 * w_skip0[k];
          const float xs1 = g1 * w_skip1[k];
          float ra = __shfl_down_sync(kFullMask, xa, 1);
          float rs0 = __shfl_down_sync(kFullMask, xs0, 1);
          float rs1 = __shfl_down_sync(kFullMask, xs1, 1);
          if (wide) {
            if (lane == 0) {
              x_mine[x_row] = xa;
              x_mine[x_row + 1] = xs0;
              x_mine[x_row + 2] = xs1;
            }
            __syncthreads();
            if (takes_next) {
              ra = x_next[x_row];
              rs0 = x_next[x_row + 1];
              rs1 = x_next[x_row + 2];
            }
            x_row = 3 * n_warps - x_row;
          }
          const float stay0 = g0 * w_stay0[k];
          const float stay1 = g1 * w_stay1[k];
          prop0 = (stay0 + (real1 ? g1 * w_adv1[k] : 0.0f)) +
                  ((s0 + 2 < S) ? rs0 : 0.0f);
          prop1 = (stay1 + ((s0 + 2 < S) ? ra : 0.0f)) +
                  ((s0 + 3 < S) ? rs1 : 0.0f);
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
constexpr int kRowsLayout = 0;   // blank_backward_rows
constexpr int kWarpsLayout = 1;  // blank_backward_warps<kChunk>
// blank_backward_chunked<kChunk, false, true>
constexpr int kChunksWarpLayout = 2;
// the widest row of the warps layout: two slots a lane, 16 warps
constexpr int kBackwardWarpsWidth = 1024;
// the warps layout's halo slots (before a warp's first) and exchange slots
// a warp
constexpr int kBackwardHalo = 2;
constexpr int kBackwardExchange = 3;

// The most threads a block of each layout may have (its launch bounds).
__host__ __device__ constexpr int backward_max_threads(int layout) {
  return layout == kRowsLayout ? 1024 : 512;
}

template <int kLayout, int kChunk>
__global__ void __launch_bounds__(backward_max_threads(kLayout))
    blank_backward_kernel(const float* __restrict__ alpha,
                          const unsigned char* __restrict__ skip,
                          const int* __restrict__ inlen,
                          const int* __restrict__ tgt,
                          const float* __restrict__ nll_bar,
                          float* __restrict__ g, int T, int B, int S) {
  if constexpr (kLayout == kWarpsLayout) {
    blank_backward_warps<kChunk>(alpha, skip, inlen, tgt, nll_bar, g, T, B,
                                 S);
  } else if constexpr (kLayout == kChunksWarpLayout) {
    blank_backward_chunked<kChunk, false, true>(
        alpha, skip, inlen, tgt, nll_bar, nullptr, nullptr, nullptr, g,
        nullptr, nullptr, T, B, S);
  } else {
    blank_backward_rows(alpha, skip, inlen, tgt, nll_bar, g, T, B, S);
  }
}

// One T-shard's reverse recursion and the gradients of both init rows, in
// one launch (blank_backward_chunked<kChunk, true>).
template <int kChunk>
__global__ void __launch_bounds__(512)
    blank_shard_backward_kernel(const float* __restrict__ alpha,
                                const unsigned char* __restrict__ skip,
                                const int* __restrict__ inlen,
                                const int* __restrict__ tgt,
                                const float* __restrict__ bar,
                                const float* __restrict__ g_seed,
                                const float* __restrict__ init0,
                                const float* __restrict__ skip0,
                                float* __restrict__ g,
                                float* __restrict__ d_init0,
                                float* __restrict__ d_skip0, int T, int B,
                                int S) {
  blank_backward_chunked<kChunk, true>(alpha, skip, inlen, tgt, bar, g_seed,
                                       init0, skip0, g, d_init0, d_skip0, T,
                                       B, S);
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

// Shared bytes of a whole-lattice forward block in layout `layout`: the
// warp layout's em ring, depth slots a thread; the pairs layout's ring of
// two slots a thread and its two exchange rows; the block layout's
// shard_forward_floats_per_cell floats and the rows layout's two rows a
// slot, each with the slot's skip byte.
size_t forward_bytes(int layout, int S, int depth, int threads) {
  const size_t n = static_cast<size_t>(threads);
  const size_t ring = static_cast<size_t>(depth) * n;
  switch (layout) {
    case kForwardWarp:
      return sizeof(float) * ring;
    case kForwardPairs:
      return sizeof(float) * 2 * (ring + (n / 32) * kForwardExchange);
    case kForwardBlock:
      return static_cast<size_t>(S) *
             (sizeof(float) * shard_forward_floats_per_cell(depth) + 1);
    default:
      return shared_bytes(S);
  }
}

// Whether a block of `threads` in `layout` fits rows of S slots: the warp
// layout takes rows of up to one warp (threads / 32 samples a block), the
// pairs layout rows of up to kForwardPairsWidth slots, two a lane, in
// whole warps; the block and rows layouts stride over any row.
bool forward_threads_fit(int layout, int S, int threads) {
  switch (layout) {
    case kForwardWarp:
      return S <= 32;
    case kForwardPairs:
      return S <= kForwardPairsWidth && threads == 32 * ((S + 63) / 64);
    default:
      return true;
  }
}

template <int kLayout, int kDepth>
cudaError_t launch_forward_layout(const float* em, const unsigned char* skip,
                                  const int* inlen, const int* tgt,
                                  float* alpha, float* nll, int T, int B,
                                  int S, int threads, size_t smem,
                                  cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(blank_forward_kernel<kLayout, kDepth>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // the warp layout: a sample a warp
  const int per_block = kLayout == kForwardWarp ? threads / 32 : 1;
  const int grid = (B + per_block - 1) / per_block;
  blank_forward_kernel<kLayout, kDepth><<<grid, threads, smem, stream>>>(
      em, skip, inlen, tgt, alpha, nll, T, B, S);
  return cudaGetLastError();
}

// The plan (layout, depth, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::forward_plan).  A layout or ring depth the kernel
// is not built for, a block past the layout's launch bounds or that does
// not fit the row (forward_threads_fit), or shared bytes that do not match
// the layout are refused.
cudaError_t launch_forward(const float* em, const unsigned char* skip,
                           const int* inlen, const int* tgt, float* alpha,
                           float* nll, int T, int B, int S, int layout,
                           int depth, int threads, int smem,
                           cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  if (layout < kForwardRows || layout > kForwardBlock || threads < 32 ||
      threads % 32 != 0 || threads > forward_max_threads(layout) ||
      !forward_threads_fit(layout, S, threads) ||
      bytes != forward_bytes(layout, S, depth, threads)) {
    return cudaErrorInvalidValue;
  }
  switch (layout * 16 + depth) {
    case kForwardWarp * 16 + 8:
      return launch_forward_layout<kForwardWarp, 8>(
          em, skip, inlen, tgt, alpha, nll, T, B, S, threads, bytes, stream);
    case kForwardPairs * 16 + 8:
      return launch_forward_layout<kForwardPairs, 8>(
          em, skip, inlen, tgt, alpha, nll, T, B, S, threads, bytes, stream);
    case kForwardBlock * 16 + 8:
      return launch_forward_layout<kForwardBlock, 8>(
          em, skip, inlen, tgt, alpha, nll, T, B, S, threads, bytes, stream);
    case kForwardBlock * 16 + 2:
      return launch_forward_layout<kForwardBlock, 2>(
          em, skip, inlen, tgt, alpha, nll, T, B, S, threads, bytes, stream);
    case kForwardRows * 16 + 0:
      return launch_forward_layout<kForwardRows, 0>(
          em, skip, inlen, tgt, alpha, nll, T, B, S, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kDepth, int kHalo>
cudaError_t launch_shard_forward_kernel(
    const float* em, const unsigned char* skip, const int* inlen,
    const int* tgt, const float* init0, const float* skip0, float* alpha,
    float* final_out, float* boundary, int T, int B, int S, int em_stride,
    int threads, size_t smem, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(
      blank_shard_forward_kernel<kDepth, kHalo>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  blank_shard_forward_kernel<kDepth, kHalo><<<B, threads, smem, stream>>>(
      em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B, S,
      em_stride);
  return cudaGetLastError();
}

// The plan (depth, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::shard_forward_plan).  Rows of up to
// kWarpsMaxWidth slots take the warps layout, with warps_threads(S)
// threads and the ring and exchange rows in shared memory; wider rows take
// the block layout, whose block holds the ring, the carried rows and the
// skip mask.  A depth the kernels are not built for, or threads or shared
// bytes that do not match the layout, are refused.
cudaError_t launch_shard_forward(const float* em, const unsigned char* skip,
                                 const int* inlen, const int* tgt,
                                 const float* init0, const float* skip0,
                                 float* alpha, float* final_out,
                                 float* boundary, int T, int B, int S,
                                 int em_stride, int depth, int threads,
                                 int smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  const bool warps = S <= kWarpsMaxWidth;
  const size_t want =
      warps ? sizeof(float) * (static_cast<size_t>(depth) * threads + 2 * S)
            : static_cast<size_t>(S) *
                  (sizeof(float) * shard_forward_floats_per_cell(depth) + 1);
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || bytes != want ||
      (warps && threads != warps_threads(S))) {
    return cudaErrorInvalidValue;
  }
  // the layout: 0 block, 1 one warp, 2 warps with halo lanes
  const int layout = !warps ? 0 : (S <= 32 ? 1 : 2);
  switch (depth * 4 + layout) {
    case 8 * 4 + 0:
      return launch_shard_forward_kernel<8, -1>(
          em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B,
          S, em_stride, threads, bytes, stream);
    case 8 * 4 + 1:
      return launch_shard_forward_kernel<8, 0>(
          em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B,
          S, em_stride, threads, bytes, stream);
    case 8 * 4 + 2:
      return launch_shard_forward_kernel<8, kWarpsHalo>(
          em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B,
          S, em_stride, threads, bytes, stream);
    case 2 * 4 + 0:
      return launch_shard_forward_kernel<2, -1>(
          em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B,
          S, em_stride, threads, bytes, stream);
    case 2 * 4 + 1:
      return launch_shard_forward_kernel<2, 0>(
          em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B,
          S, em_stride, threads, bytes, stream);
    case 2 * 4 + 2:
      return launch_shard_forward_kernel<2, kWarpsHalo>(
          em, skip, inlen, tgt, init0, skip0, alpha, final_out, boundary, T, B,
          S, em_stride, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared bytes of a whole-lattice backward block in layout `layout`: the
// warps layout's staging columns, halo slots and exchange slots; the
// chunks-warp layout's chunked_floats_per_cell floats and the rows
// layout's two rows a slot, each with the slot's skip byte.
size_t backward_bytes(int layout, int S, int chunk, int threads) {
  if (layout == kWarpsLayout) {
    const size_t warps = threads / 32;
    return sizeof(float) * 2 *
           (static_cast<size_t>(chunk) *
                (2 * threads + warps * kBackwardHalo) +
            warps * kBackwardExchange);
  }
  if (layout == kChunksWarpLayout) {
    return static_cast<size_t>(S) *
           (sizeof(float) * chunked_floats_per_cell(chunk) + 1);
  }
  return shared_bytes(S);
}

// Whether a block of `threads` in `layout` fits rows of S slots: the
// warps layout takes a row of up to kBackwardWarpsWidth slots, two a
// lane, in whole warps; the chunks-warp layout rows of up to one warp.
bool threads_fit(int layout, int S, int threads) {
  if (layout == kWarpsLayout) {
    return S <= kBackwardWarpsWidth && threads == 32 * ((S + 63) / 64);
  }
  return layout != kChunksWarpLayout || S <= 32;
}

template <int kLayout, int kChunk>
cudaError_t launch_backward_layout(const float* alpha,
                                   const unsigned char* skip,
                                   const int* inlen, const int* tgt,
                                   const float* bar, float* g, int T, int B,
                                   int S, int threads, size_t smem,
                                   cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(blank_backward_kernel<kLayout, kChunk>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  blank_backward_kernel<kLayout, kChunk><<<B, threads, smem, stream>>>(
      alpha, skip, inlen, tgt, bar, g, T, B, S);
  return cudaGetLastError();
}

// The plan (layout, chunk, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::backward_plan).  A layout or chunk the kernel is
// not built for, a block past the layout's launch bounds or that does not
// fit the row (threads_fit), or shared bytes that do not match the layout
// are refused.
cudaError_t launch_backward(const float* alpha, const unsigned char* skip,
                            const int* inlen, const int* tgt,
                            const float* bar, float* g, int T, int B, int S,
                            int layout, int chunk, int threads, int smem,
                            cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  if (layout < kRowsLayout || layout > kChunksWarpLayout || threads < 32 ||
      threads % 32 != 0 || threads > backward_max_threads(layout) ||
      !threads_fit(layout, S, threads) ||
      bytes != backward_bytes(layout, S, chunk, threads)) {
    return cudaErrorInvalidValue;
  }
  switch (layout * 32 + chunk) {
    case kWarpsLayout * 32 + 8:
      return launch_backward_layout<kWarpsLayout, 8>(
          alpha, skip, inlen, tgt, bar, g, T, B, S, threads, bytes, stream);
    case kChunksWarpLayout * 32 + 16:
      return launch_backward_layout<kChunksWarpLayout, 16>(
          alpha, skip, inlen, tgt, bar, g, T, B, S, threads, bytes, stream);
    case kRowsLayout * 32 + 0:
      return launch_backward_layout<kRowsLayout, 0>(
          alpha, skip, inlen, tgt, bar, g, T, B, S, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kChunk>
cudaError_t launch_shard_backward_chunk(
    const float* alpha, const unsigned char* skip, const int* inlen,
    const int* tgt, const float* bar, const float* g_seed, const float* init0,
    const float* skip0, float* g, float* d_init0, float* d_skip0, int T,
    int B, int S, int threads, size_t smem, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(blank_shard_backward_kernel<kChunk>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  blank_shard_backward_kernel<kChunk><<<B, threads, smem, stream>>>(
      alpha, skip, inlen, tgt, bar, g_seed, init0, skip0, g, d_init0,
      d_skip0, T, B, S);
  return cudaGetLastError();
}

// The plan (chunk, threads, shared bytes) comes from the wrapper
// (ops/lattice_cuda.py::shard_backward_plan); a chunk the kernel is not
// built for, or shared bytes that do not match its layout, are refused.
cudaError_t launch_shard_backward(
    const float* alpha, const unsigned char* skip, const int* inlen,
    const int* tgt, const float* bar, const float* g_seed, const float* init0,
    const float* skip0, float* g, float* d_init0, float* d_skip0, int T,
    int B, int S, int chunk, int threads, int smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaSuccess;
  const size_t bytes = static_cast<size_t>(smem);
  if (threads < 32 || threads > 512 || threads % 32 != 0 ||
      bytes != static_cast<size_t>(S) *
                   (sizeof(float) * shard_floats_per_cell(chunk) + 1)) {
    return cudaErrorInvalidValue;
  }
  switch (chunk) {
    case 16:
      return launch_shard_backward_chunk<16>(
          alpha, skip, inlen, tgt, bar, g_seed, init0, skip0, g, d_init0,
          d_skip0, T, B, S, threads, bytes, stream);
    case 4:
      return launch_shard_backward_chunk<4>(
          alpha, skip, inlen, tgt, bar, g_seed, init0, skip0, g, d_init0,
          d_skip0, T, B, S, threads, bytes, stream);
    case 1:
      return launch_shard_backward_chunk<1>(
          alpha, skip, inlen, tgt, bar, g_seed, init0, skip0, g, d_init0,
          d_skip0, T, B, S, threads, bytes, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Writes alpha [T, B, S] and nll [B]; layout, depth, threads and smem are
// the wrapper's plan.
cudaError_t blank_lattice_forward(const float* em, const unsigned char* skip,
                                  const int* inlen, const int* tgt,
                                  float* alpha, float* nll, int T, int B,
                                  int S, int layout, int depth, int threads,
                                  int smem, cudaStream_t stream) {
  return launch_forward(em, skip, inlen, tgt, alpha, nll, T, B, S, layout,
                        depth, threads, smem, stream);
}

// layout, chunk, threads and smem are the wrapper's plan.
cudaError_t blank_lattice_backward(const float* alpha,
                                   const unsigned char* skip, const int* inlen,
                                   const int* tgt, const float* nll_bar,
                                   float* g, int T, int B, int S, int layout,
                                   int chunk, int threads, int smem,
                                   cudaStream_t stream) {
  return launch_backward(alpha, skip, inlen, tgt, nll_bar, g, T, B, S, layout,
                         chunk, threads, smem, stream);
}

// One T-shard: inlen is shard-local, init0 / skip0 are the [B, S] init
// rows; writes alpha [T, B, S], final [B] and the boundary row [B, S].  em
// is read with em_stride floats between its rows (samples contiguous);
// depth, threads and smem are the wrapper's plan.
cudaError_t blank_shard_forward(const float* em, const unsigned char* skip,
                                const int* inlen, const int* tgt,
                                const float* init0, const float* skip0,
                                float* alpha, float* final_out,
                                float* boundary, int T, int B, int S,
                                int em_stride, int depth, int threads,
                                int smem, cudaStream_t stream) {
  return launch_shard_forward(em, skip, inlen, tgt, init0, skip0, alpha,
                              final_out, boundary, T, B, S, em_stride, depth,
                              threads, smem, stream);
}

// One T-shard: inlen is shard-local, final_bar the cotangent of the final
// log-prob, g_seed [B, S] that of the outgoing boundary row, init0 / skip0
// the [B, S] init rows; writes g and the init rows' gradients d_init0 /
// d_skip0 [B, S].  chunk, threads and smem are the wrapper's plan.
cudaError_t blank_shard_backward(const float* alpha, const unsigned char* skip,
                                 const int* inlen, const int* tgt,
                                 const float* final_bar, const float* g_seed,
                                 const float* init0, const float* skip0,
                                 float* g, float* d_init0, float* d_skip0,
                                 int T, int B, int S, int chunk, int threads,
                                 int smem, cudaStream_t stream) {
  return launch_shard_backward(alpha, skip, inlen, tgt, final_bar, g_seed,
                               init0, skip0, g, d_init0, d_skip0, T, B, S,
                               chunk, threads, smem, stream);
}

}  // extern "C"
