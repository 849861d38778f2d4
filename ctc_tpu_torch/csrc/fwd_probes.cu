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
// expdomain_kernel<Kind, kDepth, kTma>.
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
// expdomain_kernel (rows 10a-10c) keeps that block (8 samples x kRingRows
// row threads, or one a row where L_pad is narrower, each thread's offsets
// set up once) and ring slots, but fills the ring otherwise.  Clock reads
// on the H100 (python -m ctc_tpu_torch.probes.expdomain_ab --cycles;
// PERF.md section 6) showed issuing a step's 4-byte cp.async stalling a row
// thread 200-310 cycles a step, on the step's path.  So where the ring has 8 slots and em's rows are whole 16-byte
// pieces (B a multiple of 4, em's base aligned), one extra warp's first
// lane fills it by tensor copies (TMA): one box of up to 256 rows x 8
// samples a step (lanes past B read as 0), kDepth - 1 steps ahead, into
// the slot the step before read; each slot has a barrier (mbarrier) that
// the row threads wait on before they read it.  Otherwise (2 slots, or
// another B) each row thread copies its own cells by 4-byte cp.async after
// its rows, into the slot they just read, kDepth steps ahead, and waits for
// its own group (TileRing, CellRing below).  em is already padded to L_pad,
// so every row of a lane b < B is copied.  The depth comes with the
// shared-memory bytes from ops/probe_cuda.py::expdomain_plan: 8 slots up
// to L_pad 720, 2 up to 1816 (1808 for exp_renorm, whose partials take 1 KB
// more), and past that depth 0, em read from device memory inside the
// step, up to L_pad 2408, the widest the first row-10 kernel took.  The
// log variant takes depth 0 below L_pad 64 too: its em enters the step
// last, behind the log-add, which hides the load there.  The launch
// refuses any other depth.
//
// Each thread reads its rows' outside flags once, before the steps, into a
// 64-bit mask in its registers (bit k: row ty + k * kRingRows; 64 bits
// cover L_pad 4096 at 64 row threads), so shared memory holds only the
// carry, the ring and the renorm's partials.  exp(em) is taken from the
// landed slot before the carry is read, so it stays off the chain.
//
// The exp-renorm variant stores each row before the renormalization and,
// at every chunk's end, divides the carry by its per-column max over all
// L_pad rows (1 where that max is <= 0).  The max is reduced inside each
// warp (8 samples x 4 row threads) by __shfl_xor_sync over its row lanes,
// then across the block's warps through per-warp partials in shared
// memory, written before the step's own barrier; the next step reads them
// and divides the carry cells it reads (the same IEEE divide of the same
// values), so the renorm adds no barrier.  The partials are double
// buffered by the step's parity: at chunk 1 a thread may write the next
// chunk's partials before another has read this one's.
//
// Numerics are the JAX probes': the -1e13 sentinel, jnp.logaddexp's select
// on isnan(a - s), expf / log1pf / fmaxf, and no fast-math.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "cp_async.cuh"
#include "tma.cuh"

namespace {

constexpr float kNeg = -1.0e13f;
constexpr int kTileB = 8;
constexpr int kRingRows = 64;  // row threads of a column
constexpr int kRowStep = kRingRows * kTileB;  // a thread's next row
constexpr int kWarps = kTileB * kRingRows / 32;  // a column's warps
constexpr int kMaskRows = 64;  // rows a thread's outside mask holds
// exp_renorm's per-warp column maxima, two buffers by the step's parity
constexpr int kPartialFloats = 2 * kWarps * kTileB;
// the widest box of a tensor copy (TMA), in rows
constexpr int kBoxRows = 256;
// expdomain_kernel's widest block: the row threads and the copies' warp
// (capped at 1024 for ring_sweep's builds of more row threads, which
// launch row 9 only)
constexpr int kExpdomainThreads =
    kTileB * kRingRows + 32 < 1024 ? kTileB * kRingRows + 32 : 1024;

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
template <Body kBody, bool kNoOut, int kDepth>
__global__ void __launch_bounds__(kTileB * kRingRows)
    fwd_ops_kernel(const float* __restrict__ em, float* __restrict__ out,
                   int T, int L, int L_pad, int B, int chunk) {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  extern __shared__ float smem[];  // [2][L_pad][kTileB] slab, then the
                                   // [kDepth][L_pad][kTileB] em ring
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
        cp_async::copy4(slot + k * kRowStep, p);
        p += row_stride;
      }
      src += in_stride;
    }
    cp_async::commit();
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
    cp_async::wait<kDepth - 1>();    // step t's group has landed
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

// The rows of one box of expdomain_kernel's tensor copies: L_pad cut into
// the fewest boxes of at most kBoxRows rows, each a multiple of 8 rows (the
// last box starts at L_pad minus this, overlapping the one before).
__host__ __device__ __forceinline__ int box_rows(int L_pad) {
  const int boxes = (L_pad + kBoxRows - 1) / kBoxRows;
  return ((L_pad + boxes - 1) / boxes + 7) / 8 * 8;
}

// One row thread's share of expdomain_kernel's em ring where the block
// fills it by 4-byte copies: kDepth slots of [L_pad x kTileB] f32; the
// thread copies the cells of its own rows (n_load of them; none off the
// batch) and reads back only those.  One group a step (empty past T, so the
// count stays uniform), issued after the step's rows into the slot they
// just read, so kDepth steps are in flight.
template <int kDepth>
struct CellRing {
  static_assert(kDepth >= 2 && (kDepth & (kDepth - 1)) == 0,
                "the ring's depth is a power of two, at least 2");
  unsigned dst;         // shared address of this thread's cell in slot 0
  unsigned slot_bytes;  // one slot
  const float* src;     // its first em cell of the next unstaged step
  size_t row_stride;    // em: its next row
  size_t step_stride;   // em: the next step
  int n_load;
  int T;
  int staged;

  __device__ __forceinline__ void stage() {
    if (staged < T) {
      const unsigned slot = dst + (staged & (kDepth - 1)) * slot_bytes;
      const float* p = src;
      for (int k = 0; k < n_load; ++k) {
        cp_async::copy4(slot + k * kRowStep * sizeof(float), p);
        p += row_stride;
      }
      src += step_stride;
    }
    cp_async::commit();
    ++staged;
  }
};

// expdomain_kernel's em ring where tensor copies (TMA) fill it: the first
// lane of the copies' warp issues one step's tile, L_pad rows of the
// block's 8 samples (lanes off the batch read as 0), in boxes of
// box_rows(L_pad) rows, and a row thread waits on the slot's barrier
// before it reads the slot.
template <int kDepth>
struct TileRing {
  const CUtensorMap* map;  // em as [T][L_pad][B]
  unsigned slot0;          // shared address of slot 0
  unsigned slot_bytes;
  unsigned full0;  // shared address of slot 0's barrier (8 bytes a slot)
  int b0;
  int rows;   // box_rows(L_pad)
  int last;   // the last box's first row, L_pad - rows
  int boxes;  // ceil(L_pad / rows)
  int T;

  // step's tile -> slot step & (kDepth - 1), completing its barrier's phase
  __device__ __forceinline__ void issue(int step) const {
    if (step >= T) return;
    const int slot = step & (kDepth - 1);
    const unsigned bar = full0 + 8 * slot;
    tma::expect_bytes(bar, boxes * rows * kTileB * sizeof(float));
    for (int i = 0; i < boxes; ++i) {
      const int l0 = min(i * rows, last);
      tma::load_3d(slot0 + slot * slot_bytes + l0 * kTileB * sizeof(float),
                   map, b0, l0, step, bar);
    }
  }

  // wait until step t's tile has landed
  __device__ __forceinline__ void wait(int t) const {
    tma::wait(full0 + 8 * (t & (kDepth - 1)), (t / kDepth) & 1);
  }
};

// em [T, L_pad, B], outside [L_pad, B] (a cell is outside where > 0.5);
// out[t] = the row computed at step t.  s[l] = alpha[l - 1], 0 (exp) or
// the sentinel (log) at l = 0 and at t = 0.
//   log        alpha(-1) = 0 at l = 0, the sentinel elsewhere;
//              alpha = (outside ? sentinel : logaddexp(alpha, s)) + em[t]
//   exp        A(-1) = 1 at l = 0, 0 elsewhere;
//              A = outside ? 0 : (A + s) * exp(em[t])
//   exp_renorm as exp; after each chunk's last step the carry (not the
//              stored row) is divided by its column max, 1 where <= 0
// kDepth: the em ring's slots, filled by tensor copies (kTma) or by each
// row thread's 4-byte copies; 0 reads em from device memory in the step.
// The block: 8 samples x row threads (kRingRows, or one a row where L_pad
// is narrower), then, with kTma, one more warp, whose first lane issues the
// tensor copies off the row threads' path.
template <Kind kKind, int kDepth, bool kTma>
__global__ void __launch_bounds__(kExpdomainThreads)
    expdomain_kernel(const __grid_constant__ CUtensorMap em_map,
                     const float* __restrict__ em,
                     const float* __restrict__ outside,
                     float* __restrict__ out, int T, int L_pad, int B,
                     int chunk) {
  extern __shared__ __align__(128) float smem[];  // [2][L_pad][kTileB]
      // slab, the [kDepth][L_pad][kTileB] em ring, then (exp_renorm)
      // [2][kWarps][kTileB]
  constexpr bool kLog = kKind == Kind::kLog;
  constexpr bool kRenorm = kKind == Kind::kExpRenorm;
  constexpr bool kStaged = kDepth > 0;
  constexpr float kZero = kLog ? kNeg : 0.0f;  // what "no source" holds
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row_threads = blockDim.y - (kTma ? 4 : 0);
  const bool issuer = ty >= row_threads;  // the tensor copies' warp
  const int b = blockIdx.x * kTileB + tx;
  const bool col = b < B;
  const int cells = L_pad * kTileB;  // one slab or ring slot
  // a row thread's rows are l = ty + k * kRingRows, k < n_rows
  const int n_rows =
      !issuer && ty < L_pad ? (L_pad - 1 - ty) / kRingRows + 1 : 0;
  const size_t row_stride = static_cast<size_t>(kRingRows) * B;
  const size_t step_stride = static_cast<size_t>(L_pad) * B;
  const size_t first = static_cast<size_t>(ty) * B + b;  // row ty of lane b
  float* slab = smem + ty * kTileB + tx;  // this thread's first cell
  const float* ring = smem + 2 * cells + ty * kTileB + tx;
  float* partial = smem + (2 + kDepth) * cells;
  const int warps = row_threads / 4;  // each 8 samples x 4 row threads

  // bit k: row ty + k * kRingRows is outside (every row of a lane off the
  // batch, which then computes the sentinel or 0 and stores nothing)
  uint64_t outside_bits = col ? 0 : ~uint64_t{0};
  if (col) {
    const float* o = outside + first;
    for (int k = 0; k < n_rows; ++k) {
      if (*o > 0.5f) outside_bits |= uint64_t{1} << k;
      o += row_stride;
    }
  }
  for (int k = 0; k < n_rows; ++k) {
    slab[k * kRowStep] = (ty == 0 && k == 0) ? (kLog ? 0.0f : 1.0f) : kZero;
  }
  constexpr int kRing = kStaged ? kDepth : 2;  // the rings take depths >= 2
  CellRing<kRing> copies{};
  TileRing<kRing> tiles{};
  const bool leader = issuer && tx == 0 && ty == row_threads;
  if constexpr (kStaged && kTma) {
    __shared__ __align__(128) uint64_t full[kDepth];  // a slot's tile landed
    const int rows = box_rows(L_pad);
    tiles = {&em_map,
             cp_async::shared_address(smem + 2 * cells),
             static_cast<unsigned>(cells * sizeof(float)),
             cp_async::shared_address(full),
             static_cast<int>(blockIdx.x) * kTileB,
             rows,
             L_pad - rows,
             (L_pad + rows - 1) / rows,
             T};
    if (leader) {
      for (int d = 0; d < kDepth; ++d) tma::init(tiles.full0 + 8 * d, 1);
      tma::fence_init();
    }
  } else if constexpr (kStaged) {
    copies = {cp_async::shared_address(ring),
              static_cast<unsigned>(cells * sizeof(float)),
              em + first,
              row_stride,
              step_stride,
              col ? n_rows : 0,
              T,
              0};
    if (!col) {  // off the batch: zeroed once, never copied
      for (int k = 0; k < n_rows; ++k) {
        for (int d = 0; d < kDepth; ++d) {
          smem[2 * cells + d * cells + ty * kTileB + tx + k * kRowStep] = 0.0f;
        }
      }
    }
    for (int d = 0; d < kDepth; ++d) copies.stage();
  }
  __syncthreads();

  if (issuer) {  // steps 0 .. kDepth - 2, then one a step, kDepth - 1 ahead
    if (leader) {
      for (int step = 0; step + 1 < kDepth; ++step) tiles.issue(step);
    }
    for (int t = 0; t < T; ++t) {
      // into the slot step t - 1 read, released by the last barrier
      if (leader) tiles.issue(t + kDepth - 1);
      __syncthreads();
    }
    return;
  }

  const float* src = em + first;  // kDepth 0: this step's em
  float* dst = out + first;
  int until_renorm = chunk;  // steps left in this chunk (exp_renorm)
  bool rescale = false;      // the carry read this step is to be divided
  for (int t = 0; t < T; ++t) {
    const float* cur = slab + (t & 1) * cells;
    float* nxt = slab + ((t + 1) & 1) * cells;
    const float* e_t = ring;  // step t's tile, landed for this thread
    if constexpr (kTma) {
      tiles.wait(t);
    } else if constexpr (kStaged) {
      cp_async::wait<kDepth - 1>();
    }
    if constexpr (kStaged) e_t += (t & (kDepth - 1)) * cells;
    float scale = 1.0f;
    if constexpr (kRenorm) {
      if (rescale) {  // the last step's column max, from its partials
        const float* p = partial + ((t - 1) & 1) * kWarps * kTileB + tx;
        float m = p[0];
        for (int w = 1; w < warps; ++w) m = fmaxf(m, p[w * kTileB]);
        scale = m > 0.0f ? m : 1.0f;
      }
    }
    float col_max = -CUDART_INF_F;
    const float* e_src = src;
    float* o = dst;
    for (int k = 0; k < n_rows; ++k) {
      const int c = k * kRowStep;
      float e;
      if constexpr (kStaged) {
        e = e_t[c];
      } else {
        e = col ? *e_src : 0.0f;
        e_src += row_stride;
      }
      const bool out_l = (outside_bits >> k) & 1;
      float v;
      if constexpr (kLog) {
        const float a = cur[c];
        const float s = (t == 0 || (ty == 0 && k == 0)) ? kZero
                                                        : cur[c - kTileB];
        const float lse = out_l ? kNeg : logaddexp(a, s);
        v = lse + e;
      } else {
        const float ex = expf(e);  // off the chain: before the carry
        float a = cur[c];
        const bool no_src = t == 0 || (ty == 0 && k == 0);
        float s = no_src ? kZero : cur[c - kTileB];
        if constexpr (kRenorm) {
          if (rescale) {
            a = a / scale;
            if (!no_src) s = s / scale;
          }
        }
        v = (a + s) * ex;
        if (out_l) v = 0.0f;
        if constexpr (kRenorm) col_max = fmaxf(col_max, v);
      }
      nxt[c] = v;
      if (col) *o = v;
      o += row_stride;
    }
    // step t + kDepth into the slot this thread's rows just read
    if constexpr (kStaged && !kTma) copies.stage();
    if constexpr (!kStaged) src += step_stride;
    dst += step_stride;
    if constexpr (kRenorm) {
      rescale = --until_renorm == 0;
      if (rescale) {
        until_renorm = chunk;
        // the warp's 4 row lanes of this sample (lane = tx + 8 * (ty & 3))
        col_max = fmaxf(col_max, __shfl_xor_sync(0xffffffffu, col_max, 8));
        col_max = fmaxf(col_max, __shfl_xor_sync(0xffffffffu, col_max, 16));
        if ((ty & 3) == 0) {
          partial[(t & 1) * kWarps * kTileB + (ty >> 2) * kTileB + tx] =
              col_max;
        }
      }
    }
    __syncthreads();
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

// Whether a depth-8 ring is filled by tensor copies: their rows are 16-byte
// aligned (B a multiple of 4, em's base aligned) and their boxes 8-row
// aligned.
bool tensor_copies(const float* em, int L_pad, int B) {
  return B % 4 == 0 && L_pad % 8 == 0 &&
         reinterpret_cast<uintptr_t>(em) % 16 == 0;
}

// em [T, L_pad, B] as a tensor of boxes of box_rows(L_pad) rows of kTileB
// samples (lanes past B read as 0).
cudaError_t encode_em_map(CUtensorMap* map, const float* em, int T,
                          int L_pad, int B) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(B),
                              static_cast<cuuint64_t>(L_pad),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(B) * sizeof(float),
                                 static_cast<cuuint64_t>(L_pad) * B *
                                     sizeof(float)};
  const cuuint32_t box[3] = {kTileB, static_cast<cuuint32_t>(box_rows(L_pad)),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(em), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <Kind kKind, int kDepth, bool kTma>
cudaError_t launch_expdomain_layout(const CUtensorMap& map, const float* em,
                                    const float* outside, float* out, int T,
                                    int L_pad, int B, int chunk, int smem,
                                    cudaStream_t stream) {
  const size_t need =
      ((kDepth + 2) * static_cast<size_t>(L_pad) * kTileB +
       (kKind == Kind::kExpRenorm ? kPartialFloats : 0)) *
      sizeof(float);
  if (smem < 0 || static_cast<size_t>(smem) < need) {
    return cudaErrorInvalidValue;
  }
  const void* kernel =
      reinterpret_cast<const void*>(expdomain_kernel<kKind, kDepth, kTma>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // rows narrower than the column take one row thread each (4 a warp);
  // tensor copies add a warp
  const int rows = L_pad < kRingRows ? (L_pad + 3) / 4 * 4 : kRingRows;
  const dim3 block(kTileB, rows + (kTma ? 4 : 0));
  const dim3 grid((B + kTileB - 1) / kTileB);
  expdomain_kernel<kKind, kDepth, kTma><<<grid, block, smem, stream>>>(
      map, em, outside, out, T, L_pad, B, chunk);
  return cudaGetLastError();
}

// depth: the em ring's slots (8 or 2; 0 reads em in the step); smem: the
// bytes the caller planned, (depth + 2) * L_pad * kTileB * 4, plus
// kPartialFloats * 4 for exp_renorm.  Eight slots are filled by tensor
// copies where tensor_copies() holds, else (and two) by 4-byte copies.
template <Kind kKind>
cudaError_t launch_expdomain(const float* em, const float* outside,
                             float* out, int T, int L_pad, int B, int chunk,
                             int depth, int smem, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || L_pad <= 0) return cudaSuccess;
  if (chunk <= 0 || L_pad > kMaskRows * kRingRows) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map{};
  switch (depth) {
    case 0:
      return launch_expdomain_layout<kKind, 0, false>(
          map, em, outside, out, T, L_pad, B, chunk, smem, stream);
    case 2:
      return launch_expdomain_layout<kKind, 2, false>(
          map, em, outside, out, T, L_pad, B, chunk, smem, stream);
    case 8: {
      if (!tensor_copies(em, L_pad, B)) {
        return launch_expdomain_layout<kKind, 8, false>(
            map, em, outside, out, T, L_pad, B, chunk, smem, stream);
      }
      const cudaError_t err = encode_em_map(&map, em, T, L_pad, B);
      if (err != cudaSuccess) return err;
      return launch_expdomain_layout<kKind, 8, true>(
          map, em, outside, out, T, L_pad, B, chunk, smem, stream);
    }
    default:
      return cudaErrorInvalidValue;
  }
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

// em [T, L_pad, B], outside [L_pad, B] -> out [T, L_pad, B] through a
// ring of `depth` slots in `smem` bytes (ops/probe_cuda.py::expdomain_plan)
cudaError_t probe_fwd_log(const float* em, const float* outside, float* out,
                          int T, int L_pad, int B, int depth, int smem,
                          cudaStream_t stream) {
  return launch_expdomain<Kind::kLog>(em, outside, out, T, L_pad, B, 1,
                                      depth, smem, stream);
}

cudaError_t probe_fwd_exp(const float* em, const float* outside, float* out,
                          int T, int L_pad, int B, int depth, int smem,
                          cudaStream_t stream) {
  return launch_expdomain<Kind::kExp>(em, outside, out, T, L_pad, B, 1,
                                      depth, smem, stream);
}

cudaError_t probe_fwd_exp_renorm(const float* em, const float* outside,
                                 float* out, int T, int L_pad, int B,
                                 int chunk, int depth, int smem,
                                 cudaStream_t stream) {
  return launch_expdomain<Kind::kExpRenorm>(em, outside, out, T, L_pad, B,
                                            chunk, depth, smem, stream);
}

}  // extern "C"
