// TF-SAME 3D max pool for Hopper (sm_90a): the forward, which may write each
// output's tap within its window as one byte, and the gather backward that
// routes the output gradient through those bytes.  Bound to PyTorch through
// a plain C interface (ctypes); ops/max_pool.py is the wrapper and holds the
// plain version.  f32, bf16 and f64; [N, C, D, H, W] in channels_last_3d (C
// innermost, the layout the I3D gives its pools; the wrapper copies an NCDHW
// input to it), C a multiple of 16 bytes; the I3D's four windows, each known
// to the compiler.
//
// Replaces no Pallas kernel: ctc_tpu leaves the I3D's 13 max pools
// (MaxPool3d_2a/3a/4a/5a and branch 3 of every Inception block) to XLA's
// reduce_window with -inf padding.  The port first ran each as F.pad (a
// zero-filled padded copy of the input) and F.max_pool3d, whose kernel
// max_pool3d_with_indices writes an int64 index beside every output even
// under no_grad: 19.6 ms of pool kernel a frozen step of 100 clips of 10
// frames at 224^2, plus the pad copies (about 25 ms of a 199 ms step),
// where each input read once and each output written once (7.35 GB) take
// 2.19 ms at 3.35 TB/s.  So the pool is bound by bytes, and the design
// moves as few as it can:
//   - SAME padding is a skipped tap: a tap outside the tensor is never read
//     and counts as -inf (XLA's padding), so no padded tensor is made.
//   - The forward: a block owns a TH x TW output tile of 32 channels and
//     walks the input's D planes in order, each plane's tile and halo
//     copied into shared memory once, by 16-byte cp.async a plane ahead into
//     one of two buffers; a warp owns an output column (lanes = channels, so
//     every access of a warp is 32 consecutive channels) and takes the max
//     over W, then H, then D (the last KD plane maxima of each output kept
//     in registers), so the taps of a window never touch device memory and
//     an input is read again only where two tiles' halos overlap, from L2.
//   - Offsets only for a backward: one uint8 an output, its tap within the
//     window in (d, h, w) scan order (at most 27), where int64 wrote 8
//     bytes.  Under no_grad the forward writes only the output.
//   - The backward sums each input's gradient from the outputs whose offset
//     names it, in shared memory and in one fixed order (see there): no
//     atomics, no zero-fill pass, the same sum every run, and no copy of the
//     input.
// Each tap is taken over the running maximum where it is greater or NaN, in
// scan order: the first maximum wins and NaN propagates (the last NaN, as in
// max_pool3d_with_indices).  Done separably (W, then H, then D, each in scan
// order), the rule picks the same tap as the 27-tap scan.  Without offsets
// the forward takes max.NaN instead: the same value, NaN too, where +0 and
// -0 tie either may come out.  A window of -inf only routes to its first
// tap, inside the tensor or not, as the plain version's -inf-padded copy
// does.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --only max_pool on
// the 13 pools' inputs of a frozen step, device time by the profiler): the
// forward 2.80 ms against its 2.19 ms bound (78.4%; a first design, a
// tile's items found by runtime division, ran 12.6 ms, and lanes over
// channels with each plane's loads held in registers 6.6 ms), 3.61 ms with
// offsets (bound 2.36); F.max_pool3d alone on the padded inputs 19.47 ms,
// with F.pad 25.96.  The backward 7.49 ms against 2.36 (31%: a warp's
// shared-memory adds wait on one another); max_pool3d_with_indices_backward
// 11.44.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Geometry {
  int N, C, D, H, W, OD, OH, OW;
  int kd, kh, kw, sd, sh, sw, pd, ph, pw;
  int TH, TW;  // the forward's output tile: rows, columns
};

template <typename T>
struct Num;
template <>
struct Num<float> {
  using Acc = float;
  __device__ static float key(float v) { return v; }
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float store(float v) { return v; }
};
template <>
struct Num<double> {
  using Acc = double;
  __device__ static double key(double v) { return v; }
  __device__ static double lowest() { return -INFINITY; }
  __device__ static double store(double v) { return v; }
};
template <>
struct Num<__nv_bfloat16> {
  using Acc = float;
  __device__ static float key(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 lowest() {
    return __float2bfloat16(-INFINITY);
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};

// The later tap (b, bk) of the scan replaces the running (v, k) where it is
// greater or NaN.
template <typename T>
__device__ __forceinline__ void later(T& v, int& k, T b, int bk) {
  const auto x = Num<T>::key(b);
  if (x > Num<T>::key(v) || isnan(x)) {
    v = b;
    k = bk;
  }
}

// One of the I3D's windows, known to the compiler: the kernels below
// unroll every tap and every row of their tile.
template <int KD_, int KH_, int KW_, int SD_, int SH_, int SW_>
struct Window {
  static constexpr int KD = KD_, KH = KH_, KW = KW_;
  static constexpr int SD = SD_, SH = SH_, SW = SW_;
};
using Window133s122 = Window<1, 3, 3, 1, 2, 2>;  // MaxPool3d_2a, _3a
using Window333s222 = Window<3, 3, 3, 2, 2, 2>;  // MaxPool3d_4a
using Window222s222 = Window<2, 2, 2, 2, 2, 2>;  // MaxPool3d_5a
using Window333s111 = Window<3, 3, 3, 1, 1, 1>;  // branch 3 of Mixed_*

// The running max without its tap (no offsets to write): NaN propagates;
// where +0 and -0 tie either may come out.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ __nv_bfloat16 max_nan(__nv_bfloat16 a,
                                                 __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (b > a || isnan(b)) ? b : a;
}

// The later tap of the scan into the running max: with its tap where the
// offsets are written, by max_nan where they are not.
template <bool kOffsets, typename T>
__device__ __forceinline__ void take(T& v, int& k, T b, int bk) {
  if constexpr (kOffsets) {
    later(v, k, b, bk);
  } else {
    v = max_nan(v, b);
  }
}

// One 16-byte asynchronous copy, device memory -> shared memory, around L1.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Channels last, an I3D window, C a multiple of 16 bytes: a block owns a TH
// x TW output tile of 32 channels, a warp one output column (lanes =
// channels, so every shared-memory access of a warp is 32 consecutive
// channels) walking down the tile's rows.  Each plane's tile and halo is
// copied into one of two shared buffers by 16-byte cp.async a plane ahead of
// the plane being reduced; the positions outside the tensor are -inf in
// both buffers from the start and never copied.  Each warp takes the max
// over W of every input row at its column (KW shared loads a row), over H
// of each output row from those row maxima in registers, and over D from a
// ring of its outputs' last KD plane maxima, with KD - 1 planes of -inf
// after the last to close the windows that hang past it.
template <typename T, bool kOffsets, class Wn, int TH, int TW>
__global__ void __launch_bounds__(32 * TW)
    max_pool3d_same_forward_cl(const T* __restrict__ x, T* __restrict__ y,
                               uint8_t* __restrict__ offsets, Geometry g) {
  constexpr int KD = Wn::KD, KH = Wn::KH, KW = Wn::KW;
  constexpr int SD = Wn::SD, SH = Wn::SH, SW = Wn::SW;
  constexpr int IH = (TH - 1) * SH + KH, IW = (TW - 1) * SW + KW;
  constexpr int kThreadsB = 32 * TW;
  constexpr int kPlane = IH * IW * 32;  // elements of one plane's tile
  constexpr int kVec = 16 / sizeof(T);  // elements a copy moves
  constexpr int kCopies = IH * IW * (32 / kVec);
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);  // [2][IH][IW][32]

  const int tiles_w = (g.OW + TW - 1) / TW;
  const int tiles_h = (g.OH + TH - 1) / TH;
  const int chunks = (g.C + 31) / 32;
  int b = blockIdx.x;
  const int tw = b % tiles_w;
  b /= tiles_w;
  const int th = b % tiles_h;
  b /= tiles_h;
  const int chunk = b % chunks;
  const int n = b / chunks;
  const int lane = threadIdx.x & 31, ow = threadIdx.x >> 5;
  const int c0 = chunk * 32, c = c0 + lane;
  const int oh0 = th * TH, ow0 = tw * TW;
  const int ih0 = oh0 * SH - g.ph, iw0 = ow0 * SW - g.pw;
  const T lo = Num<T>::lowest();
  const int64_t plane_stride = (int64_t)g.H * g.W * g.C;
  auto inside = [&](int pos, int cc) {
    const int gh = ih0 + pos / IW, gw = iw0 + pos % IW;
    return gh >= 0 && gh < g.H && gw >= 0 && gw < g.W && c0 + cc < g.C;
  };

  for (int e = threadIdx.x; e < 2 * kPlane; e += kThreadsB) {
    const int q = e % kPlane;
    if (!inside(q / 32, q % 32)) S[e] = lo;
  }
  const T* xn = x + (int64_t)n * g.D * plane_stride + c0;
  auto copy_plane = [&](int d, int buf) {
    const T* xp = xn + d * plane_stride;
    T* B = S + buf * kPlane;
    for (int e = threadIdx.x; e < kCopies; e += kThreadsB) {
      const int pos = e / (32 / kVec), cv = (e % (32 / kVec)) * kVec;
      if (inside(pos, cv)) {
        const int gh = ih0 + pos / IW, gw = iw0 + pos % IW;
        copy16(B + pos * 32 + cv, xp + ((int64_t)gh * g.W + gw) * g.C + cv);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the last KD plane maxima of each output row; their in-plane taps
  // (< 16) packed four bits a plane, the newest plane highest
  T ring[TH][KD];
  int ring_k[TH];
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    ring_k[i] = 0;
#pragma unroll
    for (int t = 0; t < KD; ++t) ring[i][t] = lo;
  }
  const bool live_c = c < g.C;
  const int64_t out_col = (int64_t)(ow0 + ow) * g.C + c;
  const int64_t out_row = (int64_t)g.OW * g.C;
  copy_plane(0, 0);
  for (int d = 0; d < g.D + KD - 1; ++d) {
    if (d < g.D) {
      if (d + 1 < g.D) {
        copy_plane(d + 1, (d + 1) & 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      // each input row's max over W at this column, folded in row order
      // into the H max of every output row whose window holds the row
      const T* B = S + (d & 1) * kPlane + ow * SW * 32 + lane;
      T hv[TH];
      int hk[TH];
#pragma unroll
      for (int ih = 0; ih < IH; ++ih) {
        const T* row = B + ih * IW * 32;
        T v = row[0];
        int k = 0;
#pragma unroll
        for (int j = 1; j < KW; ++j) take<kOffsets>(v, k, row[j * 32], j);
#pragma unroll
        for (int oh = 0; oh < TH; ++oh) {
          const int r = ih - oh * SH;
          if (r < 0 || r >= KH) continue;
          if (r == 0) {
            hv[oh] = v;
            hk[oh] = k;
          } else {
            take<kOffsets>(hv[oh], hk[oh], v, r * KW + k);
          }
          if (r == KH - 1) {  // onto the ring
#pragma unroll
            for (int t = 0; t + 1 < KD; ++t) ring[oh][t] = ring[oh][t + 1];
            ring[oh][KD - 1] = hv[oh];
            ring_k[oh] = (ring_k[oh] >> 4) | (hk[oh] << (4 * (KD - 1)));
          }
        }
      }
      __syncthreads();  // this buffer takes plane d + 2 next
    } else {
#pragma unroll
      for (int oh = 0; oh < TH; ++oh) {  // a plane of -inf onto the ring
#pragma unroll
        for (int t = 0; t + 1 < KD; ++t) ring[oh][t] = ring[oh][t + 1];
        ring[oh][KD - 1] = lo;
        ring_k[oh] >>= 4;
      }
    }
    // the output whose last plane is d: ring slot t holds its tap plane t
    const int a = d + g.pd - (KD - 1);
    if (a < 0 || a % SD != 0 || a / SD >= g.OD || !live_c ||
        ow0 + ow >= g.OW)
      continue;
    const int od = a / SD;
    const int64_t base =
        (((int64_t)n * g.OD + od) * g.OH + oh0) * out_row + out_col;
#pragma unroll
    for (int oh = 0; oh < TH; ++oh) {
      T v = ring[oh][0];
      int k = ring_k[oh] & 15;
#pragma unroll
      for (int t = 1; t < KD; ++t)
        take<kOffsets>(v, k, ring[oh][t],
                       t * KH * KW + ((ring_k[oh] >> (4 * t)) & 15));
      if (oh0 + oh < g.OH) {
        y[base + oh * out_row] = v;
        if constexpr (kOffsets) offsets[base + oh * out_row] = (uint8_t)k;
      }
    }
  }
}

// Channels last, an I3D window: the backward.  A block owns an IT x IT
// tile of input positions and 32 channels (lanes), over every plane, and
// sums each input's gradient in shared memory: for each output plane od in
// order, each warp loads one column of the outputs whose windows reach the
// tile (their offset and gradient, once), and adds each gradient at the
// input its offset names, in KW phases, one for each column tap, with a
// barrier between them: within a phase two warps never name the same input
// (their columns differ), and one warp adds in its rows' order.  So every
// input's sum runs in one fixed order, without atomics.  The sums live in a
// ring of KD planes; a plane that no later output can name is written out
// and cleared.  Taps in the padding name no input and drop out, as the
// plain version's padded copy drops them.
template <class Wn, int IT>
__host__ __device__ constexpr int backward_columns() {
  return (IT + Wn::KW - 2) / Wn::SW + 1;
}

// Blocks an SM the backward's registers leave room for (PERF.md, section 6):
// held to 3, the KD = 2 and 3 windows ran 10-17% faster than as the
// compiler chose; the (1, 3, 3) window ran 7-17% slower at 3 and 55% slower
// at 1 (16-row tiles), so it is held to 2.
template <class Wn>
__host__ __device__ constexpr int backward_min_blocks() {
  return Wn::KD == 1 ? 2 : 3;
}

template <typename T, class Wn, int IT>
__global__ void __launch_bounds__(32 * backward_columns<Wn, IT>(),
                                  backward_min_blocks<Wn>())
    max_pool3d_same_backward_cl(const T* __restrict__ gy,
                                const uint8_t* __restrict__ offsets,
                                T* __restrict__ gx, Geometry g) {
  using Acc = typename Num<T>::Acc;
  constexpr int KD = Wn::KD, KH = Wn::KH, KW = Wn::KW;
  constexpr int SD = Wn::SD, SH = Wn::SH, SW = Wn::SW;
  constexpr int OTH = (IT + KH - 2) / SH + 1;  // output rows reaching a tile
  constexpr int OTW = backward_columns<Wn, IT>();
  constexpr int kSlot = IT * IT * 32;
  constexpr uint8_t kNone = 0xff;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* acc = reinterpret_cast<Acc*>(smem);  // [KD][IT][IT][32]

  const int tiles_w = (g.W + IT - 1) / IT, tiles_h = (g.H + IT - 1) / IT;
  const int chunks = (g.C + 31) / 32;
  int b = blockIdx.x;
  const int tw = b % tiles_w;
  b /= tiles_w;
  const int th = b % tiles_h;
  b /= tiles_h;
  const int chunk = b % chunks;
  const int n = b / chunks;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = chunk * 32 + lane;
  const bool live_c = c < g.C;
  const int ih0 = th * IT, iw0 = tw * IT;
  const int num_h = ih0 + g.ph - KH + 1, num_w = iw0 + g.pw - KW + 1;
  const int oh_lo = num_h <= 0 ? 0 : (num_h + SH - 1) / SH;
  const int ow = (num_w <= 0 ? 0 : (num_w + SW - 1) / SW) + w;
  const bool live_col = live_c && ow < g.OW;

  for (int e = threadIdx.x; e < KD * kSlot; e += 32 * OTW) acc[e] = 0;
  // write planes [from, to) of the tile out and clear their slots
  auto flush = [&](int from, int to) {
    for (int p = max(from, 0); p < min(to, g.D); ++p) {
      Acc* slot = acc + (p % KD) * kSlot;
      const int64_t plane = ((int64_t)n * g.D + p) * g.H;
      for (int e = w; e < IT * IT; e += OTW) {
        const int ih = ih0 + e / IT, iw = iw0 + e % IT;
        if (live_c && ih < g.H && iw < g.W)
          gx[((plane + ih) * g.W + iw) * g.C + c] =
              Num<T>::store(slot[e * 32 + lane]);
        slot[e * 32 + lane] = 0;
      }
    }
  };

  int next = 0;  // the first plane not yet written out
  const int iw_base = ow * SW - g.pw - iw0;
  // step j loads output plane j's column of offsets and gradients into
  // registers (in flight over the step's phases) and adds plane j - 1's
  uint8_t kk[OTH];
  Acc gg[OTH];
  for (int j = 0; j <= g.OD; ++j) {
    uint8_t k_now[OTH];
    Acc g_now[OTH];
#pragma unroll
    for (int r = 0; r < OTH; ++r) {
      k_now[r] = kk[r];
      g_now[r] = gg[r];
      const int oh = oh_lo + r;
      kk[r] = kNone;
      gg[r] = 0;
      if (j < g.OD && live_col && oh < g.OH) {
        const int64_t o =
            (((int64_t)n * g.OD + j) * g.OH + oh) * g.OW * g.C +
            (int64_t)ow * g.C + c;
        kk[r] = offsets[o];
        gg[r] = Num<T>::key(gy[o]);
      }
    }
    if (j == 0) {
      __syncthreads();  // the cleared sums
      continue;
    }
    const int first = (j - 1) * SD - g.pd;
    if (first > next) {  // no later output names the planes before first
      flush(next, first);
      next = first;
      __syncthreads();
    }
#pragma unroll
    for (int phase = 0; phase < KW; ++phase) {
      const int iw = iw_base + phase;
#pragma unroll
      for (int r = 0; r < OTH; ++r) {
        const int k = k_now[r];
        if (k == kNone || k % KW != phase) continue;
        const int p = first + k / (KH * KW);
        const int ih = (oh_lo + r) * SH - g.ph + (k / KW) % KH - ih0;
        if (p >= 0 && p < g.D && ih >= 0 && ih < IT && ih0 + ih < g.H &&
            iw >= 0 && iw < IT && iw0 + iw < g.W)
          acc[(p % KD) * kSlot + (ih * IT + iw) * 32 + lane] += g_now[r];
      }
      __syncthreads();
    }
  }
  flush(next, g.D);
}

template <typename T, bool kOffsets, class Wn, int TH, int TW>
cudaError_t forward_cl(const void* x, void* y, void* offsets,
                       const Geometry& g, cudaStream_t stream) {
  auto kernel = max_pool3d_same_forward_cl<T, kOffsets, Wn, TH, TW>;
  constexpr int IH = (TH - 1) * Wn::SH + Wn::KH;
  constexpr int IW = (TW - 1) * Wn::SW + Wn::KW;
  const size_t smem = 2 * (size_t)IH * IW * 32 * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)g.N * ((g.C + 31) / 32) *
                         ((g.OH + TH - 1) / TH) * ((g.OW + TW - 1) / TW);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 32 * TW, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<uint8_t*>(offsets), g);
  return cudaGetLastError();
}

template <typename T, class Wn, int TH, int TW>
cudaError_t forward_cl_tile(const void* x, void* y, void* offsets,
                            const Geometry& g, cudaStream_t stream) {
  return offsets != nullptr
             ? forward_cl<T, true, Wn, TH, TW>(x, y, offsets, g, stream)
             : forward_cl<T, false, Wn, TH, TW>(x, y, offsets, g, stream);
}

template <class Wn>
bool is_window(const Geometry& g) {
  return g.kd == Wn::KD && g.kh == Wn::KH && g.kw == Wn::KW &&
         g.sd == Wn::SD && g.sh == Wn::SH && g.sw == Wn::SW;
}

// The forward for an I3D window and the wrapper's tile
// (ops/max_pool.py::TILES), where C is a multiple of 16 bytes and x 16-byte
// aligned; cudaErrorNotSupported where none is built.
template <typename T>
cudaError_t forward_cl_typed(const void* x, void* y, void* offsets,
                             const Geometry& g, cudaStream_t stream) {
  const bool t7 = g.TH == 7 && g.TW == 7, t8 = g.TH == 8 && g.TW == 8;
  if (g.C % (16 / sizeof(T)) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorNotSupported;
  if (is_window<Window133s122>(g) && t8)
    return forward_cl_tile<T, Window133s122, 8, 8>(x, y, offsets, g, stream);
  if (is_window<Window133s122>(g) && t7)
    return forward_cl_tile<T, Window133s122, 7, 7>(x, y, offsets, g, stream);
  if (is_window<Window333s222>(g) && t7)
    return forward_cl_tile<T, Window333s222, 7, 7>(x, y, offsets, g, stream);
  if (is_window<Window222s222>(g) && t7)
    return forward_cl_tile<T, Window222s222, 7, 7>(x, y, offsets, g, stream);
  if (is_window<Window333s111>(g) && t7)
    return forward_cl_tile<T, Window333s111, 7, 7>(x, y, offsets, g, stream);
  return cudaErrorNotSupported;
}

template <typename T, class Wn, int IT>
cudaError_t backward_cl(const void* gy, const void* offsets, void* gx,
                        const Geometry& g, cudaStream_t stream) {
  auto kernel = max_pool3d_same_backward_cl<T, Wn, IT>;
  const size_t smem =
      (size_t)Wn::KD * IT * IT * 32 * sizeof(typename Num<T>::Acc);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)g.N * ((g.C + 31) / 32) *
                         ((g.H + IT - 1) / IT) * ((g.W + IT - 1) / IT);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, 32 * backward_columns<Wn, IT>(), smem,
           stream>>>(static_cast<const T*>(gy),
                     static_cast<const uint8_t*>(offsets),
                     static_cast<T*>(gx), g);
  return cudaGetLastError();
}

// The backward for an I3D window; its input tile: 16 for
// the stride-2 (1, 3, 3) window where it divides the plane, else 14 at
// stride 2 and 7 at stride 1.  cudaErrorNotSupported for other windows.
template <typename T>
cudaError_t backward_cl_typed(const void* gy, const void* offsets, void* gx,
                              const Geometry& g, cudaStream_t stream) {
  if (is_window<Window133s122>(g))
    return g.H % 16 == 0 && g.W % 16 == 0
               ? backward_cl<T, Window133s122, 16>(gy, offsets, gx, g, stream)
               : backward_cl<T, Window133s122, 14>(gy, offsets, gx, g, stream);
  if (is_window<Window333s222>(g))
    return backward_cl<T, Window333s222, 14>(gy, offsets, gx, g, stream);
  if (is_window<Window222s222>(g))
    return backward_cl<T, Window222s222, 14>(gy, offsets, gx, g, stream);
  if (is_window<Window333s111>(g))
    return backward_cl<T, Window333s111, 7>(gy, offsets, gx, g, stream);
  return cudaErrorNotSupported;
}

Geometry geometry(int N, int C, int D, int H, int W, int OD, int OH, int OW,
                  int kd, int kh, int kw, int sd, int sh, int sw, int pd,
                  int ph, int pw, int TH, int TW) {
  return Geometry{N,  C,  D,  H,  W,  OD, OH, OW, kd, kh,
                  kw, sd, sh, sw, pd, ph, pw, TH, TW};
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float64.  Writes y [N, C, OD, OH, OW]
// channels last and, where offsets is not null, each output's tap (uint8,
// the same layout).  TH, TW are the wrapper's tile
// (ops/max_pool.py::tile_plan).  cudaErrorNotSupported for a window, tile
// or channel count that no kernel is built for.
cudaError_t max_pool3d_same_forward(const void* x, void* y, void* offsets,
                                    int dtype, int N, int C, int D, int H,
                                    int W, int OD, int OH, int OW, int kd,
                                    int kh, int kw, int sd, int sh, int sw,
                                    int pd, int ph, int pw, int TH, int TW,
                                    cudaStream_t stream) {
  const Geometry g = geometry(N, C, D, H, W, OD, OH, OW, kd, kh, kw, sd, sh,
                              sw, pd, ph, pw, TH, TW);
  switch (dtype) {
    case 0:
      return forward_cl_typed<float>(x, y, offsets, g, stream);
    case 1:
      return forward_cl_typed<__nv_bfloat16>(x, y, offsets, g, stream);
    case 2:
      return forward_cl_typed<double>(x, y, offsets, g, stream);
  }
  return cudaErrorInvalidValue;
}

// Writes gx [N, C, D, H, W] channels last, as gy and offsets are.
cudaError_t max_pool3d_same_backward(const void* gy, const void* offsets,
                                     void* gx, int dtype, int N, int C,
                                     int D, int H, int W, int OD, int OH,
                                     int OW, int kd, int kh, int kw, int sd,
                                     int sh, int sw, int pd, int ph, int pw,
                                     cudaStream_t stream) {
  const Geometry g = geometry(N, C, D, H, W, OD, OH, OW, kd, kh, kw, sd, sh,
                              sw, pd, ph, pw, 0, 0);
  switch (dtype) {
    case 0:
      return backward_cl_typed<float>(gy, offsets, gx, g, stream);
    case 1:
      return backward_cl_typed<__nv_bfloat16>(gy, offsets, gx, g, stream);
    case 2:
      return backward_cl_typed<double>(gy, offsets, gx, g, stream);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
