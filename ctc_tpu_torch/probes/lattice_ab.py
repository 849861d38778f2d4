"""The whole-lattice kernels before and after their redesign, side by side
on one card: rows 2 and 6, the backward (``--pass backward``, the
default), or rows 1 and 5, the forward (``--pass forward``).

    python -m ctc_tpu_torch.probes.lattice_ab --parent DIR
    python -m ctc_tpu_torch.probes.lattice_ab --parent DIR --plans --cycles
    python -m ctc_tpu_torch.probes.lattice_ab --parent DIR --pass forward \
        [--plans] [--cycles]

``DIR`` holds a tree from before the redesign of the pass's kernels
(``git archive <commit> | tar -x -C DIR``).  Its two lattice sources are
compiled with the flags of ``ops/cuda_build.py``
(``shard_ab.build_parent``, both at once) and their
``*_lattice_backward`` (``*_lattice_forward``) launchers called with that
tree's arguments (``OLD_SIGNATURES``: no plan, one block a sample, the row
loop; the forward writes alpha only, and ``gather_nll``'s torch ops take
the NLL from it, as that tree's op ran them).  "after" is this package's
``noblank_grad_kernel`` / ``blank_grad_kernel`` in the layout
``backward_plan`` picks for the width (``noblank_alpha_kernel`` /
``blank_alpha_kernel``, alpha and the NLL from one launch in the layout
``forward_plan`` picks).

For each family at the smoke's main-path shape and its second shape
(``SHAPES``), it prints one JSON line per side: the kernel's device time
from ``torch.profiler`` (the median of ``shard_ab.WINDOWS`` windows, taken
twice in turns: before, after, after, before; each run's median and the
min and max of its windows), ``step_us`` and, on the "after" line, the
plan and max |dev| of g from the "before" side's.  The forward's lines
also hold the whole op's device time and device kernels a call (before:
the kernel and ``gather_nll``; after: the kernel alone) and, on the
"after" line, max |dev| of alpha's reachable cells and of the NLL.  Then
one line per family and side of the T=10 train step at the main path's
shape (the pass's kernel swapped, the rest unchanged; 20 steps after 5
warm-up, in turns): host ms per step and, from a profiled window of the
same steps, device ms, device kernels, the device's busy share and the
lattice kernels' device us per step.

``--plans`` also times every layout the launchers take at each shape
(``candidate_plans`` / ``candidate_forward_plans``, launched through
``grad_in_plan`` / ``forward_in_plan``; the forward also at
``WIDE_SHAPES``, rows wider than the pairs layout takes), each with max
|dev| from the planned layout's output.  ``--cycles`` builds this tree's
sources with block 0's thread 0 reading ``clock64()`` and
``%globaltimer`` around the steps (the backward: the chunk loop of the
warps layout and of the chunked body; the forward: the step loops of the
warp, pairs and block layouts; the clock of ``shard_sweep``'s ``cycles``
build) and prints, at the plan's layout (the forward: at every layout),
the SM cycles a step (the backward: the waits for alpha and the weights
included) and the SM clock.  ``--builds`` times one-place builds of the
source at the plan's layout, with the same clock reads, each in turns with
the unchanged source's (cycles, build, build, cycles): the forward's
steps without their alpha store, their em copy or their log-add, with
libm's log1pf, or noblank's pairs in 4-byte copies and stores
(``FORWARD_BUILDS``); the backward with the forward's branch-free log1pf
(``BACKWARD_BUILDS``).
``--check-log1p`` compares the kernels' branch-free ``log1pf`` with
CUDA's at every float in [0, 1].  The first line is the card's name and
power limit.  Card only.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops.lattice_cuda import _check
from ctc_tpu_torch.probes import max_abs_dev, shard_sweep
from ctc_tpu_torch.probes.ring_sweep import card_line
from ctc_tpu_torch.probes.ring_sweep import device_ms
from ctc_tpu_torch.probes.shard_ab import (
    CLASSES, WINDOWS, _device_us, build_parent, device_events, train_step,
    windows_ms,
)
from ctc_tpu_torch.train.trainer import resolve_device

# [T, B, labels]: chip_smoke.py's MAIN_SHAPE and BLANK_MAIN_SHAPE, and its
# second shapes, bench.py's (blank: S = 2 labels + 1 = 11 and 41)
SHAPES = {"noblank": {"main_path": (10, 256, 10), "second": (128, 1024, 157)},
          "blank": {"main_path": (10, 256, 5), "second": (128, 1024, 20)}}
# rows wider than the pairs layout takes, a block a sample on every SM:
# the smoke's wide_L and wide_S widths, and rows where only a two-row em
# ring fits in the block layout (the forward's --plans only)
WIDE_SHAPES = {"noblank": {"wide": (64, 132, 1500), "wider": (32, 132, 9000)},
               "blank": {"wide": (64, 132, 750), "wider": (32, 132, 4500)}}
#: the one-place builds (``--builds``), each with the clock reads of
#: ``--cycles``: the forward's steps store no alpha (nostore), copy no em
#: into the ring, so that they read whatever it holds (noload), log-add by
#: the max alone (nolse) or by CUDA's log1pf in place of its branch-free
#: copy (libm), or noblank's pairs layout copying and storing its two cells
#: 4 bytes at a time at every B L (pairs4; blank's source unchanged); the
#: backward's log-add by the branch-free copy (flat)
FORWARD_BUILDS = ("nostore", "noload", "nolse", "libm", "pairs4")
BACKWARD_BUILDS = ("flat",)
_WARPS_COPY = ("      if (real) cp_async::copy4(ring_s + "
               "(staged & (kDepth - 1)) * slot, src);\n")
_FWD_EDITS = {
    "nostore": {
        "noblank": [("        *out = a;\n", ""),
                    ("    if (paired && real0 && real1) {\n"
                     "      *reinterpret_cast<float2*>(out) = "
                     "make_float2(a0, a1);\n    } else {\n"
                     "      if (real0) out[0] = a0;\n"
                     "      if (real1) out[1] = a1;\n    }\n", "")],
        "blank": [("        *out = a;\n", ""),
                  ("    if (real0) out[0] = a0;\n"
                   "    if (real1) out[1] = a1;\n", "")]},
    "noload": {
        "noblank": [(_WARPS_COPY, ""),
                    ("      if (paired && real1) {\n"
                     "        cp_async::copy8(dst, src);\n      } else {\n"
                     "        if (real0) cp_async::copy4(dst, src);\n"
                     "        if (real1) cp_async::copy4(dst + 4, src + 1);\n"
                     "      }\n", "")],
        "blank": [(_WARPS_COPY, ""),
                  ("      if (real0) cp_async::copy4(dst, src);\n"
                   "      if (real1) cp_async::copy4(dst + slot, src + 1);\n",
                   "")]},
    "nolse": {family: [("  return m + log1p_unit(expf(-fabsf(a - b)));",
                        "  return m;")]
              for family in ("noblank", "blank")},
    "libm": {family: [("  return m + log1p_unit(expf(-fabsf(a - b)));",
                       "  return m + log1pf(expf(-fabsf(a - b)));")]
             for family in ("noblank", "blank")},
    "pairs4": {"noblank": [("  const bool paired = (row_stride & 1) == 0;"
                            "  // 8-byte pairs\n",
                            "  const bool paired = false;\n")],
               "blank": []},
    "flat": {family: [("  return m + log1pf(expf(-fabsf(a - b)));",
                       "  return m + log1p_unit(expf(-fabsf(a - b)));")]
             for family in ("noblank", "blank")},
}
# the exhaustive check of the kernels' branch-free log1pf (--check-log1p):
# every float in [0, 1] and a NaN, its bits against CUDA's log1pf
_LOG1P_CHECK = '''#include "log_add.cuh"

__global__ void log1p_check_kernel(unsigned long long* mismatches,
                                   unsigned* first) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i <= 0x3f800000u;
       i += stride) {
    const float a = __uint_as_float(i);
    if (__float_as_uint(log1pf(a)) != __float_as_uint(log1p_unit(a))) {
      atomicAdd(mismatches, 1ull);
      atomicMin(first, i);
    }
  }
  const float nan = __uint_as_float(0x7fc00000u);
  if (blockIdx.x == 0 && threadIdx.x == 0 && !isnan(log1p_unit(nan))) {
    atomicAdd(mismatches, 1ull);
  }
}

extern "C" cudaError_t log1p_check(unsigned long long* mismatches,
                                   unsigned* first) {
  log1p_check_kernel<<<1024, 256>>>(mismatches, first);
  return cudaGetLastError();
}
'''
PASSES = ("backward", "forward")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the earlier tree's whole-lattice launchers, by pass: the backward's
#: alpha, [skip_ok,] inlen, tgt, nll_bar, g, T, B, W, stream; the
#: forward's em, tgt or skip_ok, alpha, T, B, W, stream
OLD_SIGNATURES = {"backward": {"noblank": (*(_P,) * 5, *(_I,) * 3, _P),
                               "blank": (*(_P,) * 6, *(_I,) * 3, _P)},
                  "forward": {"noblank": (*(_P,) * 3, *(_I,) * 3, _P),
                              "blank": (*(_P,) * 3, *(_I,) * 3, _P)}}
CYCLES_DIR = cuda_build.BUILD_DIR / "lattice_ab"
# the clock reads of the ``cycles`` build: shard_sweep's around the chunked
# body's chunk loop (the chunks-warp layout), and around the warps layout's
# chunk loop, up to the end of its function
_WARPS_START = "  for (int c = 0; c < chunk_count; ++c) {\n"
_WARPS_STOP = "}\n\n// The whole-lattice backward's layouts"
# the forward's: shard_sweep's forward reads around the steps after step 0
# of the warps and block bodies (the warp and block layouts), a stop read
# where the whole lattice's warps body returns, and reads around the pairs
# layout's step loop
_FWD_WARP_STOP = "  if constexpr (kWhole) return;  // nll is written\n"
_PAIRS_START = "  int t = 0;\n  for (; t + kDepth <= T; t += kDepth) {\n"
_PAIRS_STOP = {
    "noblank": "  // the final cell, read back by the thread that stored it\n",
    "blank": "  __syncthreads();  // publishes the final cells, stored by "
             "their threads\n"}


def make_forward_case(family, shape, gen):
    """The forward kernel's operands on the card, as ``chip_smoke.py``'s
    ``phase_times*`` make them, drawn from ``gen``: em (blank: the gather of
    log-softmaxed random logits of the smoke's 157 classes, and its skip
    mask) and int32 lengths with sample 0 at the full T and labels.
    Returns the arguments of ``*_alpha_kernel``."""
    T, B, labels = shape
    if family == "noblank":
        em = torch.randn((T, B, labels), generator=gen) - 1.0
        inlen = torch.randint(1, T + 1, (B,), generator=gen)
        tgt = torch.randint(1, labels + 1, (B,), generator=gen)
        inlen[0], tgt[0] = T, labels
        head = (em.to("cuda"),)
        tgt = torch.minimum(tgt, inlen)
    else:
        logits = torch.randn((T, B, CLASSES["blank"]), generator=gen)
        targets = torch.randint(1, CLASSES["blank"], (B, labels),
                                generator=gen)
        inlen = torch.randint(min(2 * labels + 1, T), T + 1, (B,),
                              generator=gen)
        tgt = torch.randint(1, labels + 1, (B,), generator=gen)
        inlen[0], tgt[0] = T, labels
        em, skip = blank_emissions_and_skip(torch.log_softmax(logits, 2),
                                            targets, 0)
        head = (em.contiguous().to("cuda"), skip.to(torch.uint8).to("cuda"))
    return (*head, inlen.int().to("cuda"), tgt.int().to("cuda"))


def make_case(family, shape, seed):
    """The backward kernel's operands on the card: alpha from this
    package's forward kernel over :func:`make_forward_case`'s operands,
    then a random cotangent.  Returns the arguments of ``*_grad_kernel``."""
    gen = torch.Generator().manual_seed(seed)
    args = make_forward_case(family, shape, gen)
    alpha = new_forward(family)(*args)[0]
    return (alpha, *args[1:],
            torch.randn((shape[1],), generator=gen).to("cuda"))


def old_grad(family, lib):
    """The earlier tree's backward launcher with the arguments of this
    package's ``*_grad_kernel``: g from alpha, no plan."""
    name = f"{family}_lattice_backward"
    fn = getattr(lib, name)

    def grad(alpha, *rest):
        g = torch.empty_like(alpha)
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        _check(fn(alpha.data_ptr(), *(t.data_ptr() for t in rest),
                  g.data_ptr(), *alpha.shape, stream), name)
        return g

    return grad


def old_forward(family, lib):
    """The earlier tree's forward launcher with the arguments and outputs
    of this package's ``*_alpha_kernel``: its kernel for alpha (from em
    and tgt, blank em and skip_ok), then ``gather_nll``'s torch ops."""
    name = f"{family}_lattice_forward"
    fn = getattr(lib, name)
    gather = lc.gather_nll if family == "noblank" else bl.gather_nll

    def forward(em, *rest):
        inlen, tgt = rest[-2:]
        operand = tgt if family == "noblank" else rest[0]
        alpha = torch.empty_like(em)
        stream = torch.cuda.current_stream(em.device).cuda_stream
        _check(fn(em.data_ptr(), operand.data_ptr(), alpha.data_ptr(),
                  *em.shape, stream), name)
        return alpha, gather(alpha, inlen, tgt)

    return forward


def new_grad(family):
    return lc.noblank_grad_kernel if family == "noblank" else (
        bl.blank_grad_kernel)


def new_forward(family):
    return lc.noblank_alpha_kernel if family == "noblank" else (
        bl.blank_alpha_kernel)


def kernels(family, label, old, card):
    """The before and after rows of one family's backward at one shape."""
    args = make_case(family, SHAPES[family][label], seed=7)
    new = new_grad(family)
    symbol = f"{family}_backward_kernel"
    sides = {"before": lambda: old(*args), "after": lambda: new(*args)}
    runs = {side: [] for side in sides}
    for side in ("before", "after", "after", "before"):
        sides[side]()
        runs[side].append(windows_ms(sides[side], symbol))
    want, got = old(*args), new(*args)
    torch.cuda.synchronize()
    alpha = args[0]
    rows = []
    for side in sides:
        medians = [m for m, _ in runs[side]]
        row = {"probe": "lattice_ab", "pass": "backward", "family": family,
               "kernel": f"{family}_lattice_backward", "side": side,
               "shape": label, "shape_TBW": list(alpha.shape),
               "device_ms_runs": medians,
               "device_ms_min_max_runs": [mm for _, mm in runs[side]],
               "step_us_runs": [m * 1e3 / alpha.shape[0]
                                if m is not None else None for m in medians],
               "windows": WINDOWS, "card": card}
        if side == "after":
            row["plan"] = list(lc.backward_plan(alpha.shape[2],
                                                family == "blank"))
            row["max_abs_dev_from_before"] = max_abs_dev(got, want)
        rows.append(row)
    return rows


def op_device(fn, iters=20):
    """The median over ``WINDOWS`` profiled windows of the device time of
    one call of ``fn`` (every kernel it launches), and the device kernels
    a call launches."""
    from torch.profiler import ProfilerActivity, profile

    ms, count = [], None
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        ms.append(sum(_device_us(e) for e in events) / iters / 1e3)
        count = sum(e.count for e in events) / iters
    return statistics.median(ms), count


def reachable(family, alpha):
    """The cells of ``alpha`` a path reaches (the rest hold about the
    family's sentinel)."""
    return alpha > (-1e12 if family == "noblank" else -1e29)


def window_median(windows):
    """The median of the windows that read the kernel (a profiled window
    may catch none of its events: None), None if none did."""
    got = [ms for ms in windows if ms is not None]
    return statistics.median(got) if got else None


def forward_kernels(family, label, old, card):
    """The before and after rows of one family's forward at one shape."""
    args = make_forward_case(family, SHAPES[family][label],
                             torch.Generator().manual_seed(7))
    new = new_forward(family)
    symbol = f"{family}_forward_kernel"
    sides = {"before": lambda: old(*args), "after": lambda: new(*args)}
    runs = {side: [] for side in sides}
    ops = {side: [] for side in sides}
    for side in ("before", "after", "after", "before"):
        sides[side]()
        runs[side].append([device_ms(sides[side], symbol)
                           for _ in range(WINDOWS)])
        ops[side].append(op_device(sides[side]))
    (alpha_w, nll_w), (alpha_g, nll_g) = old(*args), new(*args)
    torch.cuda.synchronize()
    reach = reachable(family, alpha_w)
    em = args[0]
    rows = []
    for side in sides:
        medians = [window_median(w) for w in runs[side]]
        row = {"probe": "lattice_ab", "pass": "forward", "family": family,
               "kernel": f"{family}_lattice_forward", "side": side,
               "shape": label, "shape_TBW": list(em.shape),
               "device_ms_runs": medians,
               "device_ms_windows_runs": runs[side],
               "step_us_runs": [m * 1e3 / em.shape[0]
                                if m is not None else None for m in medians],
               "op_device_ms_runs": [m for m, _ in ops[side]],
               "op_kernels_per_call_runs": [k for _, k in ops[side]],
               "windows": WINDOWS, "card": card}
        if side == "after":
            row["plan"] = list(lc.forward_plan(em.shape[2],
                                               family == "blank"))
            row["max_abs_dev_from_before"] = {
                "alpha_reachable": max_abs_dev(alpha_g[reach],
                                               alpha_w[reach]),
                "nll": max_abs_dev(nll_g, nll_w)}
        rows.append(row)
    return rows


def candidate_plans(width, blank):
    """Every layout the backward launchers take at ``width``: up to 32
    cells the chunks-warp layout at 32, 128, 256 and 512 threads; up to
    1024 the warps layout; the rows layout."""
    plans = []
    if width <= lc.BACKWARD_NARROW_WIDTH:
        plans += [("chunks_warp", lc.BACKWARD_NARROW_CHUNK, n)
                  for n in (32, 128, 256, 512)]
    if width <= lc.BACKWARD_WARPS_WIDTH:
        plans.append(("warps", lc.BACKWARD_WARPS_CHUNK, -(-width // 64) * 32))
    plans.append(("rows", 0, min(-(-width // 32) * 32,
                                 lc.BACKWARD_ROWS_THREADS)))
    full = [(layout, chunk, n,
             lc.backward_bytes(layout, width, chunk, n, blank))
            for layout, chunk, n in plans]
    return [plan for plan in full if plan[3] <= lc.SMEM_LIMIT]


def candidate_forward_plans(width, blank):
    """Every layout the forward launchers take at ``width``: up to 32 cells
    the warp layout at 1, 2, 4 and 8 samples a block; up to 1024 the pairs
    layout; the block layout at the deepest ring that fits beside its
    static shared memory; the rows layout."""
    depth = lc.FORWARD_DEPTH
    plans = []
    if width <= lc.FORWARD_WARP_WIDTH:
        plans += [("warp", depth, n) for n in (32, 64, 128, 256)]
    if width <= lc.FORWARD_PAIRS_WIDTH:
        plans.append(("pairs", depth, lc.pairs_threads(width, blank)))
    row = min(-(-width // 32) * 32, 1024)
    block = lc.block_depth(width, blank)
    if block is not None:
        plans.append(("block", block, row))
    plans.append(("rows", 0, row))
    full = [(layout, depth, n,
             lc.forward_bytes(layout, width, depth, n, blank))
            for layout, depth, n in plans]
    return [plan for plan in full if plan[3] <= lc.SMEM_LIMIT]


def grad_in_plan(family, args, plan, counts):
    """``*_grad_kernel``'s launch with ``args`` in ``plan`` (a layout
    ``backward_plan`` may not pick at the width), counted in ``counts``."""
    name = f"{family}_lattice_backward"
    return lc.launch(f"{family}_lattice.cu", name, counts, args,
                     torch.empty_like(args[0]),
                     lc.backward_dims(args[0].shape, plan))


def forward_in_plan(family, args, plan, counts):
    """``*_alpha_kernel``'s launch with ``args`` in ``plan`` (a layout
    ``forward_plan`` may not pick at the width), counted in ``counts``;
    returns ``(alpha, nll)``."""
    name = f"{family}_lattice_forward"
    em = args[0]
    return lc.launch(f"{family}_lattice.cu", name, counts, args,
                     lc.forward_outputs(em), lc.forward_dims(em.shape, plan))


def plans(family, label, card):
    """Each candidate backward plan's device time at one shape."""
    args = make_case(family, SHAPES[family][label], seed=7)
    alpha = args[0]
    want = new_grad(family)(*args)
    counts = collections.Counter()
    rows = []
    for plan in candidate_plans(alpha.shape[2], family == "blank"):
        def call(plan=plan):
            return grad_in_plan(family, args, plan, counts)
        got = call()
        torch.cuda.synchronize()
        median, min_max = windows_ms(call, f"{family}_backward_kernel")
        row = {"probe": "lattice_ab_plans", "pass": "backward",
               "family": family, "shape": label,
               "shape_TBW": list(alpha.shape), "plan": list(plan),
               "device_ms": median, "device_ms_min_max": min_max,
               "step_us": (median * 1e3 / alpha.shape[0]
                           if median is not None else None),
               "max_abs_dev_from_plan": max_abs_dev(got, want),
               "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def forward_plans(family, label, shape, card):
    """Each candidate forward plan's device time at one shape, with max
    |dev| of alpha's reachable cells and of the NLL from the planned
    layout's."""
    args = make_forward_case(family, shape, torch.Generator().manual_seed(7))
    em = args[0]
    alpha_w, nll_w = new_forward(family)(*args)
    reach = reachable(family, alpha_w)
    counts = collections.Counter()
    rows = []
    for plan in candidate_forward_plans(em.shape[2], family == "blank"):
        def call(plan=plan):
            return forward_in_plan(family, args, plan, counts)
        alpha, nll = call()
        torch.cuda.synchronize()
        median, min_max = windows_ms(call, f"{family}_forward_kernel")
        row = {"probe": "lattice_ab_plans", "pass": "forward",
               "family": family, "shape": label,
               "shape_TBW": list(em.shape), "plan": list(plan),
               "device_ms": median, "device_ms_min_max": min_max,
               "step_us": (median * 1e3 / em.shape[0]
                           if median is not None else None),
               "max_abs_dev_from_plan": {
                   "alpha_reachable": max_abs_dev(alpha[reach],
                                                  alpha_w[reach]),
                   "nll": max_abs_dev(nll, nll_w)},
               "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _insert(text, family, edits):
    """``text`` with each ``(anchor, before, after)`` of ``edits`` applied:
    ``before`` put in front of the anchor and ``after`` behind it, the
    anchor once in the source."""
    for anchor, before, after in edits:
        if text.count(anchor) != 1:
            raise ValueError(f"cycles: {anchor!r} is not once in {family}'s "
                             "source")
        text = text.replace(anchor, before + anchor + after)
    return text


_LOG_ADD = '#include "log_add.cuh"\n'


def with_log_add(text: str) -> str:
    """``text`` with ``log_add.cuh``'s include replaced by the header, so
    that a build's edits of the log-add apply to its own copy."""
    if text.count(_LOG_ADD) != 1:
        raise ValueError("log_add.cuh is not included once")
    return text.replace(_LOG_ADD,
                        (cuda_build.CSRC / "log_add.cuh").read_text())


def cycles_source(text: str, family: str, kind: str = "backward") -> str:
    """``<family>_lattice.cu``'s ``text`` with ``log_add.cuh`` inlined and
    the clock read around the steps: the backward's chunk loops of the
    chunked body and of the warps layout, or the forward's step loops of
    the warps body (the warp layout), the block body and the pairs
    layout."""
    read0, read1 = "  sweep_clock_read(0);\n", "  sweep_clock_read(1);\n"
    text = shard_sweep.variant_source(with_log_add(text), family, "cycles",
                                      kind)
    if kind == "backward":
        return _insert(text, family, [(_WARPS_START, read0, ""),
                                      (_WARPS_STOP, read1, "")])
    return _insert(text, family, [(_FWD_WARP_STOP, read1, ""),
                                  (_PAIRS_START, read0, ""),
                                  (_PAIRS_STOP[family], read1, "")])


def variant_source(text: str, family: str, build: str,
                   kind: str = "forward") -> str:
    """``<family>_lattice.cu``'s ``text`` with the pass's ``cycles`` clock
    reads and the edits of ``build`` (one of ``FORWARD_BUILDS`` or
    ``BACKWARD_BUILDS``)."""
    text = cycles_source(text, family, kind)
    for old, new in _FWD_EDITS[build][family]:
        if text.count(old) != 1:
            raise ValueError(f"{build}: {old!r} is not once in {family}'s "
                             "source")
        text = text.replace(old, new)
    return text


def build_cycles(kind="backward", builds=("cycles",)):
    """Compile the pass's ``cycles`` sources (and each of ``builds`` other
    than ``cycles``: ``variant_source``), one ``nvcc`` each, all at once;
    return ``{(build, family): library}`` with the pass's launcher
    typed."""
    CYCLES_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for build in builds:
        for family in SHAPES:
            text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
            text = (cycles_source(text, family, kind) if build == "cycles"
                    else variant_source(text, family, build, kind))
            src = CYCLES_DIR / f"{family}_lattice_{kind}_{build}.cu"
            src.write_text(text)
            out = src.with_suffix(".so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                   f"-I{cuda_build.CSRC}", "-o", str(out), str(src)]
            procs[(build, family)] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (build, family), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {out.stem}:\n{log}")
        lib = ctypes.CDLL(str(out))
        name = f"{family}_lattice_{kind}"
        fn = getattr(lib, name)
        fn.argtypes = list(cuda_build.SIGNATURES[f"{family}_lattice.cu"][name])
        fn.restype = ctypes.c_int
        libs[(build, family)] = lib
    return libs


#: the steps each forward layout's clock reads cover: the warps and block
#: bodies' steps after step 0, the pairs layout's every step (the rows
#: layout reads no clock)
FORWARD_CLOCK_STEPS = {"warp": lambda t: t - 1, "block": lambda t: t - 1,
                       "pairs": lambda t: t}


def cycles(family, label, lib, card, kind="backward", plan=None,
           build="cycles"):
    """The ``cycles`` (or another ``build``'s) kernel of the pass
    at one shape, in ``plan`` (default: the plan's layout): SM cycles a
    step, the SM clock, the device time and max |dev| from the package's
    kernel."""
    if kind == "backward":
        args = make_case(family, SHAPES[family][label], seed=7)
        plan = lc.backward_plan(args[0].shape[2], family == "blank")
        dims = lc.backward_dims(args[0].shape, plan)
        outs = (torch.empty_like(args[0]),)
        want = (new_grad(family)(*args),)
        steps_of = lambda t: t  # noqa: E731
    else:
        args = make_forward_case(family, SHAPES[family][label],
                                 torch.Generator().manual_seed(7))
        plan = plan or lc.forward_plan(args[0].shape[2], family == "blank")
        dims = lc.forward_dims(args[0].shape, plan)
        outs = lc.forward_outputs(args[0])
        want = new_forward(family)(*args)
        steps_of = FORWARD_CLOCK_STEPS.get(plan[0])
    name = f"{family}_lattice_{kind}"
    fn = getattr(lib, name)

    def call():
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        _check(fn(*(t.data_ptr() for t in args),
                  *(t.data_ptr() for t in outs), *dims, stream), name)
        return outs

    call()
    torch.cuda.synchronize()
    cycles_per_step = mhz = None
    if steps_of is not None:
        cycles_per_step, mhz = shard_sweep.read_clock(lib, args[0].shape[0],
                                                      steps_of)
    median, min_max = windows_ms(call, f"{family}_{kind}_kernel")
    row = {"probe": "lattice_ab_cycles", "pass": kind, "build": build,
           "family": family,
           "shape": label, "shape_TBW": list(args[0].shape),
           "plan": list(plan), "cycles_per_step": cycles_per_step,
           "sm_mhz": mhz, "device_ms": median, "device_ms_min_max": min_max,
           "max_abs_dev": max(max_abs_dev(g, w) for g, w in zip(outs, want)),
           "card": card}
    print(json.dumps(row), flush=True)
    return row


def check_log1p(card):
    """Build ``_LOG1P_CHECK`` and compare the kernels' ``log1p_unit`` with
    CUDA's ``log1pf`` at every float in [0, 1] (0x00000000 to 0x3f800000),
    and that a NaN stays NaN: the mismatches and the first mismatching
    bits in [0, 1]."""
    CYCLES_DIR.mkdir(parents=True, exist_ok=True)
    src = CYCLES_DIR / "log1p_check.cu"
    src.write_text(_LOG1P_CHECK)
    out = src.with_suffix(".so")
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC}",
         "-o", str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(out)).log1p_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mismatches = torch.zeros(1, dtype=torch.int64, device="cuda")
    first = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    _check(fn(mismatches.data_ptr(), first.data_ptr()), "log1p_check")
    row = {"probe": "lattice_ab_log1p", "arguments": 0x3F800000 + 1,
           "mismatches": int(mismatches.item()),
           "first_mismatch_bits": (hex(int(first.item()) & 0xFFFFFFFF)
                                   if int(mismatches.item()) else None),
           "card": card}
    print(json.dumps(row), flush=True)
    return row


def steps(family, old, card, kind="backward"):
    """The T=10 train step with the pass's kernel done each way."""
    module = lc if family == "noblank" else bl
    name = f"{family}_{'grad' if kind == 'backward' else 'alpha'}_kernel"
    new = getattr(module, name)
    shape = SHAPES[family]["main_path"]
    run = train_step(family, shape)
    runs = {"before": [], "after": []}
    for side in ("before", "after", "after", "before"):
        setattr(module, name, old if side == "before" else new)
        try:
            runs[side].append(run())
        finally:
            setattr(module, name, new)
    return [{"probe": "lattice_ab_step", "pass": kind, "family": family,
             "side": side, "shape_TBL": list(shape),
             "classes": CLASSES[family],
             "step_ms_runs": [r[0] for r in got],
             "device_ms_per_step_runs": [r[1] for r in got],
             "kernels_per_step_runs": [r[2] for r in got],
             "device_busy_share_runs": [r[3] for r in got],
             "lattice_us_per_step_runs": [r[4] for r in got], "card": card}
            for side, got in runs.items()]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m ctc_tpu_torch.probes.lattice_ab",
        description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, type=Path,
                   help="a tree from before the redesign of the pass's "
                        "kernels")
    p.add_argument("--pass", dest="kind", default="backward",
                   choices=PASSES)
    p.add_argument("--plans", action="store_true",
                   help="also time every layout the launchers take")
    p.add_argument("--cycles", action="store_true",
                   help="also read SM cycles a step from a clock build "
                        "(the forward: at every candidate layout)")
    p.add_argument("--check-log1p", action="store_true",
                   help="forward: compare the kernels' branch-free log1pf "
                        "with CUDA's at every float in [0, 1]")
    p.add_argument("--builds", default="",
                   help="also time these one-place builds at the plan's "
                        f"layout (forward: {', '.join(FORWARD_BUILDS)}; "
                        f"backward: {', '.join(BACKWARD_BUILDS)})")
    args = p.parse_args(argv)
    kind = args.kind
    builds = [b for b in args.builds.split(",") if b]
    allowed = FORWARD_BUILDS if kind == "forward" else BACKWARD_BUILDS
    if set(builds) - set(allowed):
        p.error(f"--builds of the {kind} pass: {', '.join(allowed)}")
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    old = build_parent(args.parent, symbol=f"lattice_{kind}",
                       tag=f"_lattice_ab_{kind}",
                       signatures=OLD_SIGNATURES[kind])
    clock = None
    if args.cycles or builds:
        clock = build_cycles(kind, ["cycles", *builds])
    rows = []
    if args.check_log1p:
        rows.append(check_log1p(card))

    def emit(part):
        for row in part:
            print(json.dumps(row), flush=True)
        rows.extend(part)

    for family in SHAPES:
        if kind == "backward":
            fn = old_grad(family, old[family])
            ab = kernels
        else:
            fn = old_forward(family, old[family])
            ab = forward_kernels
        for label in SHAPES[family]:
            emit(ab(family, label, fn, card))
            if args.plans:
                rows.extend(
                    plans(family, label, card) if kind == "backward" else
                    forward_plans(family, label, SHAPES[family][label], card))
            if args.cycles and kind == "backward":
                rows.append(cycles(family, label, clock[("cycles", family)],
                                   card, kind))
            elif args.cycles:
                width = SHAPES[family][label][2]
                width = width if family == "noblank" else 2 * width + 1
                for plan in candidate_forward_plans(width, family == "blank"):
                    if plan[0] in FORWARD_CLOCK_STEPS:
                        rows.append(cycles(family, label,
                                           clock[("cycles", family)], card,
                                           kind, plan))
            for build in builds:  # in turns with the unchanged source
                for one in ("cycles", build, build, "cycles"):
                    rows.append(cycles(family, label, clock[(one, family)],
                                       card, kind, build=one))
        if args.plans and kind == "forward":
            for label, shape in WIDE_SHAPES[family].items():
                rows.extend(forward_plans(family, label, shape, card))
        emit(steps(family, fn, card, kind))
    return rows


if __name__ == "__main__":
    main()
