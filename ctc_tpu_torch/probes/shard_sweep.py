"""Time the shard kernels against builds of their own sources that differ
in one or two places each, and at other block sizes (the backward) or ring
depths (the forward), at the seq main path's and the long-T shard shapes
on the card.

    python -m ctc_tpu_torch.probes.shard_sweep                # backward
    python -m ctc_tpu_torch.probes.shard_sweep --pass forward --parent DIR
    python -m ctc_tpu_torch.probes.shard_sweep --builds source,nostore \\
        --threads 128,512

The backward's builds (rows 4 and 8, ``*_shard_backward_kernel``) are
``source`` (the sources as they stand), ``nostore`` (the steps do not
store g to device memory), ``noweights`` (the weight phase computes
nothing; the steps read whatever the weights' shared memory holds),
``nosync`` (no barrier between steps: the steps race), ``stepwarps`` (only
the warps that hold cells run the steps, synchronised by a named barrier
of those warps instead of the whole block's) and ``cycles``; each runs at
each of ``--threads``.  The forward's (rows 3 and 7,
``*_shard_forward_kernel``) are ``source``, ``nostore`` (the steps do not
store alpha to device memory) and ``cycles``; each runs at the plan's
block (its warps layout takes no other) and at each of ``--depths`` (the
em ring's rows, 8 and 2).  ``cycles`` is the source with block 0's thread
0 reading ``clock64()`` and ``%globaltimer`` before and after the steps
(the forward's steps 1 .. T-1, the backward's chunk loop): it prints the
SM cycles a step and the SM clock in MHz.  With ``--parent DIR`` (a tree
from before the forward's redesign), the forward pass also runs
``parent_cycles``: that tree's shard forward (the whole-lattice loop,
alpha only) with the same clock reads around its step loop, at the block
its launcher picks.

Each build's two sources are compiled with the flags of
``ops/cuda_build.py`` into ``build/ctc_tpu_torch/shard_sweep/``, all at
once; the ptxas lines of each build's shard kernels are printed.  Every
build runs on the operands of ``shard_ab``.

Prints the card's name and power limit, then one JSON line per build,
family, shape, depth and block size: the kernel's device time from
``torch.profiler`` (median, min and max of ``shard_ab.WINDOWS`` windows),
``step_us``, max |dev| from the package's own kernel (null for the builds
that compute another function), and for ``cycles`` the cycles a step and
the clock.  Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops.lattice_cuda import _check
from ctc_tpu_torch.probes import max_abs_dev
from ctc_tpu_torch.probes.ring_sweep import card_line
from ctc_tpu_torch.probes.shard_ab import (
    SHAPES, build_parent, make_case, windows_ms,
)
from ctc_tpu_torch.train.trainer import resolve_device

SWEEP_DIR = cuda_build.BUILD_DIR / "shard_sweep"
DEFAULT_BUILDS = ("source", "nostore", "noweights", "nosync", "stepwarps",
                  "cycles")
FORWARD_BUILDS = ("source", "nostore", "cycles")
DEFAULT_THREADS = (128, 256, 512)
FAMILIES = {"noblank": dict(weights=2), "blank": dict(weights=3, mask_bytes=1)}
# builds that compute another function than the package's kernel
OTHER_FUNCTION = ("nostore", "noweights", "nosync")
_STEP_LOOP = ("    stage(c + 2);  // into the buffer chunk c leaves\n"
              "    for (int k = n - 1; k >= 0; --k) {")
_STEP_SYNC = "      __syncthreads();\n    }\n  }\n  // g[0]"

# the clock reads of a ``cycles`` build: block 0's thread 0 records
# clock64() and %globaltimer at the start and the stop of the steps, and
# sweep_read_clock copies the four values to the host
_CLOCK_DEFS = '''#include "cp_async.cuh"

__device__ unsigned long long sweep_clock[4];

__device__ __forceinline__ void sweep_clock_read(int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    sweep_clock[2 * k] = clock64();
    sweep_clock[2 * k + 1] = ns;
  }
}
'''
_CLOCK_READ = '''
extern "C" cudaError_t sweep_read_clock(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, sweep_clock, sizeof(sweep_clock));
}
'''


def _clock_edits(start, stop):
    """The edits of a ``cycles`` build: the clock's definitions, and a
    read before each of the texts ``start`` and ``stop``."""
    return [('#include "cp_async.cuh"\n', _CLOCK_DEFS),
            (start, "  sweep_clock_read(0);\n" + start),
            (stop, "  sweep_clock_read(1);\n" + stop)]


# the forward's steps 1 .. T-1 (its loop and the peeled last step), in
# the block layout and in the warps layout
_FWD_BLOCK_START = "  stage();  // step kDepth-1, into slot kDepth-1\n"
_FWD_BLOCK_STOP = "  }\n  if (tid == 0) "
_FWD_WARPS_START = "  for (int t = 1; t < T - 1; ++t) {\n    stage();\n"
_FWD_WARPS_STOP = "\n  __syncthreads();  // publishes fin\n"
_BWD_START = "  for (int c = 0; c < n_chunks; ++c) {\n"
_BWD_STOP = "  // g[0], the row the last step wrote"
# the parent's shard forward: the whole-lattice loop under kShard, up to
# the end of its kernel
_OLD_FWD_START = "  for (int t = 0; t < T; ++t) {\n"
_OLD_FWD_STOP = "}\n\n// Reverse "

# pass -> build -> family -> [(text, replacement), ...], each text once in
# the source
_EDITS = {
    "backward": {
        "nostore": {
            "noblank": [("        g_t[l] = v;\n        g_cur[l] = v;",
                         "        g_cur[l] = v;")],
            "blank": [("        g_t[s] = v;\n        g_cur[s] = v;",
                       "        g_cur[s] = v;")],
        },
        "noweights": {
            "noblank": [("        w_k[l] = w * in_l;\n"
                         "        w_k[L + l] = (1.0f - w) * in_l;\n", "")],
            "blank": [("        branch_weights(a + k * S, a + k * S, "
                       "skip_sh, s, S,\n"
                       "                       weights + 3 * k * S);\n", "")],
        },
        "nosync": {family: [(_STEP_SYNC, "    }\n  }\n  // g[0]")]
                   for family in ("noblank", "blank")},
        "stepwarps": {
            family: [
                (_STEP_LOOP,
                 "    stage(c + 2);  // into the buffer chunk c leaves\n"
                 f"    const int step_threads = min(nt, ({width} + 31) / 32"
                 " * 32);\n"
                 "    if (tid < step_threads)\n"
                 "    for (int k = n - 1; k >= 0; --k) {"),
                (_STEP_SYNC,
                 '      asm volatile("bar.sync 1, %0;" ::"r"(step_threads) '
                 ': "memory");\n    }\n  }\n  __syncthreads();\n  // g[0]'),
            ]
            for family, width in (("noblank", "L"), ("blank", "S"))
        },
        "cycles": {family: _clock_edits(_BWD_START, _BWD_STOP)
                   for family in ("noblank", "blank")},
    },
    "forward": {
        "nostore": {
            family: [(f"      alpha_t[{x}] = a;\n      nxt[{x}] = a;\n"
                      "      if (t == t_fin",
                      f"      nxt[{x}] = a;\n      if (t == t_fin"),
                     ("        *out = a;\n", "")]
            for family, x in (("noblank", "l"), ("blank", "s"))
        },
        "cycles": {
            family: [
                ('#include "cp_async.cuh"\n', _CLOCK_DEFS),
                (_FWD_WARPS_START,
                 "  sweep_clock_read(0);\n" + _FWD_WARPS_START),
                (_FWD_WARPS_STOP,
                 "\n  sweep_clock_read(1);" + _FWD_WARPS_STOP),
                (_FWD_BLOCK_START,
                 _FWD_BLOCK_START + "  sweep_clock_read(0);\n"),
                (_FWD_BLOCK_STOP, _FWD_BLOCK_STOP.replace(
                    "  if", "  sweep_clock_read(1);\n  if")),
            ]
            for family in ("noblank", "blank")
        },
    },
}
# the steps each clock interval covers, by pass (and the parent's forward)
_CLOCK_STEPS = {"forward": lambda t: t - 1, "backward": lambda t: t,
                "parent": lambda t: t}


def variant_source(text: str, family: str, build: str,
                   kind: str = "backward") -> str:
    """``<family>_lattice.cu``'s ``text`` with the edits of ``kind``'s
    (``backward`` or ``forward``) ``build``."""
    if build == "source":
        return text
    edits = _EDITS[kind]
    if build not in edits:
        raise ValueError(f"unknown build {build!r} of the {kind} pass: "
                         f"source, {', '.join(edits)}")
    for old, new in edits[build][family]:
        if text.count(old) != 1:
            raise ValueError(f"{build}: {old!r} is not once in {family}'s "
                             "source")
        text = text.replace(old, new)
    return text + (_CLOCK_READ if build == "cycles" else "")


def parent_cycles_source(text: str, family: str) -> str:
    """The earlier tree's source with the clock read around its forward
    step loop (the whole-lattice loop its shard forward runs)."""
    del family
    for old, new in _clock_edits(_OLD_FWD_START, _OLD_FWD_STOP):
        if text.count(old) != 1:
            raise ValueError(f"parent_cycles: {old!r} is not once in the "
                             "parent's source")
        text = text.replace(old, new)
    return text + _CLOCK_READ


def build_all(builds, kind):
    """Compile every build's two sources, one ``nvcc`` each, all started
    together; return ``{(build, family): library}`` (its launcher typed)
    and each build's ptxas lines of the shard kernels."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for build in builds:
        for family in FAMILIES:
            source = f"{family}_lattice.cu"
            src = SWEEP_DIR / f"{family}_lattice_{kind}_{build}.cu"
            src.write_text(variant_source(
                (cuda_build.CSRC / source).read_text(), family, build, kind))
            out = src.with_suffix(".so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                   f"-I{cuda_build.CSRC}", "-o", str(out), str(src)]
            procs[(build, family)] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, ptxas = {}, {}
    for (build, family), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {out.stem}:\n{log}")
        # ptxas names the kernel on one line and its stack, spills and
        # registers on the next three
        lines = log.splitlines()
        ptxas[(build, family)] = [
            " ".join(lines[i:i + 4]) for i, line in enumerate(lines)
            if f"shard_{kind}_kernel" in line and "Compiling" in line]
        lib = ctypes.CDLL(str(out))
        name = f"{family}_shard_{kind}"
        fn = getattr(lib, name)
        fn.argtypes = list(cuda_build.SIGNATURES[f"{family}_lattice.cu"][name])
        fn.restype = ctypes.c_int
        libs[(build, family)] = lib
    return libs, ptxas


def read_clock(lib, t_s, steps_of):
    """``(cycles a step, SM MHz)`` of the last launch of a ``cycles``
    build."""
    vals = (ctypes.c_ulonglong * 4)()
    _check(lib.sweep_read_clock(ctypes.cast(vals, ctypes.c_void_p)),
           "sweep_read_clock")
    cycles, ns = vals[2] - vals[0], vals[3] - vals[1]
    return (cycles / max(steps_of(t_s), 1),
            cycles / ns * 1e3 if ns else None)


def backward_runner(lib, family, case, threads):
    """A call of the build's shard backward on the operands ``case`` (the
    forward kernel's alpha first) at ``threads``; it returns ``(g, d row
    0, d row 1)``."""
    alpha, rows = case[0], case[-2:]
    fn = getattr(lib, f"{family}_shard_backward")
    chunk, _, smem = lc.shard_backward_plan(alpha.shape[2],
                                            **FAMILIES[family])
    outs = (torch.empty_like(alpha), torch.empty_like(rows[0]),
            torch.empty_like(rows[1]))
    stream = torch.cuda.current_stream(alpha.device).cuda_stream

    def call():
        _check(fn(*(t.data_ptr() for t in case),
                  *(t.data_ptr() for t in outs), *alpha.shape, chunk,
                  threads, smem, stream), f"{family}_shard_backward")
        return outs

    return call


def forward_runner(lib, family, case, threads, depth):
    """A call of the build's shard forward on the operands ``case`` at
    ``threads`` and ring ``depth``; it returns ``(alpha, final,
    boundary)``."""
    em = case[0]
    t_s, batch, width = em.shape
    fn = getattr(lib, f"{family}_shard_forward")
    smem = lc.shard_forward_bytes(width, depth, threads, family == "blank")
    outs = (torch.empty((t_s, batch, width), device=em.device),
            torch.empty((batch,), device=em.device),
            torch.empty((batch, width), device=em.device))
    stream = torch.cuda.current_stream(em.device).cuda_stream

    def call():
        _check(fn(*(t.data_ptr() for t in case),
                  *(t.data_ptr() for t in outs), t_s, batch, width,
                  em.stride(0), depth, threads, smem, stream),
               f"{family}_shard_forward")
        return outs

    return call


def parent_runner(lib, family, case):
    """A call of the earlier tree's shard forward (alpha only, from a
    contiguous em) on the operands ``case``."""
    fn = getattr(lib, f"{family}_shard_forward")
    em = case[0].contiguous()
    ops = ((em, case[2], *case[-2:]) if family == "noblank"
           else (em, case[1], *case[-2:]))
    alpha = torch.empty_like(em)
    stream = torch.cuda.current_stream(em.device).cuda_stream

    def call():
        _check(fn(*(t.data_ptr() for t in ops), alpha.data_ptr(), *em.shape,
                  stream), f"{family}_shard_forward")
        return (alpha,)

    return call


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m ctc_tpu_torch.probes.shard_sweep",
        description=__doc__.splitlines()[0])
    p.add_argument("--pass", dest="kind", default="backward",
                   choices=("backward", "forward"))
    p.add_argument("--builds", default=None,
                   help="default: every build of the pass")
    p.add_argument("--threads", default=",".join(map(str, DEFAULT_THREADS)),
                   help="the backward's block sizes (the forward takes its "
                        "plan's)")
    p.add_argument("--depths", default="8,2",
                   help="the forward's em ring depths")
    p.add_argument("--parent", type=Path, default=None,
                   help="forward: also time this tree's shard forward")
    args = p.parse_args(argv)
    kind = args.kind
    builds = (args.builds.split(",") if args.builds else
              list(FORWARD_BUILDS if kind == "forward" else DEFAULT_BUILDS))
    threads = [int(x) for x in args.threads.split(",")]
    depths = [int(x) for x in args.depths.split(",")]
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    libs, ptxas = build_all(builds, kind)
    parent = None
    if args.parent is not None and kind == "forward":
        parent = build_parent(args.parent, edit=parent_cycles_source,
                              tag="_cycles")
    for key, lines in ptxas.items():
        print(json.dumps({"probe": "shard_sweep", "pass": kind,
                          "build": key[0], "family": key[1],
                          "ptxas": lines}), flush=True)
    rows = []

    def emit(row, call, symbol, lib=None, steps_of=None, want=None):
        got = call()
        torch.cuda.synchronize()
        if lib is not None:
            row["cycles_per_step"], row["sm_mhz"] = read_clock(
                lib, row["shard_shape_TBW"][0], steps_of)
        median, min_max = windows_ms(call, symbol)
        t_s = row["shard_shape_TBW"][0]
        row.update({
            "device_ms": median, "device_ms_min_max": min_max,
            "step_us": median * 1e3 / t_s if median is not None else None,
            "max_abs_dev": (None if want is None else
                            max(max_abs_dev(a, b) for a, b in zip(got, want))),
            "card": card})
        rows.append(row)
        print(json.dumps(row), flush=True)

    for family in FAMILIES:
        for label, shape in SHAPES[family].items():
            fwd_case, bwd_tail = make_case(family, shape, "cuda",
                                           seed=sum(shape))
            module = lc if family == "noblank" else bl
            fwd = getattr(module, f"{family}_shard_forward_kernel")(*fwd_case)
            head = dict(probe="shard_sweep", family=family, shape=label,
                        shard_shape_TBW=list(fwd_case[0].shape))
            if kind == "backward":
                case = (fwd[0], *bwd_tail)
                want = getattr(module, f"{family}_shard_grad_kernel")(*case)
                symbol = f"{family}_shard_backward_kernel"
            else:
                case, want = fwd_case, fwd
                symbol = f"{family}_shard_forward_kernel"
            if kind == "backward":
                runs = [(n, None) for n in threads]
            else:
                plan = lc.shard_forward_plan(fwd_case[0].shape[2],
                                             family == "blank")
                runs = [(plan[1], depth) for depth in depths]
            for build in builds:
                lib = libs[(build, family)]
                keep = None if build in OTHER_FUNCTION else want
                for n, depth in runs:
                    call = (backward_runner(lib, family, case, n)
                            if kind == "backward" else
                            forward_runner(lib, family, case, n, depth))
                    emit({**head, "pass": kind, "build": build, "threads": n,
                          "depth": depth}, call, symbol,
                         lib if build == "cycles" else None,
                         _CLOCK_STEPS[kind], keep)
            if parent is not None:
                emit({**head, "pass": "forward", "build": "parent_cycles",
                      "threads": None, "depth": None},
                     parent_runner(parent[family], family, fwd_case),
                     f"{family}_forward_kernel", parent[family],
                     _CLOCK_STEPS["parent"], (fwd[0],))
    return rows


if __name__ == "__main__":
    main()
