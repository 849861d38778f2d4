"""Rows 10a–10c, the exp-domain probe kernels, before and after their
redesign, side by side on one card.

    python -m ctc_tpu_torch.probes.expdomain_ab --parent DIR
    python -m ctc_tpu_torch.probes.expdomain_ab --parent DIR --layouts \
        --sweep --cycles

``DIR`` holds a tree from before the redesign (``git archive <commit> |
tar -x -C DIR``).  Its ``ctc_tpu_torch/csrc/fwd_probes.cu`` is compiled
with the flags of ``ops/cuda_build.py`` into ``build/ctc_tpu_torch/parent/``
(``shard_ab.compile_parent``) and its ``probe_fwd_log``, ``probe_fwd_exp``
and ``probe_fwd_exp_renorm`` launchers called with that tree's arguments
(``OLD_SIGNATURES``: no ring, em read inside the step).  "after" is this
package's kernel in the layout ``ops/probe_cuda.py::expdomain_plan`` picks.

For each variant at the probes' bench shape, the edge shape, the ring-edge
shape and one past the ring (``SHAPES``; off the bench shape three samples
are outside everywhere, as in ``chip_smoke.py``; exp_renorm at chunk
``CHUNK``) it prints one JSON line per side: the kernel's device time from
``torch.profiler`` (the median of ``shard_ab.WINDOWS`` windows, taken twice
in turns: before, after, after, before; each run's median and the min and
max of its windows) and ``step_us``; the "after" line adds the plan (ring
depth, shared bytes and how em is staged: tensor copies, 4-byte copies or
read inside the step), the ratio of the two sides' mean medians and max
|dev| from the "before" side's output.
The first line is the card's name and power limit.  Card only.

``--layouts`` also times, at the bench and edge shapes, every way the
launcher stages em, in turns with the parent's kernel: em read in the
step (depth 0), the 8- and 2-slot rings filled by 4-byte copies (em moved
to a 4-byte offset, so ``tensor_copies`` does not hold) and the 8-slot
ring filled by tensor copies.  ``--sweep`` times the log and exp variants
read in the step against their 8-slot ring (tensor copies) at T=64 over
``SWEEP_B`` x ``SWEEP_L``, the reading behind ``LOG_IN_STEP_BELOW``.
``--cycles`` builds the source with clock reads (``cycles_source``) and
prints, at the bench and edge shapes, the SM cycles a step of row thread
(0, 0) of block 0 (the wait for em, the rows, the 4-byte copies' issue,
the barrier) and of the tensor copies' issuing lane, for both rings.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import probe_cuda as pc
from ctc_tpu_torch.ops.lattice_cuda import _check
from ctc_tpu_torch.probes import BENCH_SHAPE, max_abs_dev
from ctc_tpu_torch.probes.expdomain_fwd import make_inputs
from ctc_tpu_torch.probes.ring_sweep import card_line
from ctc_tpu_torch.probes.shard_ab import (
    PARENT_BUILD, WINDOWS, compile_parent, type_launcher, windows_ms,
)
from ctc_tpu_torch.train.trainer import resolve_device

VARIANTS = ("fwd_log", "fwd_exp", "fwd_exp_renorm")
#: T, B, L: the bench shape; the edge shape (T not a multiple of the chunk,
#: L_PAD 24, B not a multiple of 8); the ring edge (L_PAD 1504, a two-slot
#: ring); past the ring (L_PAD 2000, em read inside the step)
SHAPES = {"bench": BENCH_SHAPE, "edge": (37, 100, 21),
          "ring_edge": (3, 21, 1500), "past_ring": (3, 21, 2000)}
CHUNK = 16  # exp_renorm's chunk, as the probe entry point's default
SWEEP_B = (100, 256, 1024)
SWEEP_L = (21, 40, 64, 157)
SYMBOL = "expdomain_kernel"  # both trees' kernel, in the profiler's names
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the earlier tree's launchers: em, outside, out, T, L_pad, B,
#: [chunk,] stream
OLD_SIGNATURES = {"probe_fwd_log": (_P, _P, _P, _I, _I, _I, _P),
                  "probe_fwd_exp": (_P, _P, _P, _I, _I, _I, _P),
                  "probe_fwd_exp_renorm": (_P, _P, _P, _I, _I, _I, _I, _P)}


def build_old(parent: Path) -> ctypes.CDLL:
    """The parent's ``fwd_probes.cu``, its row-10 launchers typed."""
    lib = compile_parent(parent, {"fwd_probes": "fwd_probes.cu"},
                         tag="_expdomain_ab")["fwd_probes"]
    for name, argtypes in OLD_SIGNATURES.items():
        type_launcher(lib, name, argtypes)
    return lib


def old_call(lib, variant, em, outside, chunk=CHUNK):
    """A call of the earlier tree's ``variant`` kernel on em and outside
    into a new output."""
    name = f"probe_{variant}"
    fn = getattr(lib, name)
    dims = (*em.shape, *((chunk,) if variant == "fwd_exp_renorm" else ()))

    def call():
        out = torch.empty_like(em)
        stream = torch.cuda.current_stream(em.device).cuda_stream
        _check(fn(em.data_ptr(), outside.data_ptr(), out.data_ptr(), *dims,
                  stream), name)
        return out

    return call


def new_call(variant, em, outside, chunk=CHUNK):
    """A call of this package's ``variant`` kernel."""
    kernel = getattr(pc, f"probe_{variant}_kernel")
    if variant == "fwd_exp_renorm":
        return lambda: kernel(em, outside, chunk)
    return lambda: kernel(em, outside)


def off_by_4(em):
    """em at a 4-byte offset from a 16-byte boundary (the same values)."""
    flat = torch.empty(em.numel() + 4, device=em.device)
    start = (-flat.data_ptr() // 4) % 4 + 1
    return flat[start:start + em.numel()].view(em.shape).copy_(em)


def in_plan(variant, em, outside, plan, chunk=CHUNK):
    """A call of this package's ``variant`` kernel in ``plan`` (depth,
    shared bytes)."""
    name = f"probe_{variant}"
    args = (chunk,) if variant == "fwd_exp_renorm" else ()
    return lambda: pc._expdomain_kernel(name, em, outside, *args, plan=plan)


def ring_bytes(variant, l_pad, depth):
    extra = pc.PARTIAL_BYTES if variant == "fwd_exp_renorm" else 0
    return (depth + 2) * l_pad * 8 * 4 + extra


def layout(em, depth) -> str:
    """How the kernel at ``depth`` stages em (ops/probe_cuda.py)."""
    if depth == 0:
        return "em read in the step"
    how = "tensor copies" if pc.tensor_copies(em, depth) else "4-byte copies"
    return f"em ring of {depth}, {how}"


def make_case(label, device):
    """The probe entry point's inputs at ``SHAPES[label]``."""
    em, outside = make_inputs(*SHAPES[label], device)
    if SHAPES[label] != BENCH_SHAPE:
        outside[:, :3] = 1.0
    return em, outside


def compare(variant, label, lib, card):
    """The before and after rows of one variant at one shape."""
    em, outside = make_case(label, "cuda")
    sides = {"before": old_call(lib, variant, em, outside),
             "after": new_call(variant, em, outside)}
    runs = {side: [] for side in sides}
    for side in ("before", "after", "after", "before"):
        sides[side]()
        runs[side].append(windows_ms(sides[side], SYMBOL))
    want, got = sides["before"](), sides["after"]()
    torch.cuda.synchronize()
    steps = em.shape[0]
    l_pad = em.shape[1]
    depth, smem = pc.expdomain_plan(l_pad, variant[len("fwd_"):])
    rows = []
    for side in sides:
        medians = [m for m, _ in runs[side]]
        row = {"probe": "expdomain_ab", "variant": variant,
               "kernel": f"probe_{variant}", "side": side, "shape": label,
               "shape_TBL": list(SHAPES[label]), "l_pad": l_pad,
               "chunk": CHUNK if variant == "fwd_exp_renorm" else None,
               "device_ms_runs": medians,
               "device_ms_min_max_runs": [mm for _, mm in runs[side]],
               "step_us_runs": [m * 1e3 / steps if m is not None else None
                                for m in medians],
               "windows": WINDOWS, "card": card}
        if side == "after":
            before = [m for m, _ in runs["before"]]
            row.update(
                plan={"ring_depth": depth, "shared_bytes": smem,
                      "layout": layout(em, depth)},
                ratio=(sum(medians) / sum(before)
                       if None not in medians + before else None),
                max_abs_dev_from_before=max_abs_dev(got, want))
        rows.append(row)
    return rows


def in_turns(sides):
    """Each side's median device ms over ``WINDOWS`` windows, twice, in
    turns (the sides in order, then reversed)."""
    runs = {side: [] for side in sides}
    for side in [*sides, *reversed(sides)]:
        sides[side]()
        runs[side].append(windows_ms(sides[side], SYMBOL)[0])
    return runs


def layouts(lib, card):
    """Every staging of em at the bench and edge shapes, in turns."""
    rows = []
    for label in ("bench", "edge"):
        em, outside = make_case(label, "cuda")
        shifted = off_by_4(em)
        l_pad = em.shape[1]
        for variant in VARIANTS:
            sides = {"before": old_call(lib, variant, em, outside)}
            for name, x, depth in (("em read in the step", em, 0),
                                   ("em ring of 2, 4-byte copies", shifted,
                                    2),
                                   ("em ring of 8, 4-byte copies", shifted,
                                    8),
                                   ("em ring of 8, tensor copies", em, 8)):
                sides[name] = in_plan(variant, x, outside,
                                      (depth, ring_bytes(variant, l_pad,
                                                         depth)))
            runs = in_turns(sides)
            want = sides["before"]()
            devs = {name: max_abs_dev(fn(), want)
                    for name, fn in sides.items()}
            rows.append({"probe": "expdomain_ab_layouts", "variant": variant,
                         "shape": label, "shape_TBL": list(SHAPES[label]),
                         "device_ms_runs": runs,
                         "max_abs_dev_from_before": devs, "card": card})
    return rows


def sweep(lib, card):
    """log and exp read in the step against their 8-slot ring, T=64."""
    rows = []
    for L in SWEEP_L:
        for B in SWEEP_B:
            em, outside = make_inputs(64, B, L, "cuda")
            l_pad = em.shape[1]
            for variant in ("fwd_log", "fwd_exp"):
                runs = in_turns({
                    "before": old_call(lib, variant, em, outside),
                    "em read in the step": in_plan(
                        variant, em, outside,
                        (0, ring_bytes(variant, l_pad, 0))),
                    "em ring of 8, tensor copies": in_plan(
                        variant, em, outside,
                        (8, ring_bytes(variant, l_pad, 8)))})
                rows.append({"probe": "expdomain_ab_sweep",
                             "variant": variant, "shape_TBL": [64, B, L],
                             "l_pad": l_pad, "device_ms_runs": runs,
                             "card": card})
    return rows


#: the clock reads of a ``--cycles`` build: (the source line, what goes
#: before it, what goes after it)
_CLOCKS = (
    ("namespace {\n", "", "\n__device__ long long g_cycles[8];\n"),
    ("  const int warps = row_threads / 4;  // each 8 samples x 4 row "
     "threads\n", "", "  long long cyc[4] = {0, 0, 0, 0};\n"),
    ("      if (leader) tiles.issue(t + kDepth - 1);\n",
     "      const long long i0 = clock64();\n",
     "      const long long i1 = clock64();\n"),
    ("      __syncthreads();\n    }\n    return;\n",
     "      __syncthreads();\n      cyc[2] += i1 - i0;\n"
     "      cyc[3] += clock64() - i1;\n    }\n"
     "    if (blockIdx.x == 0 && leader) {\n"
     "      for (int i = 0; i < 4; ++i) g_cycles[4 + i] = cyc[i];\n    }\n"
     "    return;\n", None),
    ("    const float* e_t = ring;  // step t's tile, landed for this "
     "thread\n", "    const long long s0 = clock64();\n", ""),
    ("    if constexpr (kStaged) e_t += (t & (kDepth - 1)) * cells;\n", "",
     "    const long long s1 = clock64();\n"),
    ("    // step t + kDepth into the slot this thread's rows just read\n",
     "    const long long s2 = clock64();\n", ""),
    ("    if constexpr (kStaged && !kTma) copies.stage();\n", "",
     "    const long long s3 = clock64();\n"),
    ("    __syncthreads();\n  }\n}\n\ncudaError_t prepare",
     "    __syncthreads();\n    cyc[0] += s1 - s0;\n    cyc[1] += s2 - s1;\n"
     "    cyc[2] += s3 - s2;\n    cyc[3] += clock64() - s3;\n  }\n"
     "  if (blockIdx.x == 0 && tx == 0 && ty == 0) {\n"
     "    for (int i = 0; i < 4; ++i) g_cycles[i] = cyc[i];\n  }\n}\n\n"
     "cudaError_t prepare", None),
)
_READ_CYCLES = (
    '\nextern "C" int read_cycles(long long* out) {\n'
    "  return cudaMemcpyFromSymbol(out, g_cycles, 8 * sizeof(long long));\n"
    "}\n")


def cycles_source(text: str) -> str:
    """``fwd_probes.cu`` with clock reads in ``expdomain_kernel``'s step,
    summed over the steps: row thread (0, 0) of block 0 (the wait for em,
    the rows, the 4-byte copies' issue, the barrier) into ``g_cycles[0:4]``,
    the tensor copies' issuing lane (-, -, the issue, the barrier) into
    ``g_cycles[4:8]``; ``read_cycles`` copies them out."""
    for line, before, after in _CLOCKS:
        if text.count(line) != 1:
            raise ValueError(f"{line!r} is not one line of the source")
        text = text.replace(line, before + line + after if after is not None
                            else before)
    return text + _READ_CYCLES


def build_cycles() -> ctypes.CDLL:
    src = PARENT_BUILD / "fwd_probes_cycles.cu"
    PARENT_BUILD.mkdir(parents=True, exist_ok=True)
    src.write_text(cycles_source((cuda_build.CSRC / "fwd_probes.cu")
                                 .read_text()))
    out = src.with_suffix(".so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           f"-I{cuda_build.CSRC}", "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in cuda_build.SIGNATURES["fwd_probes.cu"].items():
        type_launcher(lib, name, argtypes)
    type_launcher(lib, "read_cycles", (ctypes.c_void_p,))
    return lib


def cycles(card):
    """SM cycles a step of both rings at the bench and edge shapes."""
    lib = build_cycles()
    rows = []
    for label in ("bench", "edge"):
        em, outside = make_case(label, "cuda")
        steps, l_pad, batch = em.shape
        for variant in ("fwd_log", "fwd_exp"):
            for name, x in (("em ring of 8, tensor copies", em),
                            ("em ring of 8, 4-byte copies", off_by_4(em))):
                out = torch.empty_like(x)
                fn = getattr(lib, f"probe_{variant}")
                for _ in range(3):
                    _check(fn(x.data_ptr(), outside.data_ptr(),
                              out.data_ptr(), steps, l_pad, batch, 8,
                              ring_bytes(variant, l_pad, 8),
                              torch.cuda.current_stream().cuda_stream),
                           variant)
                torch.cuda.synchronize()
                got = (ctypes.c_longlong * 8)()
                _check(lib.read_cycles(ctypes.addressof(got)), "read_cycles")
                per = [c / steps for c in got]
                rows.append({
                    "probe": "expdomain_ab_cycles", "variant": variant,
                    "shape": label, "shape_TBL": list(SHAPES[label]),
                    "layout": name,
                    "row_thread_cycles_per_step": dict(zip(
                        ("wait", "rows", "copies", "barrier"), per[:4])),
                    "issuer_cycles_per_step": ({"issue": per[6],
                                                "barrier": per[7]}
                                               if pc.tensor_copies(x, 8)
                                               else None),
                    "card": card})
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m ctc_tpu_torch.probes.expdomain_ab",
        description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, type=Path,
                   help="a tree from before the redesign")
    p.add_argument("--layouts", action="store_true",
                   help="also time every staging of em")
    p.add_argument("--sweep", action="store_true",
                   help="also time log and exp in the step against the ring")
    p.add_argument("--cycles", action="store_true",
                   help="also read SM cycles a step from a clock build")
    args = p.parse_args(argv)
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    lib = build_old(args.parent)
    rows = []
    parts = [(compare, variant, label, lib, card)
             for label in SHAPES for variant in VARIANTS]
    if args.layouts:
        parts.append((layouts, lib, card))
    if args.sweep:
        parts.append((sweep, lib, card))
    if args.cycles:
        parts.append((cycles, card))
    for fn, *fn_args in parts:
        for row in fn(*fn_args):
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
