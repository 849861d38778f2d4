"""Rows 2 and 6, the whole-lattice backward kernels, before and after their
redesign, side by side on one card.

    python -m ctc_tpu_torch.probes.lattice_ab --parent DIR
    python -m ctc_tpu_torch.probes.lattice_ab --parent DIR --plans --cycles

``DIR`` holds a tree from before the redesign (``git archive <commit> |
tar -x -C DIR``).  Its two lattice sources are compiled with the flags of
``ops/cuda_build.py`` (``shard_ab.build_parent``, both at once) and their
``*_lattice_backward`` launchers called with that tree's arguments (no
plan: one block a sample, the row loop).  "after" is this package's
``noblank_grad_kernel`` / ``blank_grad_kernel`` in the layout
``backward_plan`` picks for the width.

For each family at the smoke's main-path shape and its second shape
(``SHAPES``), it prints one JSON line per side: the kernel's device time
from ``torch.profiler`` (the median of ``shard_ab.WINDOWS`` windows, taken
twice in turns: before, after, after, before; each run's median and the
min and max of its windows), ``step_us`` and, on the "after" line, the
plan and max |dev| of g from the "before" side's.  Then one line per
family and side of the T=10 train step at the main path's shape (the
backward kernel swapped, the rest unchanged; 20 steps after 5 warm-up, in
turns): host ms per step and, from a profiled window of the same steps,
device ms, device kernels and the lattice kernels' device us per step.

``--plans`` also times every layout the launchers take at each shape
(``candidate_plans``, launched through ``grad_in_plan``), each with max
|dev| from the planned layout's g.  ``--cycles`` builds this tree's
sources with block 0's thread 0 reading ``clock64()`` and
``%globaltimer`` around the chunk loop of the warps layout and of the
chunked body (the chunks-warp layout; the clock of ``shard_sweep``'s
``cycles`` build) and prints, at the plan's layout, the SM cycles a step
(the loop's cycles over T: the waits for alpha and the weights included)
and the SM clock.  The first line is the card's name and power limit.
Card only.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
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
from ctc_tpu_torch.probes.shard_ab import (
    CLASSES, WINDOWS, build_parent, train_step, windows_ms,
)
from ctc_tpu_torch.train.trainer import resolve_device

# [T, B, labels]: chip_smoke.py's MAIN_SHAPE and BLANK_MAIN_SHAPE, and its
# second shapes, bench.py's (blank: S = 2 labels + 1 = 11 and 41)
SHAPES = {"noblank": {"main_path": (10, 256, 10), "second": (128, 1024, 157)},
          "blank": {"main_path": (10, 256, 5), "second": (128, 1024, 20)}}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the earlier tree's whole-lattice backward launchers: alpha, [skip_ok,]
#: inlen, tgt, nll_bar, g, T, B, W, stream
OLD_SIGNATURES = {"noblank": (*(_P,) * 5, *(_I,) * 3, _P),
                  "blank": (*(_P,) * 6, *(_I,) * 3, _P)}
CYCLES_DIR = cuda_build.BUILD_DIR / "lattice_ab"
# the clock reads of the ``cycles`` build: shard_sweep's around the chunked
# body's chunk loop (the chunks-warp layout), and around the warps layout's
# chunk loop, up to the end of its function
_WARPS_START = "  for (int c = 0; c < chunk_count; ++c) {\n"
_WARPS_STOP = "}\n\n// The whole-lattice backward's layouts"


def make_case(family, shape, seed):
    """The backward kernel's operands on the card, as ``chip_smoke.py``'s
    ``phase_times*`` make them: alpha from this package's forward kernel
    (blank: over the gather of log-softmaxed random logits of the smoke's
    157 classes), int32 lengths with sample 0 at the full T and labels, and
    a random cotangent.  Returns the arguments of ``*_grad_kernel``."""
    T, B, labels = shape
    gen = torch.Generator().manual_seed(seed)
    if family == "noblank":
        em = torch.randn((T, B, labels), generator=gen) - 1.0
        inlen = torch.randint(1, T + 1, (B,), generator=gen)
        tgt = torch.randint(1, labels + 1, (B,), generator=gen)
        inlen[0], tgt[0] = T, labels
        tgt = torch.minimum(tgt, inlen)
        tgt = tgt.int().to("cuda")
        head = (lc.noblank_alpha_kernel(em.to("cuda"), tgt),)
        tail = (inlen.int().to("cuda"), tgt)
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
        skip = skip.to(torch.uint8).to("cuda")
        head = (bl.blank_alpha_kernel(em.contiguous().to("cuda"), skip), skip)
        tail = (inlen.int().to("cuda"), tgt.int().to("cuda"))
    return (*head, *tail, torch.randn((B,), generator=gen).to("cuda"))


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


def new_grad(family):
    return lc.noblank_grad_kernel if family == "noblank" else (
        bl.blank_grad_kernel)


def kernels(family, label, old, card):
    """The before and after rows of one family at one shape."""
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
        row = {"probe": "lattice_ab", "family": family,
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


def candidate_plans(width, blank):
    """Every layout the launchers take at ``width``: up to 32 cells the
    chunks-warp layout at 32, 128, 256 and 512 threads; up to 1024 the
    warps layout; the rows layout."""
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


def grad_in_plan(family, args, plan, counts):
    """``*_grad_kernel``'s launch with ``args`` in ``plan`` (a layout
    ``backward_plan`` may not pick at the width), counted in ``counts``."""
    name = f"{family}_lattice_backward"
    return lc.launch(f"{family}_lattice.cu", name, counts, args,
                     torch.empty_like(args[0]),
                     lc.backward_dims(args[0].shape, plan))


def plans(family, label, card):
    """Each candidate plan's device time at one shape."""
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
        row = {"probe": "lattice_ab_plans", "family": family,
               "shape": label, "shape_TBW": list(alpha.shape),
               "plan": list(plan), "device_ms": median,
               "device_ms_min_max": min_max,
               "step_us": (median * 1e3 / alpha.shape[0]
                           if median is not None else None),
               "max_abs_dev_from_plan": max_abs_dev(got, want),
               "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def cycles_source(text: str, family: str) -> str:
    """``<family>_lattice.cu``'s ``text`` with the clock read around the
    chunk loops of the chunked body and of the warps layout."""
    text = shard_sweep.variant_source(text, family, "cycles")
    for old, new in ((_WARPS_START, "  sweep_clock_read(0);\n" + _WARPS_START),
                     (_WARPS_STOP, "  sweep_clock_read(1);\n" + _WARPS_STOP)):
        if text.count(old) != 1:
            raise ValueError(f"cycles: {old!r} is not once in {family}'s "
                             "source")
        text = text.replace(old, new)
    return text


def build_cycles():
    """Compile both ``cycles`` sources, one ``nvcc`` each, both at once;
    return each family's library with its backward launcher typed."""
    CYCLES_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for family in SHAPES:
        source = f"{family}_lattice.cu"
        src = CYCLES_DIR / f"{family}_lattice_cycles.cu"
        src.write_text(cycles_source((cuda_build.CSRC / source).read_text(),
                                     family))
        out = src.with_suffix(".so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
               f"-I{cuda_build.CSRC}", "-o", str(out), str(src)]
        procs[family] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for family, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {out.stem}:\n{log}")
        lib = ctypes.CDLL(str(out))
        name = f"{family}_lattice_backward"
        fn = getattr(lib, name)
        fn.argtypes = list(cuda_build.SIGNATURES[f"{family}_lattice.cu"][name])
        fn.restype = ctypes.c_int
        libs[family] = lib
    return libs


def cycles(family, label, lib, card):
    """The ``cycles`` build's backward at the plan's layout at one shape:
    SM cycles a step, the SM clock, the device time and max |dev| from the
    package's kernel."""
    args = make_case(family, SHAPES[family][label], seed=7)
    alpha = args[0]
    plan = lc.backward_plan(alpha.shape[2], family == "blank")
    name = f"{family}_lattice_backward"
    fn = getattr(lib, name)
    g = torch.empty_like(alpha)

    def call():
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        _check(fn(*(t.data_ptr() for t in args), g.data_ptr(),
                  *lc.backward_dims(alpha.shape, plan), stream), name)
        return g

    want = new_grad(family)(*args)
    call()
    torch.cuda.synchronize()
    cycles_per_step, mhz = shard_sweep.read_clock(lib, alpha.shape[0],
                                                  lambda t: t)
    median, min_max = windows_ms(call, f"{family}_backward_kernel")
    row = {"probe": "lattice_ab_cycles", "family": family, "shape": label,
           "shape_TBW": list(alpha.shape), "plan": list(plan),
           "cycles_per_step": cycles_per_step, "sm_mhz": mhz,
           "device_ms": median, "device_ms_min_max": min_max,
           "max_abs_dev": max_abs_dev(g, want), "card": card}
    print(json.dumps(row), flush=True)
    return row


def steps(family, old, card):
    """The T=10 train step with the backward kernel done each way."""
    module = lc if family == "noblank" else bl
    name = f"{family}_grad_kernel"
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
    return [{"probe": "lattice_ab_step", "family": family, "side": side,
             "shape_TBL": list(shape), "classes": CLASSES[family],
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
                   help="a tree from before the redesign")
    p.add_argument("--plans", action="store_true",
                   help="also time every layout the launchers take")
    p.add_argument("--cycles", action="store_true",
                   help="also read SM cycles a step from a clock build")
    args = p.parse_args(argv)
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    old = build_parent(args.parent, symbol="lattice_backward",
                       tag="_lattice_ab", signatures=OLD_SIGNATURES)
    clock = build_cycles() if args.cycles else None
    rows = []
    for family in SHAPES:
        grad = old_grad(family, old[family])
        for label in SHAPES[family]:
            for row in kernels(family, label, grad, card):
                print(json.dumps(row), flush=True)
                rows.append(row)
            if args.plans:
                rows += plans(family, label, card)
            if clock is not None:
                rows.append(cycles(family, label, clock[family], card))
        for row in steps(family, grad, card):
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
