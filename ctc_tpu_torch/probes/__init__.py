"""Probes of the blank-free forward recursion (ports of the JAX package's
``probe_fwd_ops.py`` and ``probe_expdomain_fwd.py``).

Each module is an entry point, run as ``python -m
ctc_tpu_torch.probes.fwd_ops`` or ``python -m
ctc_tpu_torch.probes.expdomain_fwd``; it times the kernels of
``ops/probe_cuda.py`` at the bench shape on the card (``--device cpu`` runs
the plain versions instead).  This module holds what the two share: the
command line and the timer.  Nothing runs at import.
"""

from __future__ import annotations

import argparse
import time

import torch

BENCH_SHAPE = (128, 1024, 157)  # T, B, L of bench.py's no-blank lattice


def parse_args(prog: str, description: str, argv=None):
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--shape", default=",".join(map(str, BENCH_SHAPE)),
                   help="T,B,L (default: the bench shape)")
    p.add_argument("--chunk", type=int, default=16,
                   help="steps between the carry writes / renorms")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    try:
        args.shape = tuple(int(x) for x in args.shape.split(","))
    except ValueError:
        p.error(f"--shape takes T,B,L, got {args.shape!r}")
    if len(args.shape) != 3 or min(args.shape) < 1:
        p.error(f"--shape takes three positive sizes, got {args.shape}")
    if args.chunk < 1 or args.iters < 1:
        p.error("--chunk and --iters must be at least 1")
    return args


def seconds_per_call(fn, bufs, iters: int, device: torch.device):
    """``(mean seconds, first output)``: ``fn(bufs[i % len(bufs)])`` timed
    over ``iters`` calls after one warm-up call on ``bufs[0]``, whose output
    is returned; CUDA events on the card, the host clock on the CPU."""
    first = fn(bufs[0])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(bufs[i % len(bufs)])
        return (time.perf_counter() - t0) / iters, first
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for i in range(iters):
        fn(bufs[i % len(bufs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters, first


def max_abs_dev(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
