"""Time row 9's em-ring skeleton (``fwd_ops_kernel`` of
``csrc/fwd_probes.cu``) against builds of its own source that differ in
one line each, at the bench shape on the card.

    python -m ctc_tpu_torch.probes.ring_sweep
    python -m ctc_tpu_torch.probes.ring_sweep --builds rows64,rows128

A build ``rows<N>`` sets ``kRingRows``, the threads across label rows of
one 8-sample column (the source's own is 64); ``noload`` drops the
``cp.async`` copies of em, so the ring is read as it stands; ``nostore``
drops the stores of the output; ``depth2`` is the source as it stands,
launched through a two-slot em ring.  Each distinct source is compiled
with the flags of ``ops/cuda_build.py`` into
``build/ctc_tpu_torch/sweep/``, all at once.  Each build's copy, add and
lse kernels and its carry-only kernel (chunk 16) run through the ring
:func:`~ctc_tpu_torch.ops.probe_cuda.ring_plan` picks (``depth2``: two
slots), twice over in turns (builds in order, then reversed).

Prints the card's name and power limit, then one JSON line per build and
kernel: the CUDA-event time of back-to-back launches, the kernel's device
time from ``torch.profiler`` and its max |dev| from the plain version
(null for ``noload`` and ``nostore``, which compute another function);
then one line of yardsticks, by CUDA events: ``F.pad`` of em to L_PAD
rows, and a strided ``copy_`` of em into rows ``0..L-1`` of an output
zeroed once (the data movement alone, without the pad rows' writes).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch
import torch.nn.functional as F

from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import probe_cuda as pc
from ctc_tpu_torch.ops.lattice_cuda import _check
from ctc_tpu_torch.probes import BENCH_SHAPE, seconds_per_call
from ctc_tpu_torch.probes.fwd_ops import make_inputs
from ctc_tpu_torch.train.trainer import resolve_device

SWEEP_DIR = cuda_build.BUILD_DIR / "sweep"
DEFAULT_BUILDS = ("rows32", "rows64", "rows80", "rows128", "depth2",
                  "noload", "nostore")
KINDS = ("copy", "add", "lse", "noout")
CHUNK = 16
_ROWS_LINE = "constexpr int kRingRows = 64;"
_EDITS = {
    "noload": ("cp_async::copy4(slot + k * kRowStep, p);", ""),
    "nostore": ("if (store) *o = v;", ""),
}


def variant_source(text: str, build: str) -> str:
    """``fwd_probes.cu``'s ``text`` with the one line ``build`` changes."""
    if build.startswith("rows") and build[4:].isdigit():
        rows = int(build[4:])
        if not 1 <= rows <= 128:
            raise ValueError(f"{build}: 1 to 128 row threads (8 x {rows} "
                             "threads a block, at most 1024)")
        old, new = _ROWS_LINE, f"constexpr int kRingRows = {rows};"
    elif build == "depth2":
        return text
    elif build in _EDITS:
        old, new = _EDITS[build]
    else:
        raise ValueError(f"unknown build {build!r}: rows<N>, depth2, "
                         f"{', '.join(_EDITS)}")
    if text.count(old) != 1:
        raise ValueError(f"{build}: {old!r} is not one line of the source")
    return text.replace(old, new)


def build_all(builds) -> dict[str, ctypes.CDLL]:
    """Compile every distinct source of ``builds``, one ``nvcc`` each, all
    started together; load each with the launchers' argtypes."""
    text = (cuda_build.CSRC / "fwd_probes.cu").read_text()
    sources = {build: variant_source(text, build) for build in builds}
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}  # source -> (library path, nvcc)
    for build, source in sources.items():
        if source in procs:
            continue
        src = SWEEP_DIR / f"fwd_probes_{build}.cu"
        src.write_text(source)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
               f"-I{cuda_build.CSRC}", "-o", str(src.with_suffix(".so")),
               str(src)]
        procs[source] = (src.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    loaded = {}
    for source, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path.stem}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for name, argtypes in cuda_build.SIGNATURES["fwd_probes.cu"].items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        loaded[source] = lib
    return {build: loaded[source] for build, source in sources.items()}


def ring_of(build: str, l_pad: int) -> tuple[int, int]:
    """``(depth, shared bytes)`` of ``build``'s em ring at ``L_PAD``."""
    if build == "depth2":
        return 2, 4 * l_pad * pc._TILE_B * 4
    return pc.ring_plan(l_pad)


def launcher(lib, build, kind, em, out):
    """A call that launches ``kind`` from ``build``'s ``lib`` on ``em``
    into ``out``."""
    steps, rows, batch = em.shape
    l_pad = pc.pad_rows(rows)
    ring = ring_of(build, l_pad)
    name = f"probe_{kind}"
    dims = ((steps, rows, l_pad, batch, CHUNK, *ring) if kind == "noout"
            else (steps, rows, l_pad, batch, *ring))
    fn = getattr(lib, name)
    stream = torch.cuda.current_stream(em.device).cuda_stream

    def call():
        _check(fn(em.data_ptr(), out.data_ptr(), *dims, stream), name)
        return out

    return call


def events_ms(fn, iters: int) -> float:
    """CUDA-event ms of one of ``iters`` back-to-back calls of ``fn``."""
    return seconds_per_call(lambda _: fn(), [None], iters,
                            torch.device("cuda"))[0] * 1e3


def device_ms(fn, symbol: str, iters: int = 20):
    """Mean device time of ``symbol``'s launches in a profiled window of
    ``iters`` calls; None where the trace holds no record of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and symbol in e.key):
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    return total / count / 1e3 if count else None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> list[dict]:
    prog = "python -m ctc_tpu_torch.probes.ring_sweep"
    p = argparse.ArgumentParser(prog=prog,
                                description=__doc__.splitlines()[0])
    p.add_argument("--builds", default=",".join(DEFAULT_BUILDS))
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    builds = args.builds.split(",")
    device = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = build_all(builds)
    T, B, L = BENCH_SHAPE
    em = make_inputs(T, B, L, device)
    l_pad = pc.pad_rows(L)
    rows = []
    for kind in KINDS:
        want = (pc.probe_noout_plain(em, CHUNK) if kind == "noout"
                else pc.probe_body_plain(em, kind))
        out = torch.empty_like(want)
        runs = {b: [] for b in builds}
        for order in (builds, builds[::-1]):
            for build in order:
                call = launcher(libs[build], build, kind, em, out)
                runs[build].append((events_ms(call, args.iters),
                                    device_ms(call, "fwd_ops_kernel")))
        for build in builds:
            out.fill_(float("nan"))
            got = launcher(libs[build], build, kind, em, out)()
            torch.cuda.synchronize()
            dev = (None if build in _EDITS
                   else float((got - want).abs().max()))
            ev, dv = zip(*runs[build])
            row = {"probe": "ring_sweep", "build": build,
                   "kernel": f"probe_{kind}", "shape_TBL": [T, B, L],
                   "l_pad": l_pad, "ring_depth": ring_of(build, l_pad)[0],
                   "events_ms": sum(ev) / 2, "events_ms_runs": list(ev),
                   "device_ms": (sum(dv) / 2 if None not in dv else None),
                   "device_ms_runs": list(dv), "max_abs_dev": dev,
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    pad = l_pad - L
    zeroed = torch.zeros((T, l_pad, B), device=device)
    yardsticks = {"F.pad": lambda: F.pad(em, (0, 0, 0, pad)),
                  "copy_": lambda: zeroed[:, :L].copy_(em)}
    times = {name: [] for name in yardsticks}
    for name in [*yardsticks, *reversed(yardsticks)]:
        times[name].append(events_ms(yardsticks[name], args.iters))
    print(json.dumps({
        "probe": "ring_sweep", "yardsticks": True, "shape_TBL": [T, B, L],
        **{f"{name}_events_ms": sum(ms) / 2 for name, ms in times.items()},
        **{f"{name}_events_ms_runs": ms for name, ms in times.items()},
        "card": card}), flush=True)
    return rows


if __name__ == "__main__":
    main()
