"""Time the shard backward kernels (rows 4 and 8) against builds of their
own sources that differ in one or two places each, and at other block
sizes, at the seq main path's and the long-T shard shapes on the card.

    python -m ctc_tpu_torch.probes.shard_sweep
    python -m ctc_tpu_torch.probes.shard_sweep --builds source,nostore \\
        --threads 128,512

A build is ``source`` (the sources as they stand), ``nostore`` (the steps
do not store g to device memory), ``noweights`` (the weight phase computes
nothing; the steps read whatever the weights' shared memory holds),
``nosync`` (no barrier between steps: the steps race) or ``stepwarps``
(only the warps that hold cells run the steps, synchronised by a named
barrier of those warps instead of the whole block's).  Each build's two
sources are compiled with the flags of ``ops/cuda_build.py`` into
``build/ctc_tpu_torch/shard_sweep/``, all at once; the ptxas lines of each
build's shard backward kernels are printed.  Each build runs at each of
``--threads`` with the chunk and shared bytes of
:func:`~ctc_tpu_torch.ops.lattice_cuda.shard_backward_plan`, on the
operands of ``shard_ab``.

Prints the card's name and power limit, then one JSON line per build,
family, shape and block size: the kernel's device time from
``torch.profiler`` (median, min and max of ``shard_ab.WINDOWS`` windows),
``step_us``, and max |dev| from the package's own kernel (null for
``nostore``, ``noweights`` and ``nosync``, which compute another
function).  Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops.lattice_cuda import _check
from ctc_tpu_torch.probes import max_abs_dev
from ctc_tpu_torch.probes.ring_sweep import card_line
from ctc_tpu_torch.probes.shard_ab import SHAPES, make_case, windows_ms
from ctc_tpu_torch.train.trainer import resolve_device

SWEEP_DIR = cuda_build.BUILD_DIR / "shard_sweep"
DEFAULT_BUILDS = ("source", "nostore", "noweights", "nosync", "stepwarps")
DEFAULT_THREADS = (128, 256, 512)
FAMILIES = {"noblank": dict(weights=2), "blank": dict(weights=3, mask_bytes=1)}
_STEP_LOOP = ("    stage(c + 2);  // into the buffer chunk c leaves\n"
              "    for (int k = n - 1; k >= 0; --k) {")
_STEP_SYNC = "      __syncthreads();\n    }\n  }\n  // g[0]"
# build -> family -> [(text, replacement), ...], each text once in the source
_EDITS = {
    "nostore": {
        "noblank": [("        g_t[l] = v;\n        g_cur[l] = v;",
                     "        g_cur[l] = v;")],
        "blank": [("        g_t[s] = v;\n        g_cur[s] = v;",
                   "        g_cur[s] = v;")],
    },
    "noweights": {
        "noblank": [("        w_k[l] = w * in_l;\n"
                     "        w_k[L + l] = (1.0f - w) * in_l;\n", "")],
        "blank": [("        branch_weights(a + k * S, a + k * S, skip_sh, s, S,\n"
                   "                       weights + 3 * k * S);\n", "")],
    },
    "nosync": {family: [(_STEP_SYNC, "    }\n  }\n  // g[0]")]
               for family in ("noblank", "blank")},
    "stepwarps": {
        family: [
            (_STEP_LOOP,
             "    stage(c + 2);  // into the buffer chunk c leaves\n"
             f"    const int step_threads = min(nt, ({width} + 31) / 32 * 32);\n"
             "    if (tid < step_threads)\n"
             "    for (int k = n - 1; k >= 0; --k) {"),
            (_STEP_SYNC,
             '      asm volatile("bar.sync 1, %0;" ::"r"(step_threads) '
             ': "memory");\n    }\n  }\n  __syncthreads();\n  // g[0]'),
        ]
        for family, width in (("noblank", "L"), ("blank", "S"))
    },
}


def variant_source(text: str, family: str, build: str) -> str:
    """``<family>_lattice.cu``'s ``text`` with ``build``'s edits."""
    if build == "source":
        return text
    if build not in _EDITS:
        raise ValueError(f"unknown build {build!r}: source, "
                         f"{', '.join(_EDITS)}")
    for old, new in _EDITS[build][family]:
        if text.count(old) != 1:
            raise ValueError(f"{build}: {old!r} is not once in {family}'s "
                             "source")
        text = text.replace(old, new)
    return text


def build_all(builds):
    """Compile every build's two sources, one ``nvcc`` each, all started
    together; return ``{(build, family): launcher}`` and each build's
    ptxas lines of the shard backward kernels."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for build in builds:
        for family in FAMILIES:
            source = f"{family}_lattice.cu"
            src = SWEEP_DIR / f"{family}_lattice_{build}.cu"
            src.write_text(variant_source(
                (cuda_build.CSRC / source).read_text(), family, build))
            out = src.with_suffix(".so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                   f"-I{cuda_build.CSRC}", "-o", str(out), str(src)]
            procs[(build, family)] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    launchers, ptxas = {}, {}
    for (build, family), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {out.stem}:\n{log}")
        # ptxas names the kernel on one line and its stack, spills and
        # registers on the next three
        lines = log.splitlines()
        ptxas[(build, family)] = [
            " ".join(lines[i:i + 4]) for i, line in enumerate(lines)
            if "shard_backward_kernel" in line and "Compiling" in line]
        name = f"{family}_shard_backward"
        fn = getattr(ctypes.CDLL(str(out)), name)
        fn.argtypes = list(cuda_build.SIGNATURES[f"{family}_lattice.cu"][name])
        fn.restype = ctypes.c_int
        launchers[(build, family)] = fn
    return launchers, ptxas


def runner(fn, family, args, threads):
    """A call of the launcher ``fn`` on the shard_ab operands ``args`` at
    ``threads``; it returns ``(g, d row 0, d row 1)``."""
    alpha, rows = args[0], args[-2:]
    chunk, _, smem = lc.shard_backward_plan(alpha.shape[2],
                                            **FAMILIES[family])
    outs = (torch.empty_like(alpha), torch.empty_like(rows[0]),
            torch.empty_like(rows[1]))
    stream = torch.cuda.current_stream(alpha.device).cuda_stream

    def call():
        _check(fn(*(t.data_ptr() for t in args),
                  *(t.data_ptr() for t in outs), *alpha.shape, chunk,
                  threads, smem, stream), f"{family}_shard_backward")
        return outs

    return call


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m ctc_tpu_torch.probes.shard_sweep",
        description=__doc__.splitlines()[0])
    p.add_argument("--builds", default=",".join(DEFAULT_BUILDS))
    p.add_argument("--threads", default=",".join(map(str, DEFAULT_THREADS)))
    args = p.parse_args(argv)
    builds = args.builds.split(",")
    threads = [int(x) for x in args.threads.split(",")]
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    launchers, ptxas = build_all(builds)
    for key, lines in ptxas.items():
        print(json.dumps({"probe": "shard_sweep", "build": key[0],
                          "family": key[1], "ptxas": lines}), flush=True)
    rows = []
    for family in FAMILIES:
        package = (lc.noblank_shard_grad_kernel if family == "noblank"
                   else bl.blank_shard_grad_kernel)
        for label, shape in SHAPES[family].items():
            case = make_case(family, shape, "cuda", seed=sum(shape))
            want = package(*case)
            for build in builds:
                for n in threads:
                    call = runner(launchers[(build, family)], family, case, n)
                    got = call()
                    torch.cuda.synchronize()
                    dev = (None if build in ("nostore", "noweights", "nosync") else
                           max(max_abs_dev(a, b) for a, b in zip(got, want)))
                    median, min_max = windows_ms(
                        call, f"{family}_shard_backward_kernel")
                    t_s = shape[0]
                    row = {"probe": "shard_sweep", "build": build,
                           "family": family, "shape": label,
                           "shard_shape_TBW": list(case[0].shape),
                           "threads": n, "device_ms": median,
                           "device_ms_min_max": min_max,
                           "step_us": (median * 1e3 / t_s
                                       if median is not None else None),
                           "max_abs_dev": dev, "card": card}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
