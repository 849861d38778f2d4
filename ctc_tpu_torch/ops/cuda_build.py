"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each source under ``ctc_tpu_torch/csrc/`` becomes one shared library with a
plain ``extern "C"`` interface, compiled at first use into
``build/ctc_tpu_torch/`` at the repository root (listed in ``.gitignore``).
The library is named after a hash of its source and flags, so an edit
rebuilds it and an unchanged source is loaded as built.  Nothing here runs
at import time: the CPU tests import this module on a machine with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from ctc_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ctc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of every launcher, by source file; pointers and the stream are
#: c_void_p so ctypes does not cut them to 32 bits
SIGNATURES = {
    "noblank_lattice.cu": {
        # em, inlen, tgt, alpha, nll, T, B, L, layout, depth, threads,
        # shared bytes, stream
        "noblank_lattice_forward": (*(_P,) * 5, *(_I,) * 7, _P),
        # alpha, inlen, tgt, nll_bar, g, T, B, L, layout, chunk, threads,
        # shared bytes, stream
        "noblank_lattice_backward": (*(_P,) * 5, *(_I,) * 7, _P),
        # em, inlen, tgt, stay0, adv0, alpha, final, boundary, T, B, L,
        # em row stride, depth, threads, shared bytes, stream
        "noblank_shard_forward": (*(_P,) * 8, *(_I,) * 7, _P),
        # alpha, inlen, tgt, final_bar, g_seed, stay0, adv0, g, d_stay0,
        # d_adv0, T, B, L, chunk, threads, shared bytes, stream
        "noblank_shard_backward": (*(_P,) * 10, *(_I,) * 6, _P),
    },
    "blank_lattice.cu": {
        # em, skip_ok, inlen, tgt, alpha, nll, T, B, S, layout, depth,
        # threads, shared bytes, stream
        "blank_lattice_forward": (*(_P,) * 6, *(_I,) * 7, _P),
        # alpha, skip_ok, inlen, tgt, nll_bar, g, T, B, S, layout, chunk,
        # threads, shared bytes, stream
        "blank_lattice_backward": (*(_P,) * 6, *(_I,) * 7, _P),
        # em, skip_ok, inlen, tgt, init0, skip0, alpha, final, boundary, T,
        # B, S, em row stride, depth, threads, shared bytes, stream
        "blank_shard_forward": (*(_P,) * 9, *(_I,) * 7, _P),
        # alpha, skip_ok, inlen, tgt, final_bar, g_seed, init0, skip0, g,
        # d_init0, d_skip0, T, B, S, chunk, threads, shared bytes, stream
        "blank_shard_backward": (*(_P,) * 11, *(_I,) * 6, _P),
    },
    "fwd_probes.cu": {
        # em, out, T, L, L_pad, B, ring depth, shared bytes, stream
        **{f"probe_{body}": (_P, _P, _I, _I, _I, _I, _I, _I, _P)
           for body in ("copy", "add", "roll", "lse", "lse_manual",
                        "lse_exp2")},
        # em, out, T, L, L_pad, B, chunk, ring depth, shared bytes, stream
        "probe_noout": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        # em, outside, out, T, L_pad, B, ring depth, shared bytes, stream
        "probe_fwd_log": (_P, _P, _P, *(_I,) * 5, _P),
        "probe_fwd_exp": (_P, _P, _P, *(_I,) * 5, _P),
        # em, outside, out, T, L_pad, B, chunk, ring depth, shared bytes,
        # stream
        "probe_fwd_exp_renorm": (_P, _P, _P, *(_I,) * 6, _P),
    },
    "max_pool3d_same.cu": {
        # x, y, offsets (or null), dtype, N, C, D, H, W, OD, OH, OW, kd,
        # kh, kw, sd, sh, sw, pd, ph, pw, TH, TW, stream
        "max_pool3d_same_forward": (_P, _P, _P, *(_I,) * 20, _P),
        # gy, offsets, gx, dtype, N, C, D, H, W, OD, OH, OW, kd, kh, kw,
        # sd, sh, sw, pd, ph, pw, stream
        "max_pool3d_same_backward": (_P, _P, _P, *(_I,) * 18, _P),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build, by source
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives (named after
    the source, every header beside it and the flags)."""
    digest = hashlib.sha256()
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library for this exact source and
    these flags exists; return its path.  Raises on a compiler error."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    build_logs[source] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, with every launcher's
    ``argtypes`` and ``restype`` set."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            with span(f"ctc/ops/build/{source}"):
                lib = ctypes.CDLL(str(build(source)))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int  # cudaError_t
            _loaded[source] = lib
        return lib
