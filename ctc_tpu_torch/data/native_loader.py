"""JPEG frame decoding for the pixels path (port of
``ctc_tpu/data/native_loader.py``).

``decode_frames(paths)`` decodes and preprocesses JPEGs (decode, PIL-style
triangle resize of the shorter side, center crop, ``(x / 255 - 0.5) / 0.5``,
channels-last float32) with one of two decoders:

* ``native``: ``native/dataloader.cpp``'s C++ thread pool over libjpeg,
  compiled with ``g++ -O3 -shared -fPIC ... -ljpeg -pthread`` at first use
  into ``build/ctc_tpu_torch/`` (git-ignored; the library is named after a
  hash of the source and the flags), never into ``native/``.  It needs
  libjpeg's header and library on the machine;
* ``pil``: :func:`ctc_tpu_torch.data.frames.load_frame` over a thread pool
  (Pillow releases the GIL while it decodes and resizes); the same numbers
  as one frame after another.

:func:`decoder` says which one runs (native where it builds, else PIL),
and ``decoder="pil"`` asks for PIL whatever builds (feature extraction,
which reads frames as ``ctc_tpu``'s does).  The two differ by a
few gray levels: PIL's filter weights are fixed point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ctc_tpu_torch.data.frames import STACK, load_frame, window_frame_paths
from ctc_tpu_torch.utils.profiling import span

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ctc_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-ljpeg", "-pthread")

_lock = threading.Lock()
_lib = None
#: why the native decoder did not build or load (None until tried, "" when
#: it did)
build_error: str | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libctcdata_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE),
           *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{proc.stderr.strip()[-500:]}")
    os.replace(tmp, out)
    return out


def _load():
    """The native library, built and loaded once a process; None where it
    cannot be (``build_error`` says why)."""
    global _lib, build_error
    with _lock:
        if build_error is None:
            with span("ctc/data/build/decoder"):
                try:
                    lib = ctypes.CDLL(str(_build()))
                    lib.ctc_decode_frames.restype = ctypes.c_int
                    lib.ctc_decode_frames.argtypes = [
                        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_float),
                    ]
                    _lib, build_error = lib, ""
                except Exception as e:  # no compiler, no libjpeg
                    build_error = f"{type(e).__name__}: {e}"
        return _lib


def decoder() -> str:
    """``"native"`` where the C++ decoder builds and loads, else
    ``"pil"``."""
    return "native" if _load() is not None else "pil"


def decode_frames(paths, *, inputsize: int = 224, num_threads: int = 0,
                  decoder: str | None = None) -> np.ndarray:
    """Decode and preprocess ``paths`` -> ``[n, inputsize, inputsize, 3]``
    float32 with :func:`decoder`'s choice (``decoder="pil"``: PIL) on
    ``num_threads`` threads (0: one a core)."""
    threads = num_threads or os.cpu_count() or 1
    lib = _load() if decoder != "pil" else None
    if lib is None:
        with ThreadPoolExecutor(threads) as pool:
            frames = list(pool.map(lambda p: load_frame(p, inputsize),
                                   paths))
        return np.stack(frames)
    n = len(paths)
    out = np.empty((n, inputsize, inputsize, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    resize_target = int(256.0 / 224 * inputsize)
    rc = lib.ctc_decode_frames(
        arr, n, resize_target, inputsize, threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]}")
    return out


def load_window_native(anchor_paths, gap: int, *, inputsize: int = 224,
                       stack: int = STACK,
                       decoder: str | None = None) -> np.ndarray:
    """``[T]`` anchor frame paths -> ``[T, stack, h, w, 3]`` float32 clip
    (:func:`ctc_tpu_torch.data.frames.load_window` through
    :func:`decode_frames`)."""
    flat = [fp for p in anchor_paths
            for fp in window_frame_paths(p, gap, stack)]
    frames = decode_frames(flat, inputsize=inputsize, decoder=decoder)
    return frames.reshape(len(anchor_paths), stack, inputsize, inputsize, 3)
