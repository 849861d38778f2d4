"""Profiling and tracing (port of ``ctc_tpu/utils/profiling.py``, over
``torch.profiler`` in place of ``jax.profiler``).

* :func:`trace`: a ``torch.profiler`` trace of the enclosed block, CPU
  activity and, on the card, CUDA kernels, written into a directory as a
  Chrome-trace ``*.json`` file (chrome://tracing, Perfetto).
* :func:`span`: a named stretch of the program's own work, kept in memory
  (:func:`spans`) and, under a profiler, shown in its trace.

The spans
---------

Every span is named ``ctc/<layer>/...`` after the port's layers: ``data``
(loaders, decode), ``models``, ``ops`` (losses and kernels) and ``train``
(the trainer).  The program opens them at its layer boundaries:

* set-up, in ``cli.main.run``: ``ctc/data/build/decoder`` (the JPEG
  decoder's build and load), ``ctc/data/dataset`` (CSV, frame count,
  windows, extraction), ``ctc/models/build``, ``ctc/train/init`` (the
  ``Trainer``, whose generator creates the CUDA context, and
  ``init_state``, with ``ctc/models/init``: the weights' draw on the CPU
  and their move to the device), and ``ctc/ops/build/<source>.cu`` (the
  ``nvcc`` build or cached load of a kernel library, at its first call,
  inside the first step);
* each step of the trainer, train or eval: ``ctc/train/wait`` (the next
  batch from the loader), ``ctc/train/place`` (a mesh rank's rows),
  ``ctc/train/to_device``, ``ctc/train/zero_grad`` (the optimizer clears
  the gradient sums), ``ctc/models/i3d`` with one span for each of
  its endpoints (``ctc/models/i3d/Mixed_4b``, ...) and
  ``ctc/models/i3d/avg_pool``, ``ctc/models/head``, ``ctc/ops/loss``,
  ``ctc/train/backward``, ``ctc/train/optimizer``, ``ctc/train/read``
  (the blocking copy of the step's metrics to the host) and
  ``ctc/train/log`` (meters, log line, CSV row); a group of K steps under
  ``--steps-per-dispatch`` is one ``ctc/train/group``, whose inner spans
  fire only while the group runs in Python (warm-up and capture), not at a
  CUDA-graph replay;
* ``ctc/data/decode``: one batch's decode, on the loader's prefetch thread
  in a live run.

A span records its name, its start and end (``time.time_ns()``, the clock
of ``torch.profiler``'s events), the span it opened inside (on the same
thread), its thread and the trainer's step it belongs to (None before the
first step: set-up).  A span opened with a CUDA ``device``
(``span(name, device=x.device)``: the TimeSformer backbone's parts,
``ctc/models/timesformer/*``) also records CUDA events on
that device's current stream at its start and end, and gives the device
seconds between them as ``device_s`` (which waits for the end event);
every other span's ``device_s`` is None, and it records no event.  No
event is recorded while the stream captures a CUDA graph.

When spans are kept
-------------------

* while switched on (:func:`record`);
* while a ``torch.profiler`` records (:func:`trace`, ``--profile-dir``,
  or a caller's own profiler): each span is then also a range of the same
  name on the profiler's host timeline.  The range is a plain function
  range, not a user annotation, so the profiler lays no copy of it on the
  device's timeline, where it would read as device work;
* in set-up: until the trainer's second step begins (``set_step(1)``),
  which keeps the set-up's spans and the first step's, where the kernel
  libraries build and load.

At most :data:`KEPT` spans of one name are kept, whatever kept them, so a
long recording, a profiled epoch or a feature extraction in set-up (the
I3D over a whole split) holds a bounded list.  Otherwise :func:`span`
returns one shared no-op context: three flag reads a span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

#: spans of one name kept at most
KEPT = 1024

# a function-scope range: the profiler mirrors user annotations
# (``record_function``) onto the device's timeline, and not these
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_lock = threading.Lock()
_local = threading.local()
_kept: list[Span] = []
_counts: dict[str, int] = {}
_on = False  # switched on by record(True)
_setup = True  # before the trainer's second step
_step: int | None = None


class Span:
    """One span: ``name``, ``start_ns``, ``end_ns`` (``time.time_ns()``),
    ``parent`` (the enclosing :class:`Span` of the same thread, or None),
    ``thread`` (``threading.get_ident()``) and ``step`` (None in set-up).
    Entered, it times the enclosed block."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "step",
                 "_range")
    #: device seconds between the span's start and end, where it timed them
    device_s = None

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = None
        self.parent = None
        self.thread = threading.get_ident()
        self.step = _step
        self._range = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if _range is not None and _autograd_profiler._is_profiler_enabled:
            self._range = _range(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _stack().pop()
        _keep(self)
        return False


class DeviceSpan(Span):
    """A :class:`Span` that also times its block on a CUDA device."""

    __slots__ = ("_stream", "_events")

    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self._stream = torch.cuda.current_stream(device)
        self._events = None

    def __enter__(self):
        super().__enter__()
        if not torch.cuda.is_current_stream_capturing():
            self._events = [torch.cuda.Event(enable_timing=True), None]
            self._events[0].record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1] = torch.cuda.Event(enable_timing=True)
            self._events[1].record(self._stream)
        return super().__exit__(*exc)

    @property
    def device_s(self) -> float | None:
        if self._events is None or self._events[1] is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


class _Off:
    """The shared context of a span that is not kept."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keeping() -> bool:
    return _on or _setup or _autograd_profiler._is_profiler_enabled


def _keep(s: Span) -> None:
    with _lock:
        # recording may have stopped, or the set-up ended, meanwhile
        if not _keeping():
            return
        n = _counts.get(s.name, 0)
        if n < KEPT:
            _counts[s.name] = n + 1
            _kept.append(s)


def span(name: str, device: torch.device | None = None):
    """A span named ``name`` (``ctc/<layer>/...``) over the enclosed block,
    or :data:`OFF` where it would not be kept.  With a CUDA ``device`` it
    also times the block there (:class:`DeviceSpan`)."""
    if not _keeping():
        return OFF
    if device is not None and device.type == "cuda":
        return DeviceSpan(name, device)
    return Span(name)


def record(on: bool) -> None:
    """Keep spans (``True``) or stop keeping them (``False``) from now on,
    besides those of the set-up and those under a profiler."""
    global _on
    _on = bool(on)


def spans() -> list[Span]:
    """The kept spans, in the order they ended."""
    with _lock:
        return list(_kept)


def set_step(step: int) -> None:
    """The trainer's step that spans opened from now on belong to (on any
    thread); step 1 ends the set-up."""
    global _step, _setup
    _step = step
    if step > 0:
        _setup = False


@contextlib.contextmanager
def trace(logdir: str, *, cuda: bool | None = None):
    """Trace the enclosed block into ``logdir/trace_<pid>_<ns>.json``, with
    the program's spans as host ranges (and kept, :func:`spans`).

    ``cuda``: record CUDA kernels too (default: when a card is present).
    The file is written when the block ends, also when it raises; yields
    the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
