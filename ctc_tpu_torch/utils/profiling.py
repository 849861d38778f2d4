"""Profiling and tracing (port of ``ctc_tpu/utils/profiling.py``, over
``torch.profiler`` in place of ``jax.profiler``).

* :func:`trace`: a ``torch.profiler`` trace of the enclosed block, CPU
  activity and, on the card, CUDA kernels, written into a directory as a
  Chrome-trace ``*.json`` file (chrome://tracing, Perfetto).
* :class:`StepTimer`: data-wait and step wall-clock meters like the
  reference's ``batch_time`` / ``data_time``, with a per-step summary.
* :func:`annotate`: a named region in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str, *, cuda: bool | None = None):
    """Trace the enclosed block into ``logdir/trace_<pid>_<ns>.json``.

    ``cuda``: record CUDA kernels too (default: when a card is present).
    The file is written when the block ends, also when it raises; yields
    the ``torch.profiler.profile``."""
    import torch
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


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    from torch.profiler import record_function

    return record_function(name)


class StepTimer:
    """Tracks data-wait and step wall-clock; prints like the reference meters."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.steps = 0
        self._last = time.time()

    def data_ready(self):
        now = time.time()
        self.data_time += now - self._last
        self._last = now

    def step_done(self):
        now = time.time()
        self.step_time += now - self._last
        self.steps += 1
        self._last = now

    def summary(self) -> dict:
        n = max(self.steps, 1)
        return {
            "steps": self.steps,
            "data_s_per_step": self.data_time / n,
            "step_s_per_step": self.step_time / n,
        }
