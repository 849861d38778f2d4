"""The loader that ``Trainer.train_epoch`` iterates in a run, and the clock
around it.

:class:`Clocked` wraps a cell's train loader.  Each request for a batch
ends the step before it, so the ends of the steps, the host's wait inside
each ``next()``, and the batches themselves are seen here without touching
the trainer.  A run is one sequence of steps over epoch after epoch; a
phase plan (``on_step_end``) says what happens at each step's end: the
check's snapshots, the start of the timed window, its close.

:class:`Resident` holds the first batches of a loader on the device and
replays them in order, an epoch as long as the loader's.
"""

from __future__ import annotations

import contextlib
import time


class Stop(Exception):
    """Raised by a step-end hook to end the run's steps."""


class Clocked:
    """``loader`` with its steps clocked.  ``on_step_end(step, now)`` runs
    at the end of each step (0-based over the whole run); it may raise
    :class:`Stop`.  The batches of the first ``keep`` steps are kept (the
    check's); ``span()``, where given, wraps each ``next()`` (a profiler
    range in a traced run).  ``rows[i]``, ``ends[i]`` and
    ``waits[i]`` are step ``i``'s batch rows, end time and data wait."""

    def __init__(self, loader, on_step_end, *, keep=0, span=None):
        self.loader = loader
        self.on_step_end = on_step_end
        self.span = span or contextlib.nullcontext
        self.rows, self.ends, self.waits = [], [], []
        self.batches = []  # the first ``keep`` steps' batches
        self.keep = keep
        self.stopped = False
        self._pending = False

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            now = time.perf_counter()
            if self._pending:
                self._pending = False
                self.ends.append(now)
                try:
                    self.on_step_end(len(self.ends) - 1, now)
                except Stop:
                    self.stopped = True
                    return
            t0 = time.perf_counter()
            try:
                with self.span():
                    batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            self.rows.append(int(batch["feats"].shape[0]))
            if len(self.batches) < self.keep:
                self.batches.append(batch)
            self._pending = True
            yield batch


class Resident:
    """The first ``count`` batches of ``loader`` (decoded by its own
    ``__getitem__``), moved to ``device`` by ``to_device``, replayed in
    order over epochs of ``len(loader)`` steps."""

    def __init__(self, loader, count: int, to_device, device):
        self.length = len(loader)
        self.batches = [to_device(loader[i], device) for i in range(count)]

    def __len__(self):
        return self.length

    def __iter__(self):
        return (self.batches[i % len(self.batches)]
                for i in range(self.length))
