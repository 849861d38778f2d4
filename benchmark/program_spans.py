"""The program's own spans (``ctc_tpu_torch.utils.profiling``), for the
readers of the ``program_span`` metrics.

The readers run in the process that ran the cell, after its steps, and
read the spans that the program's recorder kept there: those of the
set-up and of the trainer's step 0 (kept until step 1 begins, whatever
the switch), and those of the traced run's profiled steps (kept while a
profiler records).  The check's other steps and the warm-up's are not
kept.  A span's ``step`` is the trainer's batch count when it opened,
the step count of :class:`benchmark.feeds.Clocked`; None before the
first step.  Its times are ``time.time_ns()``, the clock of the
profiler's events.  A program without the recorder gives None.
"""

from __future__ import annotations


def program_spans():
    """The program's kept spans, or None where it keeps none."""
    from ctc_tpu_torch.utils import profiling

    get = getattr(profiling, "spans", None)
    found = get() if get is not None else None
    return found or None


def union(intervals) -> list:
    """``(begin, end)`` intervals merged where they overlap, in order.

    ``trace.reduce`` merges the device's activities by the same rule for
    ``busy_s`` and its idle gaps; the two have to agree."""
    merged = []
    for begin, end in sorted(intervals):
        if merged and begin <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([begin, end])
    return merged


def covered_s(intervals) -> float:
    """Seconds covered by ``(start_ns, end_ns)`` intervals, overlaps once."""
    return sum(end - begin for begin, end in union(intervals)) * 1e-9


def setup_seconds(prefixes: tuple) -> float | None:
    """Seconds covered by the kept spans named ``prefixes*`` of the set-up
    and of step 0 (where the kernel libraries load): all of them end
    before the window."""
    spans = program_spans()
    if spans is None:
        return None
    return covered_s((s.start_ns, s.end_ns) for s in spans
                     if s.name.startswith(prefixes) and not s.step)


def idle_gaps(device) -> list:
    """The device's idle intervals ``(begin, end)`` (seconds) between the
    first and the last of its activities ``(name, begin, end)``."""
    busy = union((begin, end) for _, begin, end in device)
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
