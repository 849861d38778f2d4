"""Train: the device's idle time at each step's turn that the program's
own host work holds, from its spans and the profiled stretch's device
record.  A step ends in the trainer's blocking read of its metrics
(``ctc/train/read``); the device, drained by it, idles until the next
step's first work arrives.  A turn is the idle interval that holds the
read's end (0 where the device was busy there), less the time in it that
the trainer waits for the next batch (``ctc/train/wait``): the feed's
``next()``, and in a traced run the harness's step-end work and its
profiler's step, which an untraced run does not have.  The median over
the profiled turns, so that one stall of the profiler's own buffers,
which lands in a turn now and then, does not set it.  The part of
``device_idle_pct`` that the per-step read causes; the rest is idle
inside the steps."""

import statistics

from benchmark import program_spans

LAYER = "train"
UNIT = "ms"
MOVES = "train_windows_per_s"


def read(record):
    prof = record.get("profile")
    spans = program_spans.program_spans()
    if not prof or not prof["device"] or spans is None:
        return None
    gaps = program_spans.idle_gaps(prof["device"])
    first = min(d[1] for d in prof["device"])
    last = max(d[2] for d in prof["device"])
    waits = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans
             if s.name == "ctc/train/wait"]
    turns = []
    for s in spans:
        end = s.end_ns * 1e-9
        if s.name != "ctc/train/read" or not first < end < last:
            continue
        a, b = next(((a, b) for a, b in gaps if a <= end <= b), (end, end))
        waited = sum(max(0.0, min(b, w1) - max(a, w0)) for w0, w1 in waits)
        turns.append(max(0.0, b - a - waited))
    if not turns:
        return None
    return 1e3 * statistics.median(turns)
