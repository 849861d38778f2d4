"""The traced run's device record: a ``torch.profiler`` trace of a stretch
of whole steps, reduced to what the per-layer readers and the result's
``breakdown`` need.

* every device activity (kernels, copies, fills) as ``(name, start,
  end)`` in seconds, and which of them are kernels;
* ``busy_s``: the union of the device activities' intervals; ``window_s``:
  the stretch's length on the host clock, which ends in a synchronize;
* the longest idle gaps of the device, each named by the innermost host
  operation that spans its middle.
"""

from __future__ import annotations

import collections

#: device activities that are not kernels
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
#: the profiler's step ranges, which it lays on the host's and the
#: device's timelines alike, and the benchmark's own ranges, which it
#: mirrors on the device's: no work of either
STEP_RANGE = "ProfilerStep#"
RANGES = ("benchmark: ",)


def start(steps: int):
    """A started profiler that warms up over the next step, records the
    ``steps`` after it (``step()`` at each step's end), and then stops."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=steps,
                                     repeat=1))
    prof.start()
    return prof


def _span(event):
    try:
        return event.start_ns() * 1e-9, event.end_ns() * 1e-9
    except AttributeError:  # older profilers count in microseconds
        begin = event.start_us() * 1e-6
        return begin, begin + event.duration_us() * 1e-6


def reduce(prof, steps: int, window_s: float) -> dict:
    """The device record of a stopped profiler over ``steps`` steps."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        begin, end = _span(e)
        if e.name().startswith(STEP_RANGE):
            continue
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith(RANGES):
                device.append((e.name(), begin, end))
        elif end > begin:
            host.append((e.name(), begin, end))
    device.sort(key=lambda d: d[1])
    busy, gaps = 0.0, []
    cur_begin = cur_end = None
    for _, begin, end in device:
        if cur_end is None or begin > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_begin
                gaps.append((cur_end, begin))
            cur_begin, cur_end = begin, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_begin
    kernels = [d for d in device if not d[0].startswith(NOT_KERNELS)]
    by_name = collections.Counter()
    for name, begin, end in device:
        by_name[name] += end - begin
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = []
    for begin, end in gaps[:10]:
        mid = (begin + end) / 2
        spans = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(spans, key=lambda h: h[2] - h[1])[0] if spans
                else "Python between operations")
        idle.append([name, end - begin])
    return {
        "steps": steps,
        "window_s": window_s,
        "busy_s": busy,
        "device": device,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n[:200], s] for n, s in by_name.most_common(10)],
            "idle_gaps": idle,
        },
    }
