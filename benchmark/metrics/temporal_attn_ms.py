"""Models: device milliseconds a step in the TimeSformer blocks' temporal
parts (norm, qkv, attention over each patch's frames, proj,
``temporal_fc``, the residual add): the device seconds that the program's
``ctc/models/timesformer/temporal`` spans carry (CUDA events at their
start and end), summed over a step's 12, averaged over the profiled
steps.  Nothing where no kept span carries a device time."""

from benchmark import program_spans

LAYER = "models"
UNIT = "ms"
MOVES = "train_windows_per_s"
SPAN = "ctc/models/timesformer/temporal"


def read(record):
    spans = program_spans.program_spans()
    if spans is None:
        return None
    by_step = {}
    for s in spans:
        device_s = getattr(s, "device_s", None)
        # step 0 (set-up) holds first calls; later kept steps are profiled
        if s.name == SPAN and s.step and device_s is not None:
            by_step[s.step] = by_step.get(s.step, 0.0) + device_s
    if not by_step:
        return None
    return 1e3 * sum(by_step.values()) / len(by_step)
