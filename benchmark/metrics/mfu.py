"""The whole train step: the model FLOPs of the window's steps (the
configuration's reference module's ``step_flops``) over the window's time,
as a share of the card's dense float32 peak outside the tensor cores (the
configuration computes in float32 with TF32 off)."""

from benchmark import counts, spec

LAYER = "train step"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(record):
    steps = record.get("window_steps")
    if not steps:
        return None
    cell = record["cell"]
    flops = spec.model(cell["config"]).step_flops(cell)
    peak = counts.peaks(record["device_name"])["fp32"]
    return 100 * flops * steps / record["window_s"] / peak
