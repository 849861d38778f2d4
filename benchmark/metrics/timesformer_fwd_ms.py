"""Models: device milliseconds a step of the TimeSformer backbone's
forward, from CUDA events recorded at its forward boundary over the
window's steps (the harness times the forward of the program model's
attribute that the configuration's reference module names, ``TIMED``:
``timesformer``).  Nothing where the model has no such backbone."""

LAYER = "models"
UNIT = "ms"
MOVES = "train_windows_per_s"


def read(record):
    times = record.get("backbone_forward_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
