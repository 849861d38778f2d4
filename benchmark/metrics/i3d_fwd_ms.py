"""Models: device milliseconds a step of the I3D backbone's forward, from
CUDA events recorded at its forward boundary over the window's steps (the
harness times the forward of the program model's attribute that the
configuration's reference module names, ``TIMED``: ``i3d``).  Nothing
where the model has no backbone."""

LAYER = "models"
UNIT = "ms"
MOVES = "train_windows_per_s"


def read(record):
    times = record.get("backbone_forward_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
