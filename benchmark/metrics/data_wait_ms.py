"""Data layer: the host's mean wait inside ``next()`` on the loader that
``Trainer.train_epoch`` iterates, over every step of the window."""

LAYER = "data"
UNIT = "ms"
MOVES = "train_windows_per_s"


def read(record):
    waits = record.get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
