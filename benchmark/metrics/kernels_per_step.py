"""Train: the device kernels a step launches (copies and fills left out),
over the profiled stretch's steps."""

LAYER = "train"
UNIT = "kernels"
MOVES = "train_windows_per_s"


def read(record):
    prof = record.get("profile")
    if not prof or not prof["kernels"]:
        return None
    return len(prof["kernels"]) / prof["steps"]
