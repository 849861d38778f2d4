"""Device: the share of the profiled stretch in which no kernel, copy or
fill ran on the card (one minus the union of their intervals)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(record):
    prof = record.get("profile")
    if not prof or not prof["device"]:
        return None
    return 100 * (1 - prof["busy_s"] / prof["window_s"])
