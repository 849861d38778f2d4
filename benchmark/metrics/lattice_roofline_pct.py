"""Ops: rows 1-2 of the blank-free lattice (``noblank_forward_kernel*``,
``noblank_backward_kernel*``) against their roofline: the least time a
step's forward and backward could take (:func:`benchmark.counts.
lattice_bytes_ops` at the step's ``[T, B, T]`` lattice) over their device
time a step in the profiled stretch.  Nothing where neither ran."""

import re

from benchmark import counts

LAYER = "ops"
UNIT = "%"
MOVES = "train_windows_per_s"
KERNELS = re.compile(r"(?<![a-z])noblank_(forward|backward)_kernel")


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    spans = [end - begin for name, begin, end in prof["kernels"]
             if KERNELS.search(name)]
    if not spans:
        return None
    cell = record["cell"]
    steps = cell["config"]["geometry"]["temporal"]
    work = counts.lattice_bytes_ops(steps, cell["batch_size"], steps)
    least = sum(counts.least_seconds(*work[k], record["device_name"])
                for k in ("forward", "backward"))
    return 100 * least / (sum(spans) / prof["steps"])
