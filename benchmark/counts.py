"""Operation and byte counts of the benchmark's kernels, from their shapes,
and the card's published peaks.  A model's FLOPs are its reference
module's (``step_flops``).

* :func:`lattice_bytes_ops`: rows 1-2 of the blank-free lattice (the
  forward and backward kernels): each input byte read once and each output
  byte written once (em in and alpha out; alpha in and the gradient out;
  the [B] lengths and the NLL or its cotangent), and the f32 operations of
  each cell's step (8 forward: max, sub, abs, exp, log1p, add, select,
  add; 17 backward: two sigmoids, two selects, four multiplies, three
  adds).

Nothing here imports the program.
"""

from __future__ import annotations

#: published dense peaks by card (NVIDIA's H100 data sheet): float32
#: outside the tensor cores, and HBM bytes/s
PEAKS = {
    "PCIe": {"fp32": 51.2e12, "hbm": 2.0e12},
    "NVL": {"fp32": 60.0e12, "hbm": 3.9e12},
    "H100": {"fp32": 67.0e12, "hbm": 3.35e12},
}


def peaks(device_name: str) -> dict:
    """The peaks of the card named ``device_name`` (an H100 SXM unless the
    name says PCIe or NVL)."""
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return PEAKS[key]
    return PEAKS["H100"]


def lattice_bytes_ops(steps: int, batch: int, width: int) -> dict:
    """``{"forward": (bytes, ops), "backward": (bytes, ops)}`` of rows 1-2
    over a ``[steps, batch, width]`` lattice."""
    cells = steps * batch * width
    return {"forward": (8 * cells + 12 * batch, 8 * cells),
            "backward": (8 * cells + 12 * batch, 17 * cells)}


def least_seconds(nbytes: float, ops: float, device_name: str) -> float:
    """The larger of the bytes bound and the operations bound."""
    p = peaks(device_name)
    return max(nbytes / p["hbm"], ops / p["fp32"])
