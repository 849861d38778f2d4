"""Operation and byte counts of the benchmark's models and kernels, from
their shapes, and the card's published peaks.

* :func:`i3d_flops`: the I3D's convolutions (2 per multiply-add, the
  zero padding included), max and average pools (one per window element)
  and BatchNorm (2 per element for the scale and shift, 3 more for the
  batch statistics in training mode), for ``clips`` clips.  Frozen: the
  forward alone.  Finetuned: the forward, each convolution's weight
  gradient and input gradient except the first's (its input is the
  frames), twice the forward's BatchNorm and one operation per pool input.
* :func:`head_flops`: the LSTM head's three matrix products per step and
  its BatchNorm, forward and backward; the feature projection's input
  gradient only where the backbone trains.
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

import math

from benchmark.reference.model import BRANCHES, I3D

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


def _out(size, kernel, stride):
    return tuple(math.ceil(n / s) for n, s in zip(size, stride))


def i3d_flops(clips: int, *, frames: int = 10, size: int = 224,
              finetune: bool = False) -> float:
    """Model FLOPs of the I3D over ``clips`` clips of ``frames`` x ``size``
    x ``size``."""
    parts = i3d_parts(clips, frames=frames, size=size, finetune=finetune)
    if not finetune:
        return parts["conv"] + parts["pool"] + parts["bn"]
    return (2 * parts["conv"] + parts["conv_dgrad"] + parts["pool"]
            + parts["pool_inputs"] + 3 * parts["bn"])


def i3d_parts(clips: int, *, frames: int = 10, size: int = 224,
              finetune: bool = False) -> dict:
    """The I3D's forward FLOPs by kind: ``conv`` (2 a multiply-add),
    ``conv_dgrad`` (the convolutions that take an input gradient), ``pool``
    (a window element each), ``bn``, and ``pool_inputs`` (the elements the
    pools read)."""
    conv = conv_dgrad = pool = bn = 0.0
    first = True
    shape, c = (frames, size, size), 3

    def unit(shape, cin, cout, kernel, stride):
        nonlocal conv, conv_dgrad, bn, first
        out = _out(shape, kernel, stride)
        elems = clips * cout * math.prod(out)
        macs = elems * cin * math.prod(kernel)
        conv += 2 * macs
        if not first:
            conv_dgrad += 2 * macs
        first = False
        bn += elems * (5 if finetune else 2)
        return out

    def max_pool(shape, ch, kernel, stride):
        nonlocal pool
        out = _out(shape, kernel, stride)
        pool += clips * ch * math.prod(out) * math.prod(kernel)
        pool_in = clips * ch * math.prod(shape)
        return out, pool_in

    pool_inputs = 0.0
    for _, kind, spec in I3D:
        if kind == "unit":
            cout, kernel, stride = spec
            shape, c = unit(shape, c, cout, kernel, stride), cout
        elif kind == "pool":
            shape, n = max_pool(shape, c, *spec)
            pool_inputs += n
        else:
            widths = {"b1a": spec[1], "b2a": spec[3]}
            for name, src, idx, k in BRANCHES:
                cin = widths.get(src, c)
                if src == "pool":
                    _, n = max_pool(shape, c, (3, 3, 3), (1, 1, 1))
                    pool_inputs += n
                unit(shape, cin, spec[idx], (k,) * 3, (1, 1, 1))
            c = spec[0] + spec[2] + spec[4] + spec[5]
    # the (2, 7, 7) average pool of stride 1, then the mean over the rest
    avg = (shape[0] - 1, shape[1] - 6, shape[2] - 6)
    pool += clips * c * (math.prod(avg) * 2 * 7 * 7 + math.prod(avg))
    return {"conv": conv, "conv_dgrad": conv_dgrad, "pool": pool, "bn": bn,
            "pool_inputs": pool_inputs}


def head_flops(rows: int, in_features: int, hidden: int, *,
               input_grad: bool = False) -> float:
    """Model FLOPs of one train step of the LSTM head over ``rows`` = T x
    B feature rows."""
    proj = 2 * rows * in_features * hidden
    gates = 2 * rows * hidden * 4 * hidden
    recurrent = 2 * rows * hidden * 4 * hidden
    bn = 5 * rows * hidden
    forward = proj + gates + recurrent + bn
    backward = (proj * (2 if input_grad else 1) + 2 * gates
                + 2 * recurrent + 2 * bn)
    return forward + backward


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
