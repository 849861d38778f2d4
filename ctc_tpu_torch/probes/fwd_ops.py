"""Decompose the blank-free forward step's cost op by op (port of
``probe_fwd_ops.py``).

Times stripped variants of the forward recursion, one kernel each with the
same grid, blocks and loads, at the bench shape in the ``[T, L, B]``
layout: copy -> add -> shift + max -> logaddexp -> log1p(exp) by hand ->
exp only, and the logaddexp body writing only each chunk's last carry.
The differences between variants price one operation each.

    python -m ctc_tpu_torch.probes.fwd_ops                  # on the card
    python -m ctc_tpu_torch.probes.fwd_ops --device cpu --shape 16,8,5

Prints one line per variant in the JAX probe's form (ms, cells/s), then one
JSON line per variant with its launches in this run and, on the card, the
max |dev| of the kernel's output from its plain version.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ctc_tpu_torch.ops import probe_cuda as pc
from ctc_tpu_torch.probes import (
    device_name,
    max_abs_dev,
    parse_args,
    seconds_per_call,
)
from ctc_tpu_torch.train.trainer import resolve_device

#: the JAX probe's label for the carry-only variant
NOOUT = "lse_boundary_only_out"


def variants(chunk: int):
    """``(label, kernel name, fn(em), plain(em))`` of every variant, in
    ladder order."""
    out = [(body, f"probe_{body}",
            lambda e, _b=body: pc.probe_body(e, _b),
            lambda e, _b=body: pc.probe_body_plain(e, _b))
           for body in pc.BODIES]
    out.append((NOOUT, "probe_noout", lambda e: pc.probe_noout(e, chunk),
                lambda e: pc.probe_noout_plain(e, chunk)))
    return out


def make_inputs(T, B, L, device):
    """The JAX probe's emissions ``[T, L, B]`` from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    em = (rng.standard_normal((T, L, B)) - 1).astype(np.float32)
    return torch.from_numpy(em).to(device)


def main(argv=None) -> list[dict]:
    prog = "python -m ctc_tpu_torch.probes.fwd_ops"
    args = parse_args(prog, __doc__.splitlines()[0], argv)
    T, B, L = args.shape
    if T % args.chunk:
        raise SystemExit(f"{prog}: T={T} is not a multiple of --chunk "
                         f"{args.chunk} (the carry-only variant needs it)")
    device = resolve_device(args.device)
    em = make_inputs(T, B, L, device)
    cells = T * B * L
    pc.reset_launch_counts()
    rows = []
    for label, kernel, fn, plain in variants(args.chunk):
        dt, out = seconds_per_call(fn, [em], args.iters, device)
        print(f"{label}: {dt * 1e3:.3f} ms -> {cells / dt:.3e} cells/s",
              flush=True)
        dev = max_abs_dev(out, plain(em)) if device.type == "cuda" else None
        rows.append({"probe": "fwd_ops", "variant": label, "kernel": kernel,
                     "ms": dt * 1e3, "cells_per_s": cells / dt,
                     "max_abs_dev": dev})
    for row in rows:
        row.update(launches=pc.launch_counts[row["kernel"]],
                   shape_TBL=[T, B, L], l_pad=pc.pad_rows(L),
                   chunk=args.chunk, iters=args.iters,
                   device=device_name(device))
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
