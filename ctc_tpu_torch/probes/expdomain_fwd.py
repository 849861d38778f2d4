"""Does an exp-domain carry take the transcendentals off the forward's
dependent chain?  (Port of ``probe_expdomain_fwd.py``.)

The log-domain step ``alpha = logaddexp(alpha, shift(alpha)) + em`` pays an
exp and a log1p on every dependent step.  In the exp domain the chain is an
add and a multiply, ``A' = (A + shift(A)) * exp(em)``, with ``exp(em)`` off
the chain.  Times three forward kernels with one grid and block layout at
the bench shape (``[T, L_PAD, B]``, ``L_PAD`` = L rounded up to 8):

  A. the production log-domain recursion (logaddexp + masks), the baseline
  B. the exp-domain recursion
  C. B plus the per-chunk renormalization an exp-domain forward needs (a
     per-column max and a divide once every ``--chunk`` steps)

Each is timed on eight input buffers in turn ("uniq") and on one ("same");
the larger is reported.

    python -m ctc_tpu_torch.probes.expdomain_fwd             # on the card
    python -m ctc_tpu_torch.probes.expdomain_fwd --device cpu --shape 16,8,5

Prints one line per variant in the JAX probe's form, then one JSON line per
variant with its launches in this run and, on the card, the max |dev| of
the kernel's output from its plain version.
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


def variants(chunk: int):
    """``(label, kernel name, fn(em, outside), plain(em, outside))``."""
    return [
        ("log (baseline)", "probe_fwd_log", pc.probe_fwd_log,
         pc.probe_fwd_log_plain),
        ("exp-domain", "probe_fwd_exp", pc.probe_fwd_exp,
         pc.probe_fwd_exp_plain),
        ("exp+chunk-renorm", "probe_fwd_exp_renorm",
         lambda e, o: pc.probe_fwd_exp_renorm(e, o, chunk),
         lambda e, o: pc.probe_fwd_exp_renorm_plain(e, o, chunk)),
    ]


def make_inputs(T, B, L, device):
    """The JAX probe's inputs from ``default_rng(0)``: em ``[T, L_PAD, B]``
    in [-4, 0] (log-softmax gathers with the column max factored out) and
    ``outside [L_PAD, B]``, 1 at rows past a random target length in
    [1, L]."""
    l_pad = pc.pad_rows(L)
    rng = np.random.default_rng(0)
    em = (rng.standard_normal((T, l_pad, B)) * 1.5 - 2).clip(-4, 0)
    tgt = rng.integers(1, L + 1, size=B)
    outside = (np.arange(l_pad)[:, None] >= tgt[None, :]).astype(np.float32)
    return (torch.from_numpy(em.astype(np.float32)).to(device),
            torch.from_numpy(outside).to(device))


def main(argv=None) -> list[dict]:
    args = parse_args("python -m ctc_tpu_torch.probes.expdomain_fwd",
                      __doc__.splitlines()[0], argv)
    device = resolve_device(args.device)
    T, B, L = args.shape
    em, outside = make_inputs(T, B, L, device)
    bufs = [em + 1e-4 * k for k in range(8)]
    cells = T * B * L
    pc.reset_launch_counts()
    rows = []
    for label, kernel, fn, plain in variants(args.chunk):
        def call(e, _fn=fn):
            return _fn(e, outside)

        dt_u, out = seconds_per_call(call, bufs, args.iters, device)
        dt_s, _ = seconds_per_call(call, [em], args.iters, device)
        dt = max(dt_u, dt_s)
        print(f"{label:20s} {dt * 1e3:7.3f} ms fwd "
              f"(uniq {dt_u * 1e3:.3f}, same {dt_s * 1e3:.3f}) "
              f"-> {cells / dt:.3e} cells/s", flush=True)
        dev = (max_abs_dev(out, plain(bufs[0], outside))
               if device.type == "cuda" else None)
        rows.append({"probe": "expdomain_fwd", "variant": label,
                     "kernel": kernel, "ms": dt * 1e3,
                     "uniq_ms": dt_u * 1e3, "same_ms": dt_s * 1e3,
                     "cells_per_s": cells / dt, "max_abs_dev": dev})
    for row in rows:
        row.update(launches=pc.launch_counts[row["kernel"]],
                   shape_TBL=[T, B, L], l_pad=pc.pad_rows(L),
                   chunk=args.chunk, iters=args.iters,
                   device=device_name(device))
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
