"""The check's control and planted faults, read at a cell's own size.

For each seed this writes the cell's inputs, draws its initial weights,
works out its first batches and runs the reference's steps; then it runs
the reference again in the program's place, once per variant, and prints
the numbers that decide ``correct`` for that variant against the first:

* ``tf32``: the nearest precision below the configuration's float32 with
  TF32 off, i.e. TF32 in the convolutions and matmuls (the control);
* ``half_batch``: half of each batch left out, the loss the mean over the
  rest;
* ``unchanged``: steps that leave the state as it was (learning rate 0).

Run on the card, no measured window: ``python3 -m benchmark.control
--workload <cell> --seeds 1,2,3 [--variants tf32,half_batch,unchanged]``.
One JSON line per seed and variant.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

VARIANTS = ("tf32", "half_batch", "unchanged")


def readings(cell: dict, seed: int, variants, device: str = "cuda",
             root=None) -> dict:
    """``{variant: compare() numbers}`` of one seed."""
    from benchmark import harness, spec
    from benchmark.reference import train as ref_train

    model = spec.model(cell["config"])
    corpus_root = root and os.path.join(root, "corpus")
    root = root or harness.run_dir(cell["name"])
    try:
        paths = harness.write_inputs(cell, seed, root, corpus_root)
        weights = {k: v.cpu() for k, v in ref_train.initial_weights(
            model, model.shapes(cell["config"]), seed, device).items()}
        batches = harness.reference_batches(cell, paths, seed,
                                            cell["check_steps"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    reference = _to_cpu(harness.reference_steps(cell, batches, weights, seed,
                                                device))
    out = {}
    for variant in variants:
        if variant == "tf32":
            prog = harness.reference_steps(cell, batches, weights, seed,
                                           device, tf32=True)
        elif variant == "half_batch":
            half = [{k: v[: len(v) // 2] for k, v in b.items()}
                    for b in batches]
            prog = harness.reference_steps(cell, half, weights, seed, device)
        elif variant == "unchanged":
            still = {**cell, "config": {**cell["config"], "recipe": {
                **cell["config"]["recipe"], "lr": 0.0}}}
            prog = harness.reference_steps(still, batches, weights, seed,
                                           device)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        out[variant] = ref_train.compare(_to_cpu(prog), reference, weights)
        del prog
    return out


def _to_cpu(side):
    return {"losses": side["losses"],
            "grad1": {k: v.cpu() for k, v in side["grad1"].items()},
            "params": {k: v.cpu() for k, v in side["params"].items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args(argv)

    from benchmark import spec

    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, args.variants.split(","))
        for variant, numbers in out.items():
            numbers.pop("still_leaves", None)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
