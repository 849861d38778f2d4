"""Cells kept as files but not listed in ``BENCHMARK.json``: a parked
cell's ``benchmark/parked/<cell>.json`` holds the entries it would have
there (its configuration, its workload, the metrics it reports).  The
tests resolve it as the harness resolves a listed cell, from a copy of
``BENCHMARK.json`` with those entries added; the features cell is the one
small enough to run whole on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import spec


def cell(name: str, where: Path) -> dict:
    """Parked cell ``name`` resolved by :func:`benchmark.spec.cell`, with
    ``BENCHMARK.json``'s copy written under ``where``."""
    parked = json.loads((spec.HERE / "parked" / f"{name}.json").read_text())
    b = spec.benchmark()
    b["configs"].append(parked["config"])
    b["workloads"].append(parked["workload"])
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in parked["metrics"] and "workloads" in m:
            m["workloads"].append(name)
    root = Path(where) / "parked-root"
    root.mkdir(parents=True, exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    home = root / b["paths"][0]
    if not home.exists():
        home.symlink_to(spec.HERE, target_is_directory=True)
    return spec.cell(name, root=root)
