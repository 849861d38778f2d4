"""Finding a cell's parts by name.

``BENCHMARK.json`` lists the cells, configurations and metrics.  A traffic
mix is ``traffic/<traffic>.json`` (the feed, the batch, the corpus and the
steps around the window), a cell's own limits for the check are
``workloads/<cell>.json``, a configuration is the file its entry names, and
a per-layer metric is read by ``metrics/<metric>.py``.  Adding a
cell, a configuration or a metric adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its entry in ``BENCHMARK.json`` with its traffic
    file's keys, its configuration (``"config"``, with the entry's keys and
    its file's) and the metrics it reports (``"end_to_end"``,
    ``"per_layer"``)."""
    spec = benchmark(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    home = root / spec["paths"][0]
    traffic = json.loads((home / "traffic"
                          / f"{entry['traffic']}.json").read_text())
    own = json.loads((home / "workloads" / f"{name}.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = {**json.loads((root / conf["file"]).read_text()), **conf}

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {**traffic, **own, **entry, "config": config,
            "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
            "per_layer": [m for m in spec["per_layer"] if reports(m)]}


def reader(metric: str, root: Path = ROOT):
    """The module that reads per-layer metric ``metric``:
    ``metrics/<metric>.py``, with ``read(record)`` returning the value or
    None where the record holds nothing to read."""
    path = root / benchmark(root)["paths"][0] / "metrics" / f"{metric}.py"
    module_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module
