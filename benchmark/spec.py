"""Finding a cell's parts by name.

``BENCHMARK.json`` lists the cells, configurations and metrics.  A traffic
mix is ``traffic/<traffic>.json`` (the feed, the batch, the corpus and the
steps around the window), a cell's own limits for the check are
``workloads/<cell>.json``, a configuration is the file its entry names, and
a per-layer metric is read by ``metrics/<metric>.py``.  A configuration's
file names its model's reference module (``"reference"``:
``reference/<name>.py``, which provides :data:`MODEL_CONTRACT`) and may
give the program's model flags (``"flags"``, appended to its argv as
given).  Adding a cell, a configuration, a model or a metric adds files
and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: what a configuration's reference module provides, all that a run needs
#: of its model:
#: ``shapes(conf)``: ``{reference name: shape}`` of its leaves and buffers,
#: in the order of the initial weights' draw;
#: ``init(name, shape)``: ``("kernel", fan_in)``, ``("ones", None)`` or
#: ``("zeros", None)``;
#: ``optimizer(name, finetune)``: ``"adam"``, ``"sgd"`` or None (not
#: trained);
#: ``ref_name(name)``: the reference name of a program state-dict entry;
#: ``clip_offsets(conf)``: frame offsets from a step's anchor that make
#: one clip, or None where a step's inputs are cached features;
#: ``loss(p, batch, *, finetune, keep, generator)``: the scalar training
#: loss of a batch under the leaves ``p``, dropout drawn from
#: ``generator``;
#: ``step_flops(cell)``: the model FLOPs of one train step;
#: ``TIMED``: the attribute of the program's model whose forward the
#: traced run times, or None.
MODEL_CONTRACT = ("shapes", "init", "optimizer", "ref_name", "clip_offsets",
                  "loss", "step_flops", "TIMED")


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


def model(conf: dict):
    """The reference module of configuration ``conf`` (a cell's
    ``"config"``): ``reference/<conf["reference"]>.py``."""
    name = conf["reference"]
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is not a module name")
    return importlib.import_module(f"{__package__}.reference.{name}")
