"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and new entries only: the harness finds them by name, and no
file that was there changes."""

import hashlib
import json
import shutil

from benchmark import spec


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in root.rglob("*") if p.is_file() and "__pycache__" not in
        p.parts}


def test_new_cell_config_and_metric_are_found_without_edits(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    home = tmp_path / "benchmark"
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (home / "configs" / "lstm-head-charades-wide.json").write_text(
        json.dumps({**json.loads((home / "configs"
                                  / "lstm-head-charades.json").read_text()),
                    "hidden": 157}))
    (home / "traffic" / "cached-features-b64.json").write_text(json.dumps(
        {**json.loads((home / "traffic" / "cached-features.json")
                      .read_text()), "batch_size": 64}))
    (home / "workloads" / "features-wide.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-5}}))
    (home / "metrics" / "steps_in_window.py").write_text(
        'LAYER = "train"\nUNIT = "steps"\nMOVES = "train_windows_per_s"\n\n'
        'def read(record):\n    return record.get("window_steps")\n')
    b["configs"].append({"name": "lstm-head-charades-wide",
                         "source": "https://github.com/gotaku6629/CTC",
                         "file": "benchmark/configs/"
                                 "lstm-head-charades-wide.json",
                         "reduced": [], "why": "a wider head"})
    b["workloads"].append({"name": "features-wide",
                           "config": "lstm-head-charades-wide",
                           "traffic": "cached-features-b64", "chips": 1,
                           "why": "B=64 on cached features"})
    b["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "train", "moves": "train_windows_per_s",
                           "workloads": ["features-wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.cell("features-wide", root=tmp_path)
    assert cell["batch_size"] == 64 and cell["config"]["hidden"] == 157
    assert cell["limits"] == {"loss_gap": 1e-5}
    assert [m["name"] for m in cell["per_layer"]] == ["steps_in_window"]
    assert spec.reader("steps_in_window", root=tmp_path).read(
        {"window_steps": 7}) == 7
    # the cells that were there resolve as before
    for name in [w["name"] for w in b["workloads"][:-1]]:
        assert spec.cell(name, root=tmp_path) == spec.cell(name)
    after = _digests(tmp_path)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
