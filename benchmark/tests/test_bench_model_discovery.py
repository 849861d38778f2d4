"""A model joins the benchmark by new files and entries alone: its
configuration's file names its reference module, and the harness takes
everything particular to the model from that module.  The test plants a
model in a copy of the tree (a module that hands every call to the LSTM
head's and records it), runs a small cell of it on the CPU from that copy,
and sees it correct, every function of the contract called, and no file
that was there changed but ``BENCHMARK.json``."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness, spec
from benchmark.tests.test_bench_discovery import _digests

FUNCTIONS = [n for n in spec.MODEL_CONTRACT if n.islower()]
PLANTED = '''"""A planted model: the LSTM head's, each call recorded."""

from benchmark.reference import lstm_head

CALLS = set()
TIMED = lstm_head.TIMED


def _recorded(name):
    def call(*args, **kwargs):
        CALLS.add(name)
        return getattr(lstm_head, name)(*args, **kwargs)
    return call


''' + "\n".join(f"{n} = _recorded({n!r})" for n in FUNCTIONS) + "\n"


def _plant(root):
    """The planted model's configuration, reference module, traffic,
    workload and ``BENCHMARK.json`` entries, written under ``root``."""
    home = root / "benchmark"
    b = json.loads((root / "BENCHMARK.json").read_text())
    parked = json.loads((home / "parked" / "features-default.json")
                        .read_text())
    conf = json.loads((home / "configs" / "lstm-head-charades.json")
                      .read_text())
    (home / "configs" / "planted-head.json").write_text(json.dumps(
        {**conf, "reference": "planted_head",
         "flags": ["--rgb-arch", "i3d", "--print-train-freq", "1000"]}))
    (home / "reference" / "planted_head.py").write_text(PLANTED)
    (home / "traffic" / "cached-features-small.json").write_text(json.dumps(
        {**json.loads((home / "traffic" / "cached-features.json")
                      .read_text()),
         "train_videos": 40, "val_videos": 10, "warmup_steps": 1,
         "profile_steps": 2}))
    (home / "workloads" / "features-planted.json").write_text(
        (home / "workloads" / "features-default.json").read_text())
    b["configs"].append({**parked["config"], "name": "planted-head",
                         "file": "benchmark/configs/planted-head.json",
                         "why": "a planted model"})
    b["workloads"].append({"name": "features-planted",
                           "config": "planted-head",
                           "traffic": "cached-features-small", "chips": 1,
                           "why": "the planted model on cached features"})
    for m in b["per_layer"]:
        if m["name"] == "mfu":
            m["workloads"].append("features-planted")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_a_planted_model_runs_by_new_files_alone(tmp_path):
    root = tmp_path / "tree"
    root.mkdir()
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    _plant(root)
    code = f"""
import json
from benchmark import harness
from benchmark.reference import planted_head
runs = [harness.run_cell("features-planted", 2**31 + 13, 0.3, trace,
                         device="cpu", root_dir={str(tmp_path / 'run')!r})
        for trace in (False, True)]
print(json.dumps({{"correct": [r["correct"] for r in runs],
                  "checks": [r["checks"] for r in runs],
                  "metrics": [sorted(r["metrics"]) for r in runs],
                  "calls": sorted(planted_head.CALLS),
                  "harness": harness.__file__}}))
"""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(root), str(spec.ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["harness"].startswith(str(root))
    assert last["correct"] == [True, True], last["checks"]
    assert "mfu" in last["metrics"][1]
    assert last["calls"] == sorted(FUNCTIONS)
    after = _digests(root)
    assert {k for k in before if before[k] != after.get(k)} \
        == {"BENCHMARK.json"}


def test_flags_are_appended_to_the_argv_as_given():
    cell = spec.cell("pixels-frozen-resident")
    paths = {k: k for k in ("rgb_data", "train_file", "val_file")}
    argv = harness.cli_argv(cell, paths, 5, "cpu", "/r")
    flags = ["--rgb-arch", "i3d", "--i3d-chunk", "20"]
    cell["config"] = {**cell["config"], "flags": flags}
    assert harness.cli_argv(cell, paths, 5, "cpu", "/r") == argv + flags
