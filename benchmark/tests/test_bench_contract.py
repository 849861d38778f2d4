"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell
resolves to its configuration, its traffic and its metric readers by name.
"""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import spec

ROOT = spec.ROOT
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]
PARKED = [json.loads(p.read_text())["config"]
          for p in sorted((spec.HERE / "parked").glob("*.json"))]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(B["command"]) <= 32
    assert all(_line(word) for word in B["command"])
    assert not any(w.startswith("/") or ".." in w for w in B["command"])


def test_run_seconds_fit_a_full_check():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", B["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    widths = ("hidden", "intermediate", "latent", "state", "projection",
              "head", "expansion")
    assert not any(k.endswith(("_dim", "_rank")) or k.startswith(widths)
                   for k in entry["reduced"])
    path = ROOT / entry["file"]
    assert path.is_file() and str(Path(entry["file"]).parts[0]) in B["paths"]
    assert any(w["config"] == entry["name"] for w in B["workloads"])
    assert sum(c["file"] == entry["file"] for c in B["configs"]) == 1


@pytest.mark.parametrize("entry", B["configs"] + PARKED,
                         ids=lambda c: c["name"])
def test_configs_name_a_reference_module_with_the_whole_contract(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["reference"].isidentifier()
    assert (spec.HERE / "reference" / f"{conf['reference']}.py").is_file()
    model = spec.model(conf)
    for name in spec.MODEL_CONTRACT:
        assert hasattr(model, name), name
        assert name.isupper() or callable(getattr(model, name)), name
    assert model.TIMED is None or isinstance(model.TIMED, str)
    flags = conf.get("flags", [])
    assert isinstance(flags, list) and all(isinstance(f, str) and _line(f)
                                           for f in flags)
    shapes = model.shapes(conf)
    assert shapes
    for name, shape in shapes.items():
        kind, fan_in = model.init(name, shape)
        assert kind in ("kernel", "ones", "zeros"), name
        assert (fan_in >= 1) if kind == "kernel" else fan_in is None
        for finetune in (False, True):
            assert model.optimizer(name, finetune) in (None, "adam", "sgd")
    assert any(model.optimizer(n, False) for n in shapes)
    offsets = model.clip_offsets(conf)
    assert offsets is None or (offsets and all(
        isinstance(o, int) and o >= 0 for o in offsets))


@pytest.mark.parametrize("cell", CELLS)
def test_cells(cell):
    entry = next(w for w in B["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    assert len(entry["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1
    resolved = spec.cell(cell)
    names = {m["name"] for m in resolved["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert resolved["per_layer"]
    for key in ("feed", "batch_size", "train_videos", "check_steps",
                "warmup_steps", "profile_steps", "limits"):
        assert key in resolved


def test_names_are_unique_and_well_formed():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metrics(metric):
    per_layer = metric in B["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"}
            if per_layer else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        moves = next(m for m in B["end_to_end"]
                     if m["name"] == metric["moves"])
        for cell in metric.get("workloads", CELLS):
            assert cell in moves.get("workloads", CELLS)
        reader = spec.reader(metric["name"])
        assert callable(reader.read)
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            metric["layer"], metric["unit"], metric["moves"])
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert not math.isnan(metric["bound"])


def test_layers_have_one_spelling():
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_under_paths_are_named_from_name_characters():
    for p in B["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert all(NAME.match(part) for part in rel.split("/")), rel
