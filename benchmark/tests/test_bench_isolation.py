"""Nothing that the benchmark runs imports JAX or the JAX package, and the
reference, the corpus and the counts import nothing of the program.  Names
are compared by whole top-level module name (the part before the first
dot), so ``ctc_tpu_torch`` is not taken for ``ctc_tpu``."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import spec

JAX = {"jax", "jaxlib", "flax", "ctc_tpu"}
RUN_FILES = [p for p in spec.HERE.rglob("*.py")
             if "tests" not in p.relative_to(spec.HERE).parts]
STANDALONE = [p for p in RUN_FILES
              if p.relative_to(spec.HERE).parts[0] in
              ("reference", "corpus.py", "counts.py", "metrics", "spec.py",
               "feeds.py", "trace.py")]


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    assert "ctc_tpu_torch".split(".")[0] not in JAX
    assert "ctc_tpu.losses".split(".")[0] in JAX


@pytest.mark.parametrize("path", RUN_FILES,
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_no_module_of_the_run_imports_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", STANDALONE,
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"ctc_tpu_torch"})


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of the features cell on the CPU, at a small size, in a
    process of its own: afterwards ``sys.modules`` holds none of them."""
    code = f"""
import json, sys
from benchmark import harness
from benchmark.tests import parked
cell = parked.cell("features-default", {str(tmp_path)!r})
cell.update(train_videos=40, val_videos=10, warmup_steps=2)
r = harness.run_cell("features-default", 2**31 + 7, 1.0, False,
                     device="cpu", root_dir={str(tmp_path / 'run')!r},
                     cell=cell)
print(json.dumps({{"found": harness.forbidden_modules(),
                  "correct": r["correct"]}}))
"""
    env = {**os.environ, "PYTHONPATH": str(spec.ROOT)}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"found": [], "correct": True}


def test_forbidden_modules_reads_whole_top_level_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "ctc_tpu_torch_fake", object())
    assert "ctc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.forbidden_modules()
