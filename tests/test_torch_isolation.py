"""ctc_tpu_torch stands alone: it imports with JAX blocked, none of its
modules names JAX or ctc_tpu in an import, and neither the port nor its
tests call ``.cuda()`` (the session-scoped ``torch_cpu_patch`` fixture
turns ``.cuda()`` into a no-op, so a stray call would pass unnoticed)."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ctc_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return (root in FORBIDDEN_ROOTS or module == "ctc_tpu"
            or module.startswith("ctc_tpu."))


def test_forbidden_predicate():
    assert _forbidden("ctc_tpu") and _forbidden("ctc_tpu.ops.lattice_xla")
    assert _forbidden("jax.numpy") and _forbidden("orbax.checkpoint")
    assert not _forbidden("ctc_tpu_torch.ops")


def test_port_imports_nothing_of_jax_or_ctc_tpu():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(ROOT)}: {m}"
                for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ctc_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import ctc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ctc_tpu_torch.__path__, 'ctc_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25


def test_no_dot_cuda_calls():
    files = _port_files() + sorted((ROOT / "tests").glob("test_torch_*.py"))
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "cuda"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not bad, f"use .to(device), not .cuda(): {bad}"
