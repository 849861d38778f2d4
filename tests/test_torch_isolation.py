"""ctc_tpu_torch stands alone: it imports with JAX blocked, none of its
modules names JAX or ctc_tpu in an import, and neither the port nor its
tests call ``.cuda()`` (the session-scoped ``torch_cpu_patch`` fixture
turns ``.cuda()`` into a no-op, so a stray call would pass unnoticed)."""

import ast
import pathlib
import subprocess
import sys

import pytest

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


# the data axis's modules (ctc_tpu/parallel's port), named so that a module
# of them that goes missing fails here rather than drops out of the walk
PARALLEL_MODULES = ("mesh", "collectives", "launch", "steps",
                    "class_sharded", "seq_lattice")


@pytest.mark.parametrize("name", PARALLEL_MODULES)
def test_parallel_module_stands_alone(name):
    """No JAX or ctc_tpu import, and no public function defaulting to the
    CPU (``make_mesh``, ``init_distributed`` and the launcher included)."""
    path = PORT / "parallel" / f"{name}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not list(_cpu_device_defaults(tree))


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
    assert int(proc.stdout.split()[-1]) >= 76


def _cpu_device_defaults(tree):
    """``name:line`` of every public function (or dunder method) with a
    ``device`` parameter, and every class field ``device``, whose default
    is the string ``"cpu"``: an entry point runs on the card unless the
    caller asks for the CPU."""
    def is_cpu(node):
        return (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.split(":")[0] == "cpu")

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            name = node.name
            if name.startswith("_") and not name.endswith("__"):
                continue
            a = node.args
            positional = a.posonlyargs + a.args
            pairs = list(zip(positional[len(positional) - len(a.defaults):],
                             a.defaults))
            pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            if any(arg.arg == "device" and is_cpu(d) for arg, d in pairs):
                yield f"{name}:{node.lineno}"
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if (isinstance(item, ast.AnnAssign)
                        and isinstance(item.target, ast.Name)
                        and item.target.id == "device" and is_cpu(item.value)):
                    yield f"{node.name}.device:{item.lineno}"


def test_cpu_device_default_predicate():
    tree = ast.parse(
        "def make_seq_mesh(n, device='cpu'): pass\n"
        "def f(*, device='cpu:0'): pass\n"
        "def _private(device='cpu'): pass\n"
        "def g(n, device='cuda', other='cpu'): pass\n"
        "class C:\n"
        "    def __init__(self, device='cpu'): pass\n"
        "    device: str = 'cpu'\n"
    )
    assert sorted(_cpu_device_defaults(tree)) == [
        "C.device:7", "__init__:6", "f:2", "make_seq_mesh:1"]


def test_no_public_function_defaults_to_the_cpu():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(ROOT)}: {hit}"
                for hit in _cpu_device_defaults(tree)]
    assert not bad, f"entry points default to cuda: {bad}"


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
