"""ctc_tpu_torch's forward-lattice probes against the JAX probe kernels
themselves (``probe_fwd_ops.py``, ``probe_expdomain_fwd.py``, run in TPU
interpret mode on the CPU), their entry points, and the CUDA kernels
against the plain versions on the card.

The JAX probes size everything from module globals; the helpers set them
to a small shape (T=32, B=128, L=20 -> L_PAD=24, TILE=128, CHUNK=8) with
``monkeypatch``.  Importing ``probe_fwd_ops`` runs its module-level bench,
which fails fast on the CPU (it prints ``FAILED`` lines), so it is imported
once per module.  JAX is imported inside the helpers: the card's machine
has no JAX, and the ``cuda`` tests run there on their own
(``python -m pytest tests/test_torch_probes.py -m cuda``).

Tolerances: log-domain variants rtol/atol 1e-5 (f32 exp/log1p from two
libms); exp-domain variants rtol 1e-5, atol 1e-30 (the values run down
toward denormals, which one side may flush).  On the card each kernel
repeats its plain version's f32 operations in order (no fast-math), so it
is held to rtol 1e-6.
"""

import ctypes
import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops import probe_cuda as pc
from ctc_tpu_torch.probes import (
    expdomain_ab, expdomain_fwd, fwd_ops, ring_sweep, shard_ab,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(T=32, B=128, L=20, L_PAD=24, TILE=128, CHUNK=8)
LOG_TOL = dict(rtol=1e-5, atol=1e-5)
EXP_TOL = dict(rtol=1e-5, atol=1e-30)
KERNEL_LOG_TOL = dict(rtol=1e-6, atol=1e-6)
KERNEL_EXP_TOL = dict(rtol=1e-6, atol=1e-30)
TINY = float(np.finfo(np.float32).tiny)


def _import_root_module(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def jax_fwd_ops():
    return _import_root_module("probe_fwd_ops")


@pytest.fixture(scope="module")
def jax_expdomain():
    return _import_root_module("probe_expdomain_fwd")


def _small_em():
    """The fwd_ops probe's emissions ``[T, L, B]`` at the small shape."""
    return fwd_ops.make_inputs(SMALL["T"], SMALL["B"], SMALL["L"],
                               "cpu").numpy()


def _small_exp_inputs():
    """The exp probe's inputs at the small shape, three samples with every
    row outside (target length 0)."""
    em, outside = expdomain_fwd.make_inputs(SMALL["T"], SMALL["B"],
                                            SMALL["L"], "cpu")
    outside[:, :3] = 1.0
    return em, outside


def _run_jax_fwd_ops(mod, monkeypatch, kind, em):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    for name, value in SMALL.items():
        monkeypatch.setattr(mod, name, value)
    with pltpu.force_tpu_interpret_mode():
        fn = mod.make_noout("lse") if kind == "noout" else mod.make(kind)
        return np.asarray(fn(jnp.asarray(em)))


def _run_jax_expdomain(mod, monkeypatch, kernel_name, em, outside):
    """``probe_expdomain_fwd.build``'s ``pallas_call`` around one of the
    module's kernels, without its TPU compiler parameters."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    for name, value in SMALL.items():
        monkeypatch.setattr(mod, name, value)
    T, B, l_pad, tile, chunk = (SMALL[k] for k in ("T", "B", "L_PAD", "TILE",
                                                   "CHUNK"))
    grid = (B // tile, T // chunk)
    monkeypatch.setattr(mod, "GRID", grid)
    blk_em = (chunk, l_pad, tile)
    # interpret mode is fixed when the call is built
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            getattr(mod, kernel_name),
            out_shape=jax.ShapeDtypeStruct((T, l_pad, B), jnp.float32),
            grid=grid,
            in_specs=[
                pl.BlockSpec(blk_em, lambda i, j: (j, 0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((l_pad, tile), lambda i, j: (0, i),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(blk_em, lambda i, j: (j, 0, i),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((l_pad, tile), jnp.float32)],
        )
        return np.asarray(call(jnp.asarray(em), jnp.asarray(outside)))


@pytest.mark.parametrize("kind", pc.BODIES)
def test_body_plain_matches_jax(jax_fwd_ops, monkeypatch, kind):
    em = _small_em()
    want = _run_jax_fwd_ops(jax_fwd_ops, monkeypatch, kind, em)
    got = pc.probe_body(torch.from_numpy(em), kind).numpy()
    assert got.shape == want.shape == (SMALL["T"], SMALL["L_PAD"],
                                       SMALL["B"])
    np.testing.assert_allclose(got, want, **LOG_TOL)


def test_noout_plain_matches_jax(jax_fwd_ops, monkeypatch):
    em = _small_em()
    want = _run_jax_fwd_ops(jax_fwd_ops, monkeypatch, "noout", em)
    got = pc.probe_noout(torch.from_numpy(em), SMALL["CHUNK"]).numpy()
    assert got.shape == (SMALL["T"] // SMALL["CHUNK"], SMALL["L_PAD"],
                         SMALL["B"])
    np.testing.assert_allclose(got, want, **LOG_TOL)
    # the carry-only output is every CHUNK-th row of the full lse output
    full = pc.probe_body_plain(torch.from_numpy(em), "lse").numpy()
    chunk = SMALL["CHUNK"]
    np.testing.assert_array_equal(got, full[chunk - 1::chunk])


@pytest.mark.parametrize("variant,kernel_name,tol", [
    ("log", "fwd_log_kernel", LOG_TOL),
    ("exp", "fwd_exp_kernel", EXP_TOL),
    ("exp_renorm", "fwd_exp_renorm_kernel", EXP_TOL),
])
def test_expdomain_plain_matches_jax(jax_expdomain, monkeypatch, variant,
                                     kernel_name, tol):
    em, outside = _small_exp_inputs()
    want = _run_jax_expdomain(jax_expdomain, monkeypatch, kernel_name,
                              em.numpy(), outside.numpy())
    if variant == "exp_renorm":
        got = pc.probe_fwd_exp_renorm(em, outside, SMALL["CHUNK"])
    else:
        got = getattr(pc, f"probe_fwd_{variant}")(em, outside)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_log_of_exp_domain_is_the_log_domain():
    em, outside = _small_exp_inputs()
    log_a = pc.probe_fwd_log(em, outside).numpy()
    exp_a = pc.probe_fwd_exp(em, outside).numpy()
    normal = exp_a >= TINY  # finite logs, away from the denormals
    assert normal.mean() > 0.3
    np.testing.assert_allclose(np.log(exp_a[normal]), log_a[normal],
                               **LOG_TOL)
    # every cell outside holds 0 (exp) and the sentinel scale (log)
    out = np.broadcast_to(outside.numpy() > 0.5, exp_a.shape)
    assert np.all(exp_a[out] == 0.0) and np.all(log_a[out] < -1e12)


def test_renorm_rescaled_is_the_exp_domain():
    em, outside = _small_exp_inputs()
    chunk = SMALL["CHUNK"]
    exp_a = pc.probe_fwd_exp(em, outside).numpy().astype(np.float64)
    ren = pc.probe_fwd_exp_renorm(em, outside, chunk).numpy().astype(
        np.float64)
    # the carry after chunk c was divided by the column max of the stored
    # row at that chunk's last step (1 where it is <= 0)
    maxima = ren[chunk - 1::chunk].max(axis=1)  # [T / chunk, B]
    maxima = np.where(maxima > 0, maxima, 1.0)
    scale = np.concatenate([np.ones((1, maxima.shape[1])),
                            np.cumprod(maxima, axis=0)[:-1]])
    rescaled = ren * np.repeat(scale, chunk, axis=0)[:, None, :]
    normal = exp_a >= TINY
    np.testing.assert_allclose(rescaled[normal], exp_a[normal], rtol=1e-5)
    # renormalized, the carry stays far from the denormals
    assert ren[ren > 0].min() > 1e-30 and ren.max() <= 2.0 ** chunk


def test_fwd_log_is_the_noblank_alpha_recursion():
    em, outside = _small_exp_inputs()
    tgt = (outside < 0.5).sum(dim=0)
    got = pc.probe_fwd_log(em, outside)
    want = lc.noblank_alpha_plain(em.transpose(1, 2), tgt).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOG_TOL)


def test_copy_widens_with_zero_rows():
    em = torch.from_numpy(_small_em())
    out = pc.probe_body(em, "copy")
    assert torch.equal(out[:, :SMALL["L"]], em)
    assert torch.equal(out[:, SMALL["L"]:], torch.zeros_like(
        out[:, SMALL["L"]:]))
    assert [pc.pad_rows(n) for n in (1, 8, 9, 20, 157)] == [8, 8, 16, 24, 160]


def test_wrappers_run_the_plain_version_on_cpu_and_kernels_refuse_it():
    em = torch.from_numpy(_small_em())
    ex, outside = _small_exp_inputs()
    before = dict(pc.launch_counts)
    assert torch.equal(pc.probe_body(em, "lse"),
                       pc.probe_body_plain(em, "lse"))
    assert torch.equal(pc.probe_fwd_exp_renorm(ex, outside, 8),
                       pc.probe_fwd_exp_renorm_plain(ex, outside, 8))
    assert pc.launch_counts == before
    # the launchers take CUDA tensors only: no quiet CPU run
    for call in (lambda: pc.probe_body_kernel(em, "copy"),
                 lambda: pc.probe_noout_kernel(em, 8),
                 lambda: pc.probe_fwd_log_kernel(ex, outside),
                 lambda: pc.probe_fwd_exp_kernel(ex, outside),
                 lambda: pc.probe_fwd_exp_renorm_kernel(ex, outside, 8)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert pc.launch_counts == before


def test_operand_checks():
    em = torch.from_numpy(_small_em())
    ex, outside = _small_exp_inputs()
    with pytest.raises(ValueError, match="not a multiple"):
        pc.probe_noout(em[:30], 8)
    with pytest.raises(ValueError, match="at least 1"):
        pc.probe_fwd_exp_renorm(ex, outside, 0)
    with pytest.raises(ValueError, match="unknown probe body"):
        pc.probe_body(em, "lse2")
    with pytest.raises(ValueError, match="outside must be"):
        pc.probe_fwd_log(ex, outside[:-1])
    with pytest.raises(TypeError, match="float32"):
        pc.probe_fwd_log(ex.double(), outside)
    # a T that is not a multiple of the chunk is fine for the renorm
    assert pc.probe_fwd_exp_renorm(ex[:29], outside, 8).shape[0] == 29


@pytest.mark.parametrize("L,want_depth", [
    (157, 8),    # the bench shape: L_PAD 160, 5 KB slots
    (21, 8),     # the edge shape: L_PAD 24
    (720, 8),    # the widest L_PAD eight slots take beside the carry
    (721, 2),    # L_PAD 728: seven would fit, so the plan takes two
    (1000, 2),
    (1500, 2),   # the ring-edge shape: L_PAD 1504
    (1816, 2),   # the widest L_PAD a two-slot ring takes, to the byte
])
def test_ring_plan(L, want_depth):
    l_pad = pc.pad_rows(L)
    depth, smem = pc.ring_plan(l_pad)
    assert depth == want_depth
    # the ring and the carry's double buffer, [L_PAD, 8] f32 each slot
    slot = l_pad * 8 * 4
    assert smem == (depth + 2) * slot <= pc.SMEM_LIMIT == 232_448
    # Little's law: >= ~23 KB of em in flight per SM (depth - 1 slots) at
    # every L_PAD from the bench shape's up
    if l_pad >= 160:
        assert (depth - 1) * slot >= 23_000
    if L == 1816:
        assert smem == pc.SMEM_LIMIT


@pytest.mark.parametrize("l_pad", [1824, 2048, 8192])
def test_ring_plan_refuses(l_pad):
    # not even two slots fit beside the carry
    with pytest.raises(ValueError, match="shared memory"):
        pc.ring_plan(l_pad)


def test_wide_rows_refused_before_any_launch():
    # L_PAD 1824: the plan refuses before the operand checks and the build
    em = torch.zeros((2, 1817, 3))
    before = dict(pc.launch_counts)
    for call in (lambda: pc.probe_body_kernel(em, "copy"),
                 lambda: pc.probe_noout_kernel(em, 2)):
        with pytest.raises(ValueError, match="does not fit"):
            call()
    assert pc.launch_counts == before
    # the plain version has no such limit
    assert pc.probe_body(em, "add").shape == (2, 1824, 3)


# L_PAD -> row 10's ring depth for log, exp and exp_renorm; None: refused
@pytest.mark.parametrize("l_pad,want", [
    (8, (0, 8, 8)),     # log reads em in the step below L_PAD 64
    (56, (0, 8, 8)),
    (64, (8, 8, 8)),
    (160, (8, 8, 8)),   # the bench shape
    (720, (8, 8, 8)),   # the widest eight slots take, partials and all
    (728, (2, 2, 2)),
    (1808, (2, 2, 2)),  # exp_renorm's widest two-slot ring, to the byte
    (1816, (2, 2, 0)),  # the others' widest; exp_renorm reads em in the step
    (1824, (0, 0, 0)),
    (2408, (0, 0, 0)),  # the widest the first row-10 kernel took
    (2416, None),
])
def test_expdomain_plan(l_pad, want):
    slot = l_pad * 8 * 4
    assert pc.PARTIAL_BYTES == 1024 and pc.EXPDOMAIN_KINDS == (
        "log", "exp", "exp_renorm")
    for i, kind in enumerate(pc.EXPDOMAIN_KINDS):
        if want is None:
            with pytest.raises(ValueError, match="2408"):
                pc.expdomain_plan(l_pad, kind)
            continue
        depth, smem = pc.expdomain_plan(l_pad, kind)
        assert depth == want[i]
        # the carry's double buffer, the ring, and exp_renorm's two
        # buffers of 16 warps x 8 column maxima
        extra = 2 * 16 * 8 * 4 if kind == "exp_renorm" else 0
        assert smem == (depth + 2) * slot + extra <= pc.SMEM_LIMIT
        if depth:  # row 9's ring, beside the partials
            assert (depth, smem - extra) == pc.ring_plan(l_pad)
        elif kind != "log" or l_pad >= 64:  # no ring fits
            assert 4 * slot + extra > pc.SMEM_LIMIT
    if l_pad == 1816:
        assert pc.expdomain_plan(l_pad, "exp")[1] == pc.SMEM_LIMIT
    if l_pad == 1808:
        assert pc.expdomain_plan(l_pad, "exp_renorm")[1] == pc.SMEM_LIMIT
    with pytest.raises(ValueError, match="unknown row-10 kind"):
        pc.expdomain_plan(l_pad, "fwd_log")


@pytest.mark.parametrize("batch,depth,offset,want", [
    (1024, 8, 0, True),
    (100, 8, 0, True),    # B a multiple of 4: rows of whole 16-byte pieces
    (21, 8, 0, False),
    (1024, 2, 0, False),  # two slots: 4-byte copies
    (1024, 0, 0, False),
    (1024, 8, 1, False),  # em's base not 16-byte aligned
])
def test_tensor_copies(batch, depth, offset, want):
    flat = torch.zeros(3 * 24 * batch + 4)
    start = (-flat.data_ptr() // 4) % 4 + offset  # 16-byte aligned + offset
    em = flat[start:start + 3 * 24 * batch].view(3, 24, batch)
    assert pc.tensor_copies(em, depth) is want


def test_expdomain_wide_rows_refused_before_any_launch():
    em = torch.zeros((2, 2416, 3))
    outside = torch.zeros((2416, 3))
    before = dict(pc.launch_counts)
    for call in (lambda: pc.probe_fwd_log_kernel(em, outside),
                 lambda: pc.probe_fwd_exp_kernel(em, outside),
                 lambda: pc.probe_fwd_exp_renorm_kernel(em, outside, 4)):
        with pytest.raises(ValueError, match="rows up to 2408"):
            call()
    assert pc.launch_counts == before
    # the plain version has no such limit
    assert pc.probe_fwd_exp(em, outside).shape == (2, 2416, 3)


def test_fwd_probes_takes_cp_async_from_the_header():
    text = (cuda_build.CSRC / "fwd_probes.cu").read_text()
    assert '#include "cp_async.cuh"' in text
    # no cp.async helper of its own: no inline PTX, no shared-window cast
    for own in ("asm", "__cvta_generic_to_shared", "cp_async4",
                "cp_async_commit", "cp_async_wait"):
        assert own not in text, own
    # the library's name hashes the header too, so an edit there rebuilds
    digest = cuda_build.library_path("fwd_probes.cu")
    assert digest.parent == cuda_build.BUILD_DIR


def test_expdomain_ab_needs_a_parent_and_the_card(tmp_path):
    with pytest.raises(SystemExit):
        expdomain_ab.main([])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs there")
    with pytest.raises(RuntimeError, match="is_available"):
        expdomain_ab.main(["--parent", str(tmp_path)])


# the parent's row-10 launchers (fwd_probes.cu before the redesign)
OLD_EXPDOMAIN_LAUNCHERS = {
    "probe_fwd_log": "probe_fwd_log(const float* em, const float* outside, "
                     "float* out, int T, int L_pad, int B, "
                     "cudaStream_t stream)",
    "probe_fwd_exp": "probe_fwd_exp(const float* em, const float* outside, "
                     "float* out, int T, int L_pad, int B, "
                     "cudaStream_t stream)",
    "probe_fwd_exp_renorm": "probe_fwd_exp_renorm(const float* em, "
                            "const float* outside, float* out, int T, "
                            "int L_pad, int B, int chunk, "
                            "cudaStream_t stream)",
}


@pytest.mark.parametrize("name", list(OLD_EXPDOMAIN_LAUNCHERS))
def test_expdomain_ab_types_the_earlier_launchers(name):
    decl = OLD_EXPDOMAIN_LAUNCHERS[name]
    params = decl[decl.index("(") + 1:-1].split(",")
    want = tuple(ctypes.c_void_p if "*" in q or "cudaStream_t" in q
                 else ctypes.c_int for q in params)
    assert expdomain_ab.OLD_SIGNATURES[name] == want
    # this tree's launchers take the ring's depth and bytes before the
    # stream
    new = cuda_build.SIGNATURES["fwd_probes.cu"][name]
    assert new == (*want[:-1], ctypes.c_int, ctypes.c_int, want[-1])


def test_expdomain_ab_builds_the_parent_source(tmp_path, monkeypatch):
    csrc = tmp_path / "ctc_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "fwd_probes.cu").write_text("// parent\n")
    commands = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **_):
            commands.append(cmd)

        def communicate(self):
            return "", None

    class Lib:
        def __init__(self, path):
            self.path = path
            for name in OLD_EXPDOMAIN_LAUNCHERS:
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    monkeypatch.setattr(shard_ab, "PARENT_BUILD", tmp_path / "out")
    lib = expdomain_ab.build_old(tmp_path)
    assert lib.path.endswith("fwd_probes_expdomain_ab.so")
    for name, argtypes in expdomain_ab.OLD_SIGNATURES.items():
        fn = getattr(lib, name)
        assert tuple(fn.argtypes) == argtypes and fn.restype is ctypes.c_int
    (cmd,) = commands
    assert f"-I{csrc}" in cmd and str(csrc / "fwd_probes.cu") in cmd


@pytest.mark.parametrize("variant", expdomain_ab.VARIANTS)
def test_expdomain_ab_passes_the_earlier_argument_order(monkeypatch,
                                                        variant):
    calls = []
    name = f"probe_{variant}"
    lib = type("Lib", (), {name: staticmethod(
        lambda *args: calls.append(args) or 0)})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    em, outside = expdomain_fwd.make_inputs(5, 3, 9, "cpu")
    out = expdomain_ab.old_call(lib, variant, em, outside, chunk=4)()
    (args,) = calls
    assert args[:3] == (em.data_ptr(), outside.data_ptr(), out.data_ptr())
    chunk = (4,) if variant == "fwd_exp_renorm" else ()
    assert args[3:] == (5, 16, 3, *chunk, 7)


def test_expdomain_ab_shapes_reach_every_layout():
    for kind in ("exp", "exp_renorm"):
        plans = {label: pc.expdomain_plan(pc.pad_rows(shape[2]), kind)[0]
                 for label, shape in expdomain_ab.SHAPES.items()}
        assert plans == {"bench": 8, "edge": 8, "ring_edge": 2,
                         "past_ring": 0}
    plans = {label: pc.expdomain_plan(pc.pad_rows(shape[2]), "log")[0]
             for label, shape in expdomain_ab.SHAPES.items()}
    assert plans == {"bench": 8, "edge": 0, "ring_edge": 2, "past_ring": 0}
    assert expdomain_ab.SHAPES["bench"] == (128, 1024, 157)


def test_expdomain_ab_main_runs_every_shape_and_variant(monkeypatch):
    calls = []
    monkeypatch.setattr(expdomain_ab, "resolve_device", lambda d: None)
    monkeypatch.setattr(expdomain_ab, "card_line", lambda: "card")
    monkeypatch.setattr(expdomain_ab, "build_old", lambda parent: "lib")
    monkeypatch.setattr(expdomain_ab, "compare",
                        lambda v, label, lib, card: calls.append((label, v))
                        or [{"variant": v}])
    for part in ("layouts", "sweep"):
        monkeypatch.setattr(expdomain_ab, part,
                            lambda lib, card, part=part: calls.append(part)
                            or [])
    monkeypatch.setattr(expdomain_ab, "cycles",
                        lambda card: calls.append("cycles") or [])
    rows = expdomain_ab.main(["--parent", "x", "--layouts", "--cycles"])
    assert calls == [(label, v) for label in expdomain_ab.SHAPES
                     for v in expdomain_ab.VARIANTS] + ["layouts", "cycles"]
    assert len(rows) == 12


def test_expdomain_ab_cycles_build_adds_only_clock_reads():
    text = (cuda_build.CSRC / "fwd_probes.cu").read_text()
    built = expdomain_ab.cycles_source(text)
    # every line of the source stays, in order, between the added ones
    it = iter(built.splitlines())
    assert all(line in it for line in text.splitlines())
    assert built.count("clock64()") == 8
    assert 'extern "C" int read_cycles(long long* out)' in built
    # row 9's kernel is untouched
    start = text.index("fwd_ops_kernel(")
    end = text.index("struct CellRing")
    assert text[start:end] in built
    with pytest.raises(ValueError, match="not one line"):
        expdomain_ab.cycles_source(text.replace("namespace {\n", ""))


def test_expdomain_ab_moves_em_off_16_bytes():
    em, _ = expdomain_fwd.make_inputs(3, 8, 21, "cpu")
    moved = expdomain_ab.off_by_4(em)
    assert torch.equal(moved, em) and moved.is_contiguous()
    assert moved.data_ptr() % 16 == 4
    assert pc.tensor_copies(em, 8) and not pc.tensor_copies(moved, 8)
    # each layout's bytes as the plan counts them
    for variant, kind in zip(expdomain_ab.VARIANTS, pc.EXPDOMAIN_KINDS):
        for l_pad in (24, 160, 1504):
            depth, smem = pc.expdomain_plan(l_pad, kind)
            assert expdomain_ab.ring_bytes(variant, l_pad, depth) == smem


@pytest.mark.parametrize("module,labels", [
    ("fwd_ops", [*pc.BODIES, fwd_ops.NOOUT]),
    ("expdomain_fwd", ["log (baseline)", "exp-domain", "exp+chunk-renorm"]),
])
def test_entry_point_on_cpu(module, labels):
    proc = subprocess.run(
        [sys.executable, "-m", f"ctc_tpu_torch.probes.{module}",
         "--device", "cpu", "--shape", "16,8,5", "--iters", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    text, rows = lines[:len(labels)], [json.loads(x)
                                       for x in lines[len(labels):]]
    assert [r["variant"] for r in rows] == labels
    for line, row in zip(text, rows):
        assert line.startswith(row["variant"]) and "cells/s" in line
        assert row["launches"] == 0 and row["max_abs_dev"] is None
        assert row["shape_TBL"] == [16, 8, 5] and row["l_pad"] == 8
        assert row["device"] == "cpu" and row["ms"] > 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for main in (fwd_ops.main, expdomain_fwd.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--shape", "16,8,5", "--iters", "1"])
    with pytest.raises(SystemExit):
        fwd_ops.main(["--device", "cpu", "--shape", "20,8,5"])


@pytest.mark.parametrize("build,old", [
    ("rows32", "constexpr int kRingRows = 64;"),
    ("rows80", "constexpr int kRingRows = 64;"),
    ("rows128", "constexpr int kRingRows = 64;"),
    ("noload", "cp_async::copy4(slot + k * kRowStep, p);"),
    ("nostore", "if (store) *o = v;"),
])
def test_ring_sweep_build_changes_one_line(build, old):
    text = (cuda_build.CSRC / "fwd_probes.cu").read_text()
    for same in ("rows64", "depth2"):
        assert ring_sweep.variant_source(text, same) == text
    lines = text.splitlines()
    edited = ring_sweep.variant_source(text, build).splitlines()
    changed = [(a, b) for a, b in zip(lines, edited) if a != b]
    assert len(edited) == len(lines) and len(changed) == 1
    line, edit = changed[0]
    assert old in line and old not in edit
    if build.startswith("rows"):
        assert f"kRingRows = {build[4:]};" in edit
    else:
        assert edit.strip() == ""


@pytest.mark.parametrize("build", ["rows0", "rows129", "rows", "rowsx",
                                   "bogus"])
def test_ring_sweep_refuses_an_unknown_build(build):
    text = (cuda_build.CSRC / "fwd_probes.cu").read_text()
    with pytest.raises(ValueError, match=build):
        ring_sweep.variant_source(text, build)
    # an edit must find its line exactly once
    with pytest.raises(ValueError, match="not one line"):
        ring_sweep.variant_source("", "noload")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


EXP_VARIANTS = ["fwd_log", "fwd_exp", "fwd_exp_renorm"]
CARD_VARIANTS = [*pc.BODIES, "noout", *EXP_VARIANTS]
CARD_SHAPES = {
    "bench": (128, 1024, 157), "edge": (37, 100, 21),
    # the em ring (8 slots at L_PAD 160): fewer steps than slots, one more
    # step than slots, 21 samples (lanes masked, rows of 84 bytes, not
    # 16-byte aligned), and L_PAD 1504 and 1000, where only two fit
    "T1": (1, 64, 157), "T3": (3, 64, 157), "T9": (9, 64, 157),
    "B21": (40, 21, 157), "wide_L": (5, 21, 1500), "T1_wide_L": (1, 21, 1000),
}
# row 10 past its ring: L_PAD 2000, em read inside the step (row 9 refuses
# it: test_wide_rows_refused_before_any_launch)
CARD_CASES = [pytest.param(variant, shape, id=f"{label}-{variant}")
              for label, shape in CARD_SHAPES.items()
              for variant in CARD_VARIANTS] + [
    pytest.param(variant, (3, 21, 2000), id=f"past_ring-{variant}")
    for variant in EXP_VARIANTS]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,shape", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, variant, shape):
    T, B, L = shape
    chunk = min(16, T)
    if variant == "noout":
        T -= T % chunk  # the carry-only variant needs T % chunk == 0
    if variant.startswith("fwd_"):
        em, outside = expdomain_fwd.make_inputs(T, B, L, cuda_device)
        outside[:, :3] = 1.0  # three samples outside everywhere
        args = (outside, 16) if variant == "fwd_exp_renorm" else (outside,)
        tol = KERNEL_LOG_TOL if variant == "fwd_log" else KERNEL_EXP_TOL
        kernel = getattr(pc, f"probe_{variant}")
        plain = getattr(pc, f"probe_{variant}_plain")
    else:
        em = fwd_ops.make_inputs(T, B, L, cuda_device)
        args = (chunk,) if variant == "noout" else (variant,)
        tol = KERNEL_LOG_TOL
        kernel = pc.probe_noout if variant == "noout" else pc.probe_body
        plain = (pc.probe_noout_plain if variant == "noout"
                 else pc.probe_body_plain)
    name = f"probe_{variant}"
    before = pc.launch_counts[name]
    got = kernel(em, *args)
    want = plain(em, *args)
    torch.cuda.synchronize()
    assert pc.launch_counts[name] == before + 1
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [
    ((37, 100, 21), 16),   # the chunk does not divide T
    ((37, 21, 157), 16),   # 21 samples: lanes masked, the last block partial
    ((37, 21, 157), 1),    # every step renormalizes: both partial buffers
    ((40, 21, 157), 3),
    ((9, 21, 1500), 2),    # a two-slot ring
    ((5, 21, 2000), 1),    # em read inside the step
], ids=["edge", "B21", "B21_chunk1", "B21_chunk3", "ring2", "past_ring"])
def test_renorm_matches_plain_on_card(cuda_device, shape, chunk):
    em, outside = expdomain_fwd.make_inputs(*shape, cuda_device)
    outside[:, :3] = 1.0
    got = pc.probe_fwd_exp_renorm(em, outside, chunk)
    want = pc.probe_fwd_exp_renorm_plain(em, outside, chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **KERNEL_EXP_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", EXP_VARIANTS)
@pytest.mark.parametrize("batch", [21, 24])  # 4-byte / tensor copies at 8
def test_expdomain_every_layout_on_card(cuda_device, variant, batch):
    # one shape through each depth the launcher takes, all equal bit for
    # bit (the same f32 operations in the same order)
    em, outside = expdomain_fwd.make_inputs(20, batch, 157, cuda_device)
    outside[:, :3] = 1.0
    name = f"probe_{variant}"
    chunk = (3,) if variant == "fwd_exp_renorm" else ()
    extra = pc.PARTIAL_BYTES if chunk else 0
    slot = em.shape[1] * 8 * 4
    assert pc.tensor_copies(em, 8) is (batch % 4 == 0)
    outs = [pc._expdomain_kernel(name, em, outside, *chunk,
                                 plan=(depth, (depth + 2) * slot + extra))
            for depth in (0, 2, 8)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    want = getattr(pc, f"{name}_plain")(em, outside, *chunk)
    tol = KERNEL_LOG_TOL if variant == "fwd_log" else KERNEL_EXP_TOL
    np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                               **tol)
    # the launcher refuses another depth, and too few bytes for its ring
    for plan in ((4, 6 * slot + extra), (8, 10 * slot + extra - 4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            pc._expdomain_kernel(name, em, outside, *chunk, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", EXP_VARIANTS)
@pytest.mark.parametrize("shape,offset", [
    ((5, 64, 700), 0),   # L_PAD 704: three boxes, the last overlapping
    ((3, 12, 300), 0),   # the last block's upper 4 lanes past B, read as 0
    ((9, 64, 157), 1),   # em's base not 16-byte aligned: 4-byte copies
], ids=["boxes3", "B12", "unaligned"])
def test_expdomain_tensor_copies_on_card(cuda_device, variant, shape, offset):
    T, B, L = shape
    em, outside = expdomain_fwd.make_inputs(T, B, L, cuda_device)
    outside[:, :3] = 1.0
    if offset:  # the same em at a 4-byte offset
        flat = torch.empty(em.numel() + 4, device=cuda_device)
        em = flat[offset:offset + em.numel()].view(em.shape).copy_(em)
    name = f"probe_{variant}"
    chunk = (3,) if variant == "fwd_exp_renorm" else ()
    assert pc.tensor_copies(em, 8) is not offset
    extra = pc.PARTIAL_BYTES if chunk else 0
    slot = em.shape[1] * 8 * 4
    got = pc._expdomain_kernel(name, em, outside, *chunk,
                               plan=(8, 10 * slot + extra))
    want = getattr(pc, f"{name}_plain")(em, outside, *chunk)
    torch.cuda.synchronize()
    tol = KERNEL_LOG_TOL if variant == "fwd_log" else KERNEL_EXP_TOL
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
