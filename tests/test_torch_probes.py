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

import importlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops import probe_cuda as pc
from ctc_tpu_torch.probes import expdomain_fwd, fwd_ops

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_VARIANTS = [*pc.BODIES, "noout", "fwd_log", "fwd_exp", "fwd_exp_renorm"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", CARD_VARIANTS)
@pytest.mark.parametrize("shape", [(128, 1024, 157), (37, 100, 21)],
                         ids=["bench", "edge"])
def test_kernel_matches_plain_on_card(cuda_device, variant, shape):
    T, B, L = shape
    if variant == "noout":
        T -= T % 16  # the carry-only variant needs T % chunk == 0
    if variant.startswith("fwd_"):
        em, outside = expdomain_fwd.make_inputs(T, B, L, cuda_device)
        outside[:, :3] = 1.0  # three samples outside everywhere
        args = (outside, 16) if variant == "fwd_exp_renorm" else (outside,)
        tol = KERNEL_LOG_TOL if variant == "fwd_log" else KERNEL_EXP_TOL
        kernel = getattr(pc, f"probe_{variant}")
        plain = getattr(pc, f"probe_{variant}_plain")
    else:
        em = fwd_ops.make_inputs(T, B, L, cuda_device)
        args = (16,) if variant == "noout" else (variant,)
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
