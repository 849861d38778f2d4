"""The shard forward kernels' plan, their plain versions and the shard
op's handling of em, on the CPU (nothing here compiles or launches a
kernel).

``shard_forward_plan`` picks the em ring's depth of the two shard forward
kernels (``csrc/noblank_lattice.cu``, ``csrc/blank_lattice.cu``) from the
lattice width: it must fit the block's shared memory, be one of the depths
the kernels are built for, take every width the shard backward takes, and
refuse a width past its limit before any launch.  The plain versions
``*_shard_forward_plain`` return what the kernels return, ``(alpha, final,
boundary)``; they are held against the JAX package's shard forward (the
Pallas boundary kernel in interpret mode) at rtol/atol 1e-5, the JAX seq
suite's own tolerance (both sides are f32 and differ in the libm of
exp/log1p).  The shard op reads a batch slice of em in place on the card,
so on the CPU it must give the same values and gradients on a slice as on
a contiguous copy.
"""

import numpy as np
import pytest
import torch

from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import dispatch
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops.logspace import BLANK_NEG, NEG_SENTINEL
from ctc_tpu_torch.probes import shard_sweep

TOL = dict(rtol=1e-5, atol=1e-5)
BLANK = {"noblank": False, "blank": True}
BACKWARD = {"noblank": dict(weights=2), "blank": dict(weights=3,
                                                      mask_bytes=1)}
# the widest row of the warps layout, of the 8-row block ring and of the
# 2-row one
WARPS_LIMIT = {"noblank": 768, "blank": 512}
DEPTH8_LIMIT = {"noblank": 5810, "blank": 5669}
LIMIT = {"noblank": 14527, "blank": 13672}
BACKWARD_LIMIT = {"noblank": 5282, "blank": 4385}


def _warps_threads(family, width):
    """One warp up to 32 cells, else warps owning 24 cells (noblank) or 16
    (blank) each, beside their 8 or 16 halo lanes."""
    own = 24 if family == "noblank" else 16
    return 32 if width <= 32 else 32 * -(-width // own)


def _bytes(family, width, depth, threads):
    """The kernels' dynamic shared memory in bytes: in the warps layout a
    thread's ``depth`` ring slots and two exchange rows; in the block
    layout ``2 + depth`` floats (``shard_forward_floats_per_cell``) and
    the blank mask byte per cell."""
    if width <= WARPS_LIMIT[family]:
        return 4 * (depth * threads + 2 * width)
    return width * (4 * (2 + depth) + BLANK[family])


@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("width", [1, 24, 32, 33, 49, 64, 65, "warps",
                                   "block", 1024, 1025, "depth8", "depth2",
                                   "backward", "limit"])
def test_shard_forward_plan_fits_and_takes_the_deepest_ring(family, width):
    width = {"warps": WARPS_LIMIT[family],
             "block": WARPS_LIMIT[family] + 1,
             "depth8": DEPTH8_LIMIT[family],
             "depth2": DEPTH8_LIMIT[family] + 1,
             "backward": BACKWARD_LIMIT[family],
             "limit": LIMIT[family]}.get(width, width)
    depth, threads, smem = lc.shard_forward_plan(width, BLANK[family])
    assert depth in lc.SHARD_DEPTHS
    room = lc.SMEM_LIMIT - lc.SHARD_FORWARD_STATIC_BYTES
    assert smem == _bytes(family, width, depth, threads) <= room
    assert smem == lc.shard_forward_bytes(width, depth, threads,
                                          BLANK[family])
    # no deeper ring would fit
    assert all(_bytes(family, width, d, threads) > room
               for d in lc.SHARD_DEPTHS if d > depth)
    if width <= WARPS_LIMIT[family]:
        assert threads == _warps_threads(family, width) <= 1024
        assert lc.shard_forward_threads(width, BLANK[family]) == threads
    else:
        # the row in whole warps, at most the 1024 threads of a block
        assert lc.shard_forward_threads(width, BLANK[family]) is None
        assert threads == min(-(-width // 32) * 32, 1024)


@pytest.mark.parametrize("family", list(BLANK))
def test_shard_forward_plan_depths_at_their_boundaries(family):
    plan = lambda w: lc.shard_forward_plan(w, BLANK[family])  # noqa: E731
    widths = (1, 64, WARPS_LIMIT[family], WARPS_LIMIT[family] + 1,
              DEPTH8_LIMIT[family], DEPTH8_LIMIT[family] + 1, LIMIT[family])
    assert [plan(w)[0] for w in widths] == [8, 8, 8, 8, 8, 2, 2]
    # the warps layout ends at 32 warps of a block
    assert plan(WARPS_LIMIT[family])[1] == 1024


@pytest.mark.parametrize("family", list(BLANK))
def test_shard_forward_plan_takes_every_width_the_backward_takes(family):
    for width in range(1, BACKWARD_LIMIT[family] + 2):
        try:
            lc.shard_backward_plan(width, **BACKWARD[family])
        except ValueError:
            assert width == BACKWARD_LIMIT[family] + 1
            continue
        assert lc.shard_forward_plan(width, BLANK[family])[0] == 8


@pytest.mark.parametrize("family", list(BLANK))
def test_shard_forward_plan_refuses_wider_rows(family):
    width = LIMIT[family] + 1
    with pytest.raises(ValueError, match=f"width {width}"):
        lc.shard_forward_plan(width, BLANK[family])


@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("entry", ["kernel", "op"])
def test_shard_forward_refuses_the_width_before_any_launch(family, entry):
    """The kernel wrapper, and the shard op on its kernel path, raise on a
    width past the plan before they check or launch anything."""
    width = LIMIT[family] + 1
    em = torch.zeros((2, 1, width))
    lens = torch.ones(1, dtype=torch.int32)
    row = torch.zeros((1, width))
    skip = row.to(torch.uint8)
    counts = lc.launch_counts if family == "noblank" else bl.launch_counts
    before = dict(counts)
    with pytest.raises(ValueError, match=f"width {width}"):
        if family == "noblank" and entry == "kernel":
            lc.noblank_shard_forward_kernel(em, lens, lens, row, row)
        elif family == "noblank":
            lc.NoBlankShardLattice.apply(em, row, row, lens, lens, True)
        elif entry == "kernel":
            bl.blank_shard_forward_kernel(em, skip, lens, lens, row, row)
        else:
            bl.BlankShardLattice.apply(em, row, row, skip, lens, lens, True)
    assert counts == before


# ---------------------------------------------------------------------------
# the plain versions against the JAX shard forward
# ---------------------------------------------------------------------------

# (t_s, B, labels, local input lengths): T past the ring's depth and not a
# multiple of it, T below it, T = 1, W = 1 (blank: L = 0, S = 1); lengths
# below 1, inside the shard and above it
FORWARD_CASES = {
    "T37": (37, 6, 5, [37, 0, 1, 20, 36, 38]),
    "T3": (3, 8, 4, [3, 0, 1, 2, 4, 6, -1, 3]),
    "T1": (1, 4, 3, [1, 0, 2, -1]),
    "W1": (5, 4, 1, [1, 5, 9, 0]),
}


def _rows(rng, batch, width, neg):
    """Random init rows with unreached cells at the sentinel on half the
    samples."""
    rows = [(3.0 * rng.standard_normal((batch, width)) - 8.0).astype(
        np.float32) for _ in range(2)]
    for r in rows:
        r[::2, -1:] = neg
    return rows


def _noblank_case(case):
    T, B, L, lengths = FORWARD_CASES[case]
    rng = np.random.default_rng(21)
    em = (rng.standard_normal((T, B, L)) - 1.0).astype(np.float32)
    r0, r1 = _rows(rng, B, L, NEG_SENTINEL)
    tgt = rng.integers(1, L + 1, size=B).astype(np.int32)
    return em, r0, r1, np.asarray(lengths, np.int32), tgt


def _blank_case(case):
    T, B, L, lengths = FORWARD_CASES[case]
    if case == "W1":
        L = 0
    S = 2 * L + 1
    rng = np.random.default_rng(22)
    logits = torch.tensor(rng.standard_normal((T, B, 7)).astype(np.float32))
    if L:
        targets = rng.integers(1, 7, size=(B, L)).astype(np.int32)
        targets[:, 1::2] = targets[:, 0::2][:, : targets[:, 1::2].shape[1]]
        em, skip = blank_emissions_and_skip(logits, torch.tensor(targets), 0,
                                            normalize=True)
    else:
        em = logits[:, :, :1] - torch.logsumexp(logits, 2, keepdim=True)
        skip = torch.zeros((B, 1), dtype=torch.bool)
    r0, r1 = _rows(rng, B, S, BLANK_NEG)
    tgt = rng.integers(0, L + 1, size=B).astype(np.int32)
    return (em.numpy(), skip.numpy(), r0, r1, np.asarray(lengths, np.int32),
            tgt)


def _jax_triple(run, em, rows, extra):
    """``(alpha, final, boundary)`` of the JAX package's shard forward
    (Pallas, interpret mode) in the pipeline's tlb layout, cut back from
    its padded alpha to em's ``[t_s, B, W]``."""
    import jax.numpy as jnp

    T, B, W = em.shape
    final, boundary, alpha_p = run(
        jnp.transpose(jnp.asarray(em), (0, 2, 1)),
        *map(jnp.asarray, rows), *map(jnp.asarray, extra), "tlb", True,
        None)
    alpha = np.transpose(np.asarray(alpha_p)[:T, :W, :B], (0, 2, 1))
    return alpha, np.asarray(final), np.asarray(boundary)[:, :W]


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_noblank_shard_forward_plain_matches_jax(case):
    from ctc_tpu.ops.lattice_pallas import _run_shard_forward

    em, r0, r1, inl, tgt = _noblank_case(case)
    got = lc.noblank_shard_forward_plain(
        torch.tensor(em), torch.tensor(inl), torch.tensor(tgt),
        torch.tensor(r0), torch.tensor(r1))
    want = _jax_triple(_run_shard_forward, em, (r0, r1), (inl, tgt))
    for name, g, w in zip(("alpha", "final", "boundary"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    # a shard that does not own a sample's final cell gives 0 there
    assert np.all(got[1].numpy()[(inl < 1) | (inl > em.shape[0])] == 0.0)


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_blank_shard_forward_plain_matches_jax(case):
    from ctc_tpu.ops.blank_lattice_pallas import _run_shard_forward

    em, skip, r0, r1, inl, tgt = _blank_case(case)
    got = bl.blank_shard_forward_plain(
        torch.tensor(em), torch.tensor(skip).to(torch.uint8),
        torch.tensor(inl), torch.tensor(tgt), torch.tensor(r0),
        torch.tensor(r1))
    want = _jax_triple(
        lambda e, a, b, *rest: _run_shard_forward(e, a, b, skip, *rest),
        em, (r0, r1), (inl, tgt))
    for name, g, w in zip(("alpha", "final", "boundary"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    assert np.all(got[1].numpy()[(inl < 1) | (inl > em.shape[0])] == 0.0)


# ---------------------------------------------------------------------------
# em as the pipeline hands it in: a batch slice
# ---------------------------------------------------------------------------


def test_rows_layout_keeps_batch_slices_and_copies_other_layouts():
    em = torch.randn((4, 12, 5))
    mb = em[:, 3:6]
    assert not mb.is_contiguous() and lc.rows_layout(mb) is mb
    assert lc.rows_layout(em) is em
    # one sample, one label: any stride of a size-1 axis will do
    assert lc.rows_layout(em[:, 2:3, 1:2]).data_ptr() == em[0, 2, 1].data_ptr()
    for other in (em.transpose(1, 2), em[:, ::2], em[:, :, ::2]):
        got = lc.rows_layout(other)
        assert got.is_contiguous() and torch.equal(got, other)


@pytest.mark.parametrize("family", list(BLANK))
def test_shard_op_on_a_batch_slice_equals_the_op_on_a_copy(family):
    """The op's values, and its gradients with respect to em and both init
    rows, on the second of three batch slices equal those on a contiguous
    copy of that slice."""
    if family == "noblank":
        em, r0, r1, inl, tgt = _noblank_case("T37")
        extra = ()
        op = dispatch.shard_lattice
    else:
        em, skip, r0, r1, inl, tgt = _blank_case("T37")
        extra = (torch.tensor(skip),)
        op = dispatch.blank_shard_lattice
    batch = em.shape[1]
    rng = np.random.default_rng(23)
    wide = np.concatenate([rng.standard_normal(em.shape).astype(np.float32),
                           em, em], axis=1)
    d_final = rng.standard_normal(batch).astype(np.float32)
    d_boundary = rng.standard_normal(r0.shape).astype(np.float32)
    out = {}
    for label in ("slice", "copy"):
        base = torch.tensor(wide).requires_grad_()
        e = base[:, batch:2 * batch]
        if label == "copy":
            e = e.contiguous()
        a, b = (torch.tensor(x).requires_grad_() for x in (r0, r1))
        final, boundary = op(e, a, b, *extra, torch.tensor(inl),
                             torch.tensor(tgt))
        ((final * torch.tensor(d_final)).sum()
         + (boundary * torch.tensor(d_boundary)).sum()).backward()
        out[label] = (final, boundary, base.grad, a.grad, b.grad)
    for name, g, w in zip(("final", "boundary", "d em", "d row 0",
                           "d row 1"), out["slice"], out["copy"]):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    assert torch.all(out["slice"][2][:, :batch] == 0)


# ---------------------------------------------------------------------------
# the forward builds of probes/shard_sweep.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("build", list(shard_sweep.FORWARD_BUILDS))
def test_forward_sweep_builds_change_the_source_where_they_say(family,
                                                               build):
    text = (shard_sweep.cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    got = shard_sweep.variant_source(text, family, build, "forward")
    assert (got == text) == (build == "source")
    for old, new in shard_sweep._EDITS["forward"].get(build, {}).get(
            family, []):
        assert text.count(old) == 1 and got.count(new) >= 1
    if build == "cycles":
        # the clock is read around the steps after step 0, in the warp
        # kernel and in the block kernel
        assert got.count("sweep_clock_read(0);") == 2
        assert got.count("sweep_clock_read(1);") == 2
        assert got.index("sweep_clock_read(0);") < got.index(
            "for (int t = 1; t < T - 1; ++t)")
        assert "sweep_read_clock" in got


def test_parent_cycles_reads_the_clock_around_the_old_step_loop():
    text = ("#include \"cp_async.cuh\"\n"
            "__global__ void k(int T) {\n  for (int t = 0; t < T; ++t) {\n"
            "    __syncthreads();\n  }\n}\n\n// Reverse recursion\n")
    got = shard_sweep.parent_cycles_source(text, "noblank")
    body = got[got.index("__global__"):got.index("// Reverse")]
    assert body.index("sweep_clock_read(0)") < body.index("for (int t")
    assert body.index("sweep_clock_read(1)") > body.rindex("  }\n")
    with pytest.raises(ValueError, match="not once"):
        shard_sweep.parent_cycles_source("", "noblank")
