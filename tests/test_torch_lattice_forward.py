"""The whole-lattice forward kernels' plan, on the CPU, the plain NLL
against the JAX package's, and the kernels against their plain versions on
the card (``-m cuda``).

``forward_plan`` picks the layout of the two whole-lattice forward kernels
(``csrc/noblank_lattice.cu``, ``csrc/blank_lattice.cu``) from the lattice
width: the warp layout up to 32 cells, the pairs layout up to 1024, the
block layout while its em ring (8 rows, then 2) fits, then the rows
layout, up to the widest row the first kernels took (their two carried
rows in 227 KB), and a refusal past it before any launch.  Its
shared bytes must be the kernels' own layout formula, and the launchers
build exactly the plans it makes.  The kernels write the NLL beside alpha,
so the op no longer runs ``gather_nll`` on the kernel path.  The A/B
probe's parent build types the earlier tree's launchers, whose parameter
lists are quoted below from that tree.

Against the JAX package (imported inside the tests: the card's machine has
no JAX), the plain NLL of both families equals the XLA scan everywhere and
the Pallas kernel in interpret mode wherever the input length lies inside
[1, T] (outside it the Pallas kernel reads a clamped row, the XLA scan and
the port give 0), with zero-length targets.  On the card, each layout is
held to the plain version at its boundary widths and at T around the em
ring's depth, the NLL the kernel writes to ``gather_nll`` of the plain
alpha, with the JAX suite's loss tolerance (rtol/atol 1e-5), and that NLL
to 0 where the input length lies outside [1, T].
"""

import collections
import contextlib
import ctypes
import re

import numpy as np
import pytest
import torch

from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.probes import lattice_ab

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
BLANK = {"noblank": False, "blank": True}
# the widest row of the warp layout and of the pairs layout, of the block
# layout with an 8-row and a 2-row em ring, and of the rows layout (the
# widest the first kernels took: two rows, blank with its mask byte)
WARP, PAIRS = 32, 1024
BLOCK8 = {"noblank": 5810, "blank": 5669}
BLOCK2 = {"noblank": 14527, "blank": 13672}
LIMIT = {"noblank": 29056, "blank": 25827}
DEPTH = 8
# the cells a path cannot reach hold about the family's sentinel
UNREACHED = {"noblank": -1e12, "blank": -1e29}


def _bytes(family, layout, width, depth, threads):
    """The kernels' shared-memory layout in bytes: the warp layout's em
    ring, ``depth`` slots a thread; the pairs layout's ring of two cells a
    thread and two exchange rows of 1 (blank 2) slots a warp; the block
    layout's two carried rows and ``depth`` ring rows and the rows layout's
    two carried rows, blank with a mask byte a cell."""
    mask = BLANK[family]
    if layout == "warp":
        return 4 * depth * threads
    if layout == "pairs":
        return 4 * 2 * (depth * threads + threads // 32 * (1 + mask))
    if layout == "block":
        return width * (4 * (2 + depth) + mask)
    return width * (4 * 2 + mask)


def _layout_at(family, width):
    """The layout and ring depth the plan should take at ``width``."""
    if width <= WARP:
        return "warp", DEPTH
    if width <= PAIRS:
        return "pairs", DEPTH
    if width <= BLOCK8[family]:
        return "block", 8
    if width <= BLOCK2[family]:
        return "block", 2
    return "rows", 0


def _boundaries(family):
    """The main and second widths, both sides of every layout's widest row
    (the last one's only inside), the pairs layout in one warp and in two,
    and the block and rows layouts' threads striding over the row."""
    return [1, 10, 11, 31, WARP, WARP + 1, 41, 63, 64, 65, 157, PAIRS - 1,
            PAIRS, PAIRS + 1, 2049, BLOCK8[family], BLOCK8[family] + 1,
            BLOCK2[family], BLOCK2[family] + 1, LIMIT[family] - 1,
            LIMIT[family]]


@pytest.mark.parametrize("family, width", [
    (family, width) for family in BLANK for width in _boundaries(family)])
def test_forward_plan_takes_the_layout_of_each_width(family, width):
    layout, depth, threads, smem = lc.forward_plan(width, BLANK[family])
    assert (layout, depth) == _layout_at(family, width)
    assert smem == _bytes(family, layout, width, depth, threads)
    assert smem == lc.forward_bytes(layout, width, depth, threads,
                                    BLANK[family]) <= lc.SMEM_LIMIT
    assert threads % 32 == 0
    if layout == "warp":
        # a sample a warp, whole warps a block
        assert threads == lc.FORWARD_WARP_THREADS <= 256
    elif layout == "pairs":
        # one sample a block, two cells a lane in whole warps (noblank's
        # 8-byte-aligned pairs of cells -1 .. W-1)
        noblank = family == "noblank"
        assert threads == -(-(width + noblank) // 64) * 32
        assert threads <= 512 + 32 * noblank
    else:
        # the row in whole warps, at most 1024, which stride over wider rows
        assert threads == min(-(-width // 32) * 32, 1024)
    if layout == "block":
        # beside the shard kernels' static shared memory
        assert smem <= lc.SMEM_LIMIT - lc.SHARD_FORWARD_STATIC_BYTES


@pytest.mark.parametrize("family", list(BLANK))
def test_forward_plan_boundaries_are_where_the_layouts_end(family):
    plan = lambda w: lc.forward_plan(w, BLANK[family])  # noqa: E731
    assert plan(WARP)[:2] == ("warp", DEPTH)
    noblank = family == "noblank"
    assert plan(WARP + 1)[:3] == ("pairs", DEPTH, 32)
    assert plan(64 - noblank)[2] == 32 and plan(65 - noblank)[2] == 64
    assert plan(PAIRS)[:3] == ("pairs", DEPTH, 512 + 32 * noblank)
    # past the pairs layout, the block layout while its ring fits, then the
    # first kernels' row loop, as before
    assert plan(PAIRS + 1)[:3] == ("block", 8, 1024)
    assert plan(BLOCK8[family] + 1)[:3] == ("block", 2, 1024)
    assert plan(BLOCK2[family] + 1)[:3] == ("rows", 0, 1024)
    assert plan(LIMIT[family])[:2] == ("rows", 0)


@pytest.mark.parametrize("family", list(BLANK))
def test_every_width_the_first_forward_kernels_took_is_planned(family):
    """The first kernels took any row whose two carried rows (and blank's
    mask bytes) fit in 227 KB; every such width has a plan that fits."""
    blank = BLANK[family]
    width = 1
    while (8 + blank) * width <= lc.SMEM_LIMIT:
        layout, depth, threads, smem = lc.forward_plan(width, blank)
        assert smem <= lc.SMEM_LIMIT and 32 <= threads <= 1024, width
        width += 1
    assert width - 1 == LIMIT[family]
    with pytest.raises(ValueError, match=f"width {width}"):
        lc.forward_plan(width, blank)


def _operands(family, T, B, width):
    """CPU operands of ``*_alpha_kernel`` (zeros, int32 lengths)."""
    em = torch.zeros((T, B, width))
    lens = torch.ones(B, dtype=torch.int32)
    if family == "noblank":
        return em, lens, lens
    return em, torch.zeros((B, width), dtype=torch.uint8), lens, lens


@pytest.mark.parametrize("family", list(BLANK))
def test_forward_kernel_refuses_the_width_before_any_launch(family):
    width = LIMIT[family] + 1
    counts = lc.launch_counts if family == "noblank" else bl.launch_counts
    before = dict(counts)
    with pytest.raises(ValueError, match=f"width {width}"):
        lattice_ab.new_forward(family)(*_operands(family, 2, 1, width))
    assert counts == before


@pytest.mark.parametrize("family", list(BLANK))
def test_forward_kernel_takes_only_cuda_tensors(family):
    """A CPU tensor reaches the plain version through the op, never the
    kernel wrapper: the wrapper raises before it launches."""
    with pytest.raises(ValueError, match="CUDA"):
        lattice_ab.new_forward(family)(*_operands(family, 2, 1, 5))


def test_forward_bytes_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="unknown forward layout"):
        lc.forward_bytes("chunks_warp", 10, 8, 128)


def test_forward_dims_pass_the_layout_as_the_kernels_number():
    assert lc.FORWARD_LAYOUTS == ("rows", "warp", "pairs", "block")
    plan = lc.forward_plan(20000)
    assert lc.forward_dims((4, 2, 20000), plan) == (4, 2, 20000, 0,
                                                     *plan[1:])
    for width, number in ((10, 1), (40, 2), (2000, 3)):
        assert lc.forward_dims((2, 3, width),
                               lc.forward_plan(width))[3] == number


@pytest.mark.parametrize("source", ["noblank_lattice.cu", "blank_lattice.cu"])
def test_forward_layout_numbers_match_the_wrapper(source):
    text = (cuda_build.CSRC / source).read_text()
    for number, layout in enumerate(lc.FORWARD_LAYOUTS):
        name = f"kForward{layout.capitalize()}"
        assert re.search(rf"constexpr int {name} = {number};", text), name
    assert "constexpr int kForwardPairsWidth = 1024;" in text
    assert lc.FORWARD_PAIRS_WIDTH == 1024 and lc.FORWARD_WARP_WIDTH == 32
    blank = source.startswith("blank")
    # the pairs layout's exchange slots a warp: the lane before's last cell
    # (blank: its last two slots)
    assert f"constexpr int kForwardExchange = {1 + blank};" in text


@pytest.mark.parametrize("family", list(BLANK))
def test_forward_launchers_build_exactly_the_planned_layouts(family):
    """The launch switch's (layout, depth) cases are the pairs the plan
    makes at some width, no more: no case only a probe would reach."""
    text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    body = text[text.index("cudaError_t launch_forward("):]
    body = body[:body.index("\n}\n")]
    cases = set(re.findall(r"case kForward(\w+) \* 16 \+ (\d+):", body))
    planned = {lc.forward_plan(w, BLANK[family])[:2]
               for w in _boundaries(family)}
    assert {(k.lower(), int(d)) for k, d in cases} == planned


def test_forward_operand_aligns_em_for_the_pairs_layout():
    """The noblank pairs layout reads em in 8-byte pairs: an em at a 4-byte
    offset (a slice of a wider tensor) is copied to an aligned one, any
    other layout and an aligned em are read as they are."""
    base = torch.arange(3 * 2 * 40 + 1, dtype=torch.float32)
    em = base[1:].view(3, 2, 40)
    assert em.data_ptr() % 8 == 4
    pairs, rows = lc.forward_plan(40), lc.forward_plan(2000)
    got = lc.forward_operand(em, pairs)
    assert got.data_ptr() % 8 == 0 and torch.equal(got, em)
    assert lc.forward_operand(em, rows) is em
    aligned = base[:-1].view(3, 2, 40)
    assert lc.forward_operand(aligned, pairs) is aligned


# ---------------------------------------------------------------------------
# the op: the NLL from the kernel on the kernel path
# ---------------------------------------------------------------------------


def _lattice_case(family, T, B, labels, seed, outside=True):
    """em ``[T, B, W]`` (blank: the gather of random logits over 9
    classes, and its skip mask), int32 lengths with sample 0 at the full T
    and labels, zero-length targets (sample 4 among them), and
    (``outside``) input lengths 0, T + 1 and -2 at samples 1 to 3.
    Returns the operands of ``*_alpha_kernel``."""
    gen = torch.Generator().manual_seed(seed)
    inlen = torch.randint(1, T + 1, (B,), generator=gen)
    tgt = torch.randint(0, labels + 1, (B,), generator=gen)
    inlen[0], tgt[0] = T, labels
    if B >= 5:
        tgt[4] = 0
    if outside and B >= 4:
        inlen[1], inlen[2], inlen[3] = 0, T + 1, -2
    lens = (inlen.int(), tgt.int())
    if family == "noblank":
        return (torch.randn((T, B, labels), generator=gen) - 1.0, *lens)
    logits = torch.randn((T, B, 9), generator=gen)
    targets = torch.randint(1, 9, (B, labels), generator=gen)
    em, skip = blank_emissions_and_skip(logits, targets, 0)
    return (em.contiguous(), skip.to(torch.uint8), *lens)


def _plain(family, args):
    """``(alpha, gather_nll of it)`` from the plain version."""
    if family == "noblank":
        em, inlen, tgt = args
        alpha = lc.noblank_alpha_plain(em, tgt)
        return alpha, lc.gather_nll(alpha, inlen, tgt)
    em, skip, inlen, tgt = args
    alpha = bl.blank_alpha_plain(em, skip)
    return alpha, bl.gather_nll(alpha, inlen, tgt)


@pytest.mark.parametrize("family", list(BLANK))
def test_kernel_path_takes_the_nll_from_the_kernel(family, monkeypatch):
    """``NoBlankLatticeNLL`` / ``BlankLatticeNLL`` with ``use_kernel``
    return the NLL the forward kernel wrote and run no ``gather_nll``
    (the kernels stand in here for their plain versions)."""
    module = lc if family == "noblank" else bl
    args = _lattice_case(family, 9, 5, 4, seed=3)
    alpha, nll = _plain(family, args)
    written = nll + 0.25  # what the stand-in kernel writes
    calls = []

    def kernel(*got):
        calls.append(got)
        return alpha, written

    def refuse(*_):
        raise AssertionError("gather_nll ran on the kernel path")

    grad = lc.noblank_grad_plain if family == "noblank" else (
        bl.blank_grad_plain)
    monkeypatch.setattr(module, f"{family}_alpha_kernel", kernel)
    monkeypatch.setattr(module, f"{family}_grad_kernel", grad)
    monkeypatch.setattr(module, "gather_nll", refuse)
    em = args[0].clone().requires_grad_()
    op = lc.NoBlankLatticeNLL if family == "noblank" else bl.BlankLatticeNLL
    out = op.apply(em, *args[1:], True)
    out.sum().backward()
    assert torch.equal(out.detach(), written)
    ((got_em, *rest),) = calls
    assert torch.equal(got_em, args[0])
    assert all(torch.equal(a, b) for a, b in zip(rest, args[1:]))
    assert em.grad is not None and em.grad.shape == em.shape


@pytest.mark.parametrize("family", list(BLANK))
def test_plain_path_still_gathers_the_nll(family, monkeypatch):
    """The plain path (the CPU path and the oracle) keeps
    ``gather_nll``."""
    module = lc if family == "noblank" else bl
    calls = []
    gather = module.gather_nll

    def counting(*a):
        calls.append(a)
        return gather(*a)

    monkeypatch.setattr(module, "gather_nll", counting)
    args = _lattice_case(family, 6, 4, 3, seed=4)
    op = lc.NoBlankLatticeNLL if family == "noblank" else bl.BlankLatticeNLL
    got = op.apply(*args, False)
    assert len(calls) == 1
    torch.testing.assert_close(got, _plain(family, args)[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the plain NLL against the JAX package
# ---------------------------------------------------------------------------


def _jax_nll(family, args, ref):
    """The JAX package's NLL of the same operands: the XLA scan or the
    Pallas kernel in interpret mode."""
    import jax
    import jax.numpy as jnp

    arrays = [jnp.asarray(a.numpy()) for a in args]
    if family == "noblank":
        em, inlen, tgt = arrays
        if ref == "xla":
            from ctc_tpu.ops import lattice_xla
            return np.asarray(lattice_xla.noblank_lattice_nll(em, inlen, tgt))
        from ctc_tpu.ops.lattice_pallas import noblank_lattice_nll_pallas
        return np.asarray(noblank_lattice_nll_pallas(
            em, inlen, tgt, layout="tbl", interpret=True))
    em, skip, inlen, tgt = arrays
    skip = skip.astype(bool)
    if ref == "pallas":
        from ctc_tpu.ops.blank_lattice_pallas import blank_lattice_nll_pallas
        return np.asarray(blank_lattice_nll_pallas(
            em, skip, inlen, tgt, layout="tbl", interpret=True))
    # the XLA scan of ctc_tpu.losses.blank.ctc_loss on these emissions
    from ctc_tpu.losses.blank import blank_alpha_init, make_blank_step

    max_t, batch, s_len = em.shape
    valid = jnp.arange(s_len)[None, :] < (2 * tgt + 1)[:, None]
    step = make_blank_step(skip, valid, inlen, tgt)
    (_, final), _ = jax.lax.scan(
        step, (blank_alpha_init(batch, s_len), jnp.zeros((batch,))),
        (jnp.arange(max_t), em))
    return np.asarray(-final)


# (T, B, labels): one warp's width and a pairs width, T past the ring
JAX_CASES = [(9, 7, 5), (12, 6, 40), (3, 5, 2)]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("shape", JAX_CASES, ids=str)
def test_plain_nll_matches_jax_with_lengths_outside(family, ref, shape):
    """Input lengths 0, T + 1 and -2 and zero-length targets: the port (the
    plain NLL every kernel is held to) gives 0 outside [1, T], as the XLA
    scan does; the Pallas kernel reads a clamped row there, so it is held
    to the port inside [1, T] only."""
    T = shape[0]
    args = _lattice_case(family, *shape, seed=sum(shape))
    want = _jax_nll(family, args, ref)
    got = _plain(family, args)[1].numpy()
    inlen = args[-2].numpy()
    keep = np.ones_like(inlen, bool) if ref == "xla" else (
        (inlen >= 1) & (inlen <= T))
    assert keep.sum() >= 2
    np.testing.assert_allclose(got[keep], want[keep], **LOSS_TOL)
    assert (args[-1] == 0).any()  # a zero-length target is covered
    assert np.all(got[(inlen < 1) | (inlen > T)] == 0)


# ---------------------------------------------------------------------------
# the A/B probe's forward pass
# ---------------------------------------------------------------------------

# the earlier tree's (89c1a31) whole-lattice forward launchers, as its
# sources declare them
OLD_LAUNCHERS = {
    "noblank": "cudaError_t noblank_lattice_forward(const float* em, "
               "const int* tgt, float* alpha, int T, int B, int L, "
               "cudaStream_t stream)",
    "blank": "cudaError_t blank_lattice_forward(const float* em, "
             "const unsigned char* skip, float* alpha, int T, int B, int S, "
             "cudaStream_t stream)",
}


def _ctypes_of(declaration):
    params = declaration[declaration.index("(") + 1:-1].split(",")
    return tuple(ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                 else ctypes.c_int for p in params)


@pytest.mark.parametrize("family", list(BLANK))
def test_old_signatures_type_the_earlier_forward_launchers(family):
    assert lattice_ab.OLD_SIGNATURES["forward"][family] == _ctypes_of(
        OLD_LAUNCHERS[family])


@pytest.mark.parametrize("family", list(BLANK))
def test_old_forward_passes_the_earlier_argument_order(family, monkeypatch):
    """The parent's launcher gets em, then tgt (blank: the skip mask), then
    alpha and T, B, W and the stream; the NLL comes from ``gather_nll``."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            return fn

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    args = _lattice_case(family, 3, 4, 2, seed=5)
    alpha, nll = lattice_ab.old_forward(family, Lib())(*args)
    ((name, got),) = calls
    assert name == f"{family}_lattice_forward"
    em, operand = args[0], args[1] if family == "blank" else args[2]
    assert got[:2] == (em.data_ptr(), operand.data_ptr())
    assert got[2] == alpha.data_ptr() and alpha.shape == em.shape
    assert got[3:] == (*em.shape, 7)
    gather = lc.gather_nll if family == "noblank" else bl.gather_nll
    torch.testing.assert_close(nll, gather(alpha, *args[-2:]))


@pytest.mark.parametrize("family", list(BLANK))
def test_forward_in_plan_launches_the_plan_it_is_given(family, monkeypatch):
    """The probe's launch in a given plan passes the plan as the launcher's
    ints, returns alpha and nll, and counts it in the probe's own counts,
    not the wrapper's."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            return fn

    monkeypatch.setattr(cuda_build, "load", lambda source: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    width = 40 if family == "noblank" else 41
    args = _operands(family, 3, 2, width)
    plan = ("rows", 0, 64, lc.forward_bytes("rows", width, 0, 64,
                                            BLANK[family]))
    counts = collections.Counter()
    wrapper = dict(lc.launch_counts if family == "noblank"
                   else bl.launch_counts)
    alpha, nll = lattice_ab.forward_in_plan(family, args, plan, counts)
    ((name, got),) = calls
    assert name == f"{family}_lattice_forward"
    n = len(args)
    assert got[:n] == tuple(t.data_ptr() for t in args)
    assert got[n:n + 2] == (alpha.data_ptr(), nll.data_ptr())
    assert alpha.shape == args[0].shape and nll.shape == (2,)
    assert got[n + 2:] == (3, 2, width, 0, 0, 64, plan[3], 7)
    assert counts == {name: 1}
    assert wrapper == (lc.launch_counts if family == "noblank"
                       else bl.launch_counts)


@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("label", ["main_path", "second", "wide", "wider"])
def test_candidate_forward_plans_hold_the_plan_and_fit(family, label):
    labels = {**lattice_ab.SHAPES[family],
              **lattice_ab.WIDE_SHAPES[family]}[label][2]
    width = labels if family == "noblank" else 2 * labels + 1
    plans = lattice_ab.candidate_forward_plans(width, BLANK[family])
    assert lc.forward_plan(width, BLANK[family]) in plans
    layouts = {p[0] for p in plans}
    assert layouts <= set(lc.FORWARD_LAYOUTS) and "rows" in layouts
    assert ("warp" in layouts) == (width <= WARP)
    assert ("pairs" in layouts) == (width <= PAIRS)
    for layout, depth, threads, smem in plans:
        assert smem == lc.forward_bytes(layout, width, depth, threads,
                                        BLANK[family]) <= lc.SMEM_LIMIT
        assert threads % 32 == 0


def test_both_sources_take_the_log_add_from_one_header():
    """Both lattice sources include ``log_add.cuh`` and define no log-add
    of their own; the exhaustive check of its branch-free log1pf builds
    against the header, and a build's source inlines it once."""
    header = (cuda_build.CSRC / "log_add.cuh").read_text()
    for family in BLANK:
        text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
        assert text.count(lattice_ab._LOG_ADD) == 1
        for fn in ("log1p_unit(", "logaddexp(", "logaddexp_flat("):
            assert f"__forceinline__ float {fn}" not in text
            assert f"__forceinline__ float {fn}" in header
        got = lattice_ab.with_log_add(text)
        assert lattice_ab._LOG_ADD not in got and got.count(header) == 1
        with pytest.raises(ValueError, match="not included once"):
            lattice_ab.with_log_add(text + lattice_ab._LOG_ADD)
    assert lattice_ab._LOG1P_CHECK.startswith(lattice_ab._LOG_ADD)


@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("build", [*lattice_ab.FORWARD_BUILDS,
                                   *lattice_ab.BACKWARD_BUILDS])
def test_one_place_builds_edit_their_own_copy(family, build):
    """Every ``--builds`` variant applies each of its edits exactly once,
    in the source with the header inlined (the log-add's edits land in
    the header's text), and changes nothing else."""
    kind = "backward" if build in lattice_ab.BACKWARD_BUILDS else "forward"
    text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    base = lattice_ab.cycles_source(text, family, kind)
    got = lattice_ab.variant_source(text, family, build, kind)
    edits = lattice_ab._FWD_EDITS[build][family]
    assert (got == base) == (not edits)
    for old, new in edits:
        assert base.count(old) == 1 and got.count(old) == 0
        if new:
            assert got.count(new) >= 1


def test_window_median_skips_windows_that_read_no_event():
    assert lattice_ab.window_median([3.0, None, 1.0, 2.0, 9.0]) == 2.5
    assert lattice_ab.window_median([2.0, 1.0, 3.0]) == 2.0
    assert lattice_ab.window_median([None, None]) is None


@pytest.mark.parametrize("family", list(BLANK))
def test_forward_cycles_source_reads_the_clock_around_the_step_loops(family):
    text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    got = lattice_ab.cycles_source(text, family, "forward")
    pairs = got[got.index(f"{family}_forward_pairs("):]
    pairs = pairs[:pairs.index("// The whole-lattice forward's layouts")]
    assert pairs.index("sweep_clock_read(0);") < pairs.index(
        "for (; t + kDepth <= T; t += kDepth)") < pairs.index(
            "for (int k = 0; t < T; ++t, ++k)") < pairs.index(
                "sweep_clock_read(1);")
    warps = got[got.index(f"{family}_shard_forward_warps("):]
    warps = warps[:warps.index("return;  // nll is written")]
    assert warps.index("sweep_clock_read(0);") < warps.index(
        "for (int t = 1; t < T - 1; ++t)") < warps.rindex(
            "sweep_clock_read(1);")
    assert "sweep_read_clock" in got
    with pytest.raises(ValueError, match="not once"):
        lattice_ab.cycles_source(text + lattice_ab._PAIRS_START, family,
                                 "forward")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check_on_card(family, args, plan=None):
    """The wrapper's alpha and nll (in ``plan``, through the probe's
    launch, where given) against the plain alpha's reachable cells and
    ``gather_nll`` of it; the nll 0 where the input length lies outside
    [1, T]."""
    if plan is None:
        alpha, nll = lattice_ab.new_forward(family)(*args)
    else:
        alpha, nll = lattice_ab.forward_in_plan(family, args, plan,
                                                collections.Counter())
    want_alpha, want_nll = _plain(family, args)
    torch.cuda.synchronize()
    torch.testing.assert_close(nll, want_nll, **LOSS_TOL)
    reach = want_alpha > UNREACHED[family]
    torch.testing.assert_close(alpha[reach], want_alpha[reach], **LOSS_TOL)
    inlen, T = args[-2], args[0].shape[0]
    assert bool((nll[(inlen < 1) | (inlen > T)] == 0).all())


def _on_card(args, device):
    return tuple(a.to(device) for a in args)


# (T, B, labels): blank labels L give S = 2L + 1 slots.  The main shape,
# both sides of the warp layout's end, the pairs layout in one warp at its
# widest and in two, the second shape's width, both sides of the pairs
# layout's end, the block layout's threads striding unevenly, both sides of
# its 8-row ring's end and of its own, the rows layout's widest row, a
# one-cell row
CARD_CASES = {
    "noblank": [(10, 256, 10), (12, 11, 32), (12, 5, 33), (9, 5, 63),
                (9, 5, 64), (21, 3, 157), (5, 2, 1024), (5, 2, 1025),
                (3, 2, 2049), (2, 2, 5810), (2, 2, 5811), (2, 1, 14527),
                (2, 1, 14528), (2, 1, 29056), (33, 3, 1)],
    "blank": [(10, 256, 5), (12, 11, 15), (12, 5, 16), (9, 5, 31),
              (9, 5, 32), (21, 3, 20), (5, 2, 511), (5, 2, 512),
              (3, 2, 1024), (2, 2, 2834), (2, 2, 2835), (2, 1, 6835),
              (2, 1, 6836), (2, 1, 12913), (33, 4, 1)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("index", range(15))
def test_forward_kernel_matches_plain_at_the_layout_boundaries(
        cuda_device, family, index):
    T, B, labels = CARD_CASES[family][index]
    args = _lattice_case(family, T, B, labels, seed=index)
    _check_on_card(family, _on_card(args, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("labels", [6, 35])
@pytest.mark.parametrize("T", [1, DEPTH - 1, DEPTH, DEPTH + 1, 37])
def test_every_forward_layout_matches_plain_around_the_ring(
        cuda_device, family, labels, T):
    """Each layout the launchers take, at a narrow and a wide width (blank:
    S = 13, 71), with T one step, below, at and past the em ring's depth,
    and long."""
    args = _on_card(_lattice_case(family, T, 9, labels, seed=T),
                    cuda_device)
    width = args[0].shape[2]
    for plan in lattice_ab.candidate_forward_plans(width, BLANK[family]):
        _check_on_card(family, args, plan=plan)


@pytest.mark.cuda
def test_branch_free_log1p_has_the_bits_of_log1pf(cuda_device):
    """Every float in [0, 1]: the forward's log1p_unit gives the bits of
    CUDA's log1pf, so the forward's log-add is the libm one."""
    assert lattice_ab.check_log1p("test")["mismatches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 5])
def test_pairs_layout_reads_an_em_at_any_offset(cuda_device, batch):
    """em a slice of a wider tensor at a 4-byte offset, B L even (8-byte
    pairs) and odd (4-byte cells): the wrapper's alpha and nll equal the
    plain version's."""
    args = _lattice_case("noblank", 12, batch, 157, seed=batch)
    em = args[0]
    wide = torch.cat([em.reshape(-1)[:1], em.reshape(-1)]).to(cuda_device)
    em_slice = wide[1:].view(em.shape)
    assert em_slice.data_ptr() % 8 == 4
    _check_on_card("noblank", (em_slice, *_on_card(args[1:], cuda_device)))


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("labels", [10, 64, 157])
def test_a_nan_stays_in_its_own_sample(cuda_device, family, labels):
    """A NaN in sample 0's last em cell, at every t: in every layout the
    other samples' NLL equal the plain version's, finite (B L even, so a
    pairs row starts at an odd float at samples 1 and 3)."""
    args = _lattice_case(family, 9, 4, labels, seed=labels, outside=False)
    args[0][:, 0, -1] = float("nan")
    args = _on_card(args, cuda_device)
    _, want = _plain(family, args)
    assert torch.isfinite(want[1:]).all()
    width = args[0].shape[2]
    for plan in lattice_ab.candidate_forward_plans(width, BLANK[family]):
        _, nll = lattice_ab.forward_in_plan(family, args, plan,
                                            collections.Counter())
        torch.cuda.synchronize()
        torch.testing.assert_close(nll[1:], want[1:], **LOSS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
def test_forward_launch_refuses_a_plan_off_its_layout(cuda_device, family):
    width = 1025  # blank: 512 labels
    labels = width if family == "noblank" else 512
    args = _on_card(_lattice_case(family, 4, 3, labels, seed=0), cuda_device)
    counts = collections.Counter()
    wrapper = lc.launch_counts if family == "noblank" else bl.launch_counts
    before = dict(wrapper)
    blank = BLANK[family]
    bad = [
        # the pairs layout past 1024 cells, the warp layout past 32
        ("pairs", 8, 544, lc.forward_bytes("pairs", width, 8, 544, blank)),
        ("warp", 8, 32, lc.forward_bytes("warp", width, 8, 32, blank)),
        # shared bytes off the layout's formula, a depth not built
        ("rows", 0, 1024, 4),
        ("rows", 4, 1024, lc.forward_bytes("rows", width, 4, 1024, blank)),
    ]
    for plan in bad:
        with pytest.raises(RuntimeError, match="launch failed"):
            lattice_ab.forward_in_plan(family, args, plan, counts)
    assert not counts and wrapper == before
