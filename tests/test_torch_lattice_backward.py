"""The whole-lattice backward kernels' plan, on the CPU, and the kernels
against their plain versions on the card (``-m cuda``).

``backward_plan`` picks the layout of the two whole-lattice backward
kernels (``csrc/noblank_lattice.cu``, ``csrc/blank_lattice.cu``) from the
lattice width: the chunks-warp layout up to 32 cells, the warps layout up
to 1024, then the rows layout, up to the widest row the first kernels took
(their two carried rows in 227 KB), and a refusal past it before any
launch.  Its shared bytes must be the kernels' own layout formula, and the
launchers build exactly the plans it makes.  The A/B probe's parent build
types the earlier tree's launchers, whose parameter lists are quoted below
from that tree.  On the card, each layout is held to the plain version at
its boundary widths, at T = 1 and at T not a multiple of its chunk, with
the JAX suite's gradient tolerance (rtol 2e-3, atol 2e-5) and exact zeros
at ``t >= input_length``.
"""

import collections
import contextlib
import ctypes
import re
import subprocess

import pytest
import torch

from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.probes import lattice_ab, shard_ab

GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
BLANK = {"noblank": False, "blank": True}
# the widest row of the chunks-warp layout and of the warps layout, and of
# the rows layout (the widest the first kernels took: two rows, blank with
# its mask byte)
NARROW, WARPS = 32, 1024
LIMIT = {"noblank": 29056, "blank": 25827}
# the first rows past the widest the shard backward's chunks take
PAST_SHARD = {"noblank": 5283, "blank": 4386}


def _bytes(family, layout, width, chunk, threads):
    """The kernels' shared-memory layout in bytes: the warps layout's two
    staging columns of ``chunk`` rows of two cells a thread, its halo cells
    (1, blank 2 a warp a row) and exchange slots (1, blank 3 a warp), all
    doubled; the chunks-warp layout's two alpha chunks, the chunk's 2
    (blank 3) weight rows and two g rows a cell
    (``chunked_floats_per_cell``); the rows layout's two g rows; blank adds
    a mask byte a cell to the last two."""
    mask = BLANK[family]
    if layout == "warps":
        warps = threads // 32
        halo, exchange = (2, 3) if mask else (1, 1)
        return 4 * 2 * (chunk * (2 * threads + warps * halo)
                        + warps * exchange)
    if layout == "chunks_warp":
        weights = 3 if mask else 2
        return width * (4 * ((2 + weights) * chunk + 2) + mask)
    return width * (4 * 2 + mask)


def _layout_at(family, width):
    """The layout and chunk the plan should take at ``width``."""
    if width <= NARROW:
        return "chunks_warp", 16
    if width <= WARPS:
        return "warps", 8
    return "rows", 0


def _boundaries(family):
    """The main and second widths, both sides of every layout's widest row
    (the last one's only inside), the rows layout's threads striding over
    the row, and past the widest row the shard backward's chunks take."""
    widths = [1, 10, 11, NARROW, NARROW + 1, 41, 157, WARPS, WARPS + 1,
              2048, 2049, PAST_SHARD[family]]
    return widths + [LIMIT[family] - 1, LIMIT[family]]


@pytest.mark.parametrize("family, width", [
    (family, width) for family in BLANK for width in _boundaries(family)])
def test_backward_plan_takes_the_layout_of_each_width(family, width):
    layout, chunk, threads, smem = lc.backward_plan(width, BLANK[family])
    assert (layout, chunk) == _layout_at(family, width)
    assert smem == _bytes(family, layout, width, chunk, threads)
    assert smem == lc.backward_bytes(layout, width, chunk, threads,
                                     BLANK[family]) <= lc.SMEM_LIMIT
    assert threads % 32 == 0
    if layout == "chunks_warp":
        # the block that stages and weights the chunk; one warp steps
        assert threads == lc.BACKWARD_NARROW_THREADS == 128
    elif layout == "warps":
        # one sample a block, two cells a lane, in whole warps
        assert threads == -(-width // 64) * 32 <= 512
    else:
        # the row in whole warps, at most its launch bounds' 1024, which
        # stride over wider rows
        assert threads == min(-(-width // 32) * 32, 1024)


@pytest.mark.parametrize("family", list(BLANK))
def test_backward_plan_boundaries_are_where_the_layouts_end(family):
    plan = lambda w: lc.backward_plan(w, BLANK[family])[:2]  # noqa: E731
    assert plan(NARROW) == ("chunks_warp", 16)
    assert plan(NARROW + 1) == ("warps", 8)
    assert plan(WARPS) == ("warps", 8)
    # past the warps layout, the first kernels' row loop, as before
    assert plan(WARPS + 1) == ("rows", 0)
    assert lc.backward_plan(WARPS + 1, BLANK[family])[2] == 1024
    assert plan(LIMIT[family]) == ("rows", 0)


@pytest.mark.parametrize("family", list(BLANK))
def test_every_width_the_first_kernels_took_is_planned(family):
    """The first kernels took any row whose two carried rows (and blank's
    mask bytes) fit in 227 KB; every such width has a plan that fits."""
    blank = BLANK[family]
    width = 1
    while (8 + blank) * width <= lc.SMEM_LIMIT:
        layout, chunk, threads, smem = lc.backward_plan(width, blank)
        assert smem <= lc.SMEM_LIMIT and 32 <= threads <= 1024, width
        width += 1
    assert width - 1 == LIMIT[family]
    with pytest.raises(ValueError, match=f"width {width}"):
        lc.backward_plan(width, blank)


@pytest.mark.parametrize("family", list(BLANK))
def test_backward_kernel_refuses_the_width_before_any_launch(family):
    width = LIMIT[family] + 1
    alpha = torch.zeros((2, 1, width))
    lens = torch.ones(1, dtype=torch.int32)
    bar = torch.zeros(1)
    counts = lc.launch_counts if family == "noblank" else bl.launch_counts
    before = dict(counts)
    with pytest.raises(ValueError, match=f"width {width}"):
        if family == "noblank":
            lc.noblank_grad_kernel(alpha, lens, lens, bar)
        else:
            skip = torch.zeros((1, width), dtype=torch.uint8)
            bl.blank_grad_kernel(alpha, skip, lens, lens, bar)
    assert counts == before


@pytest.mark.parametrize("family", list(BLANK))
def test_backward_kernel_takes_only_cuda_tensors(family):
    """A CPU tensor reaches the plain version through the op, never the
    kernel wrapper: the wrapper raises before it launches."""
    alpha = torch.zeros((2, 1, 5))
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        if family == "noblank":
            lc.noblank_grad_kernel(alpha, lens, lens, torch.zeros(1))
        else:
            skip = torch.zeros((1, 5), dtype=torch.uint8)
            bl.blank_grad_kernel(alpha, skip, lens, lens, torch.zeros(1))


def test_backward_bytes_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="unknown backward layout"):
        lc.backward_bytes("ring", 10, 16, 128)


def test_backward_dims_pass_the_layout_as_the_kernels_number():
    plan = lc.backward_plan(2000)
    assert lc.backward_dims((4, 2, 2000), plan) == (4, 2, 2000, 0, *plan[1:])
    assert lc.BACKWARD_LAYOUTS == ("rows", "warps", "chunks_warp")
    assert lc.backward_dims((2, 3, 40), lc.backward_plan(40))[3] == 1
    assert lc.backward_dims((2, 3, 10), lc.backward_plan(10))[3] == 2


@pytest.mark.parametrize("source", ["noblank_lattice.cu", "blank_lattice.cu"])
def test_kernel_layout_numbers_match_the_wrapper(source):
    text = (cuda_build.CSRC / source).read_text()
    for number, layout in enumerate(lc.BACKWARD_LAYOUTS):
        name = "k" + "".join(w.capitalize() for w in layout.split("_"))
        name += "Layout"
        assert re.search(rf"constexpr int {name} = {number};", text), name
    assert "constexpr int kBackwardWarpsWidth = 1024;" in text
    assert lc.BACKWARD_WARPS_WIDTH == 1024
    blank = source.startswith("blank")
    assert f"constexpr int kBackwardHalo = {1 + blank};" in text
    assert f"constexpr int kBackwardExchange = {1 + 2 * blank};" in text


@pytest.mark.parametrize("family", list(BLANK))
def test_backward_launchers_build_exactly_the_planned_layouts(family):
    """The launch switch's (layout, chunk) cases are the pairs the plan
    makes at some width, no more: no case only a probe would reach."""
    text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    body = text[text.index("cudaError_t launch_backward("):]
    body = body[:body.index("\n}\n")]
    cases = set(re.findall(r"case k(\w+)Layout \* 32 \+ (\d+):", body))
    planned = {lc.backward_plan(w, BLANK[family])[:2]
               for w in (1, NARROW, NARROW + 1, WARPS, WARPS + 1,
                         LIMIT[family])}
    names = {"Rows": "rows", "Warps": "warps", "ChunksWarp": "chunks_warp"}
    assert {(names[k], int(c)) for k, c in cases} == planned


# ---------------------------------------------------------------------------
# the A/B probe's parent build
# ---------------------------------------------------------------------------

# the earlier tree's (10519f1) whole-lattice backward launchers, as its
# sources declare them
OLD_LAUNCHERS = {
    "noblank": "cudaError_t noblank_lattice_backward(const float* alpha, "
               "const int* inlen, const int* tgt, const float* nll_bar, "
               "float* g, int T, int B, int L, cudaStream_t stream)",
    "blank": "cudaError_t blank_lattice_backward(const float* alpha, "
             "const unsigned char* skip, const int* inlen, const int* tgt, "
             "const float* nll_bar, float* g, int T, int B, int S, "
             "cudaStream_t stream)",
}


def _ctypes_of(declaration):
    params = declaration[declaration.index("(") + 1:-1].split(",")
    return tuple(ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                 else ctypes.c_int for p in params)


@pytest.mark.parametrize("family", list(BLANK))
def test_old_signatures_type_the_earlier_launchers(family):
    assert lattice_ab.OLD_SIGNATURES["backward"][family] == _ctypes_of(
        OLD_LAUNCHERS[family])


def test_build_parent_types_the_symbol_it_is_given(tmp_path, monkeypatch):
    csrc = tmp_path / "ctc_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for family in BLANK:
        (csrc / f"{family}_lattice.cu").write_text("// parent\n")
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
            self.noblank_lattice_backward = type("Fn", (), {})()
            self.blank_lattice_backward = type("Fn", (), {})()

    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    monkeypatch.setattr(shard_ab, "PARENT_BUILD", tmp_path / "out")
    libs = shard_ab.build_parent(tmp_path, symbol="lattice_backward",
                                 tag="_lattice_ab",
                                 signatures=lattice_ab.OLD_SIGNATURES[
                                     "backward"])
    for family in BLANK:
        fn = getattr(libs[family], f"{family}_lattice_backward")
        assert tuple(fn.argtypes) == lattice_ab.OLD_SIGNATURES["backward"][
            family]
        assert fn.restype is ctypes.c_int
        assert libs[family].path.endswith(f"{family}_lattice_lattice_ab.so")
    # one nvcc a source, with the parent's own headers first on the path
    assert len(commands) == 2
    assert all(f"-I{csrc}" in cmd for cmd in commands)


def test_old_grad_passes_the_earlier_argument_order(monkeypatch):
    calls = []

    class Lib:
        @staticmethod
        def blank_lattice_backward(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    alpha = torch.zeros((3, 2, 5))
    rest = (torch.zeros((2, 5), dtype=torch.uint8),
            torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32),
            torch.zeros(2))
    g = lattice_ab.old_grad("blank", Lib)(alpha, *rest)
    (args,) = calls
    assert args[0] == alpha.data_ptr()
    assert args[1:5] == tuple(t.data_ptr() for t in rest)
    assert args[5] == g.data_ptr() and args[6:] == (3, 2, 5, 7)


@pytest.mark.parametrize("family", list(BLANK))
def test_cycles_source_reads_the_clock_around_both_chunk_loops(family):
    text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    got = lattice_ab.cycles_source(text, family)
    assert got.count("sweep_clock_read(0);") == 2
    assert got.count("sweep_clock_read(1);") == 2
    warps = got[got.index(f"{family}_backward_warps("):]
    assert warps.index("sweep_clock_read(0);") < warps.index(
        "for (int c = 0; c < chunk_count; ++c)")
    assert warps.index("sweep_clock_read(1);") < warps.index(
        "// The whole-lattice backward's layouts")
    assert "sweep_read_clock" in got
    with pytest.raises(ValueError, match="not once"):
        lattice_ab.cycles_source(text + lattice_ab._WARPS_START, family)


@pytest.mark.parametrize("family", list(BLANK))
def test_grad_in_plan_launches_the_plan_it_is_given(family, monkeypatch):
    """The probe's launch in a given plan passes the plan as the launcher's
    ints and counts it in the probe's own counts, not the wrapper's."""
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
    alpha = torch.zeros((3, 2, width))
    lens = torch.ones(2, dtype=torch.int32)
    args = (alpha, lens, lens, torch.zeros(2))
    if family == "blank":
        args = (alpha, torch.zeros((2, width), dtype=torch.uint8), *args[1:])
    plan = ("rows", 0, 64, lc.backward_bytes("rows", width, 0, 64,
                                             BLANK[family]))
    counts = collections.Counter()
    wrapper = dict(lc.launch_counts if family == "noblank"
                   else bl.launch_counts)
    g = lattice_ab.grad_in_plan(family, args, plan, counts)
    ((name, got),) = calls
    assert name == f"{family}_lattice_backward"
    assert got[:len(args)] == tuple(t.data_ptr() for t in args)
    assert got[len(args)] == g.data_ptr() and g.shape == alpha.shape
    assert got[len(args) + 1:] == (3, 2, width, 0, 0, 64, plan[3], 7)
    assert counts == {name: 1}
    assert wrapper == (lc.launch_counts if family == "noblank"
                       else bl.launch_counts)


@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("label", ["main_path", "second"])
def test_candidate_plans_hold_the_plan_and_fit(family, label):
    labels = lattice_ab.SHAPES[family][label][2]
    width = labels if family == "noblank" else 2 * labels + 1
    plans = lattice_ab.candidate_plans(width, BLANK[family])
    assert lc.backward_plan(width, BLANK[family]) in plans
    assert {p[0] for p in plans} == (
        {"chunks_warp", "warps", "rows"} if width <= NARROW
        else {"warps", "rows"})
    for layout, chunk, threads, smem in plans:
        assert smem == _bytes(family, layout, width, chunk, threads)
        assert smem <= lc.SMEM_LIMIT and threads % 32 == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(family, T, B, labels, device, seed):
    """alpha from the plain forward, the kernel operands and the plain g:
    ``(operands of *_grad_kernel, plain g)``."""
    gen = torch.Generator().manual_seed(seed)
    if family == "noblank":
        em = torch.randn((T, B, labels), generator=gen) - 1.0
        inlen = torch.randint(1, T + 1, (B,), generator=gen)
        tgt = torch.minimum(torch.randint(1, labels + 1, (B,), generator=gen),
                            inlen)
        inlen[0] = T
        cot = torch.randn((B,), generator=gen)
        em, inlen, tgt, cot = (x.to(device) for x in (em, inlen.int(),
                                                       tgt.int(), cot))
        alpha = lc.noblank_alpha_plain(em, tgt)
        args = (alpha, inlen, tgt, cot)
        return args, lc.noblank_grad_plain(*args)
    logits = torch.randn((T, B, 9), generator=gen)
    targets = torch.randint(1, 9, (B, labels), generator=gen)
    inlen = torch.randint(min(2 * labels + 1, T), T + 1, (B,), generator=gen)
    tgt = torch.randint(0, labels + 1, (B,), generator=gen)
    inlen[0] = T
    em, skip = blank_emissions_and_skip(logits, targets, 0)
    cot = torch.randn((B,), generator=gen)
    em, skip, inlen, tgt, cot = (x.to(device) for x in (
        em.contiguous(), skip.to(torch.uint8), inlen.int(), tgt.int(), cot))
    alpha = bl.blank_alpha_plain(em, skip)
    args = (alpha, skip, inlen, tgt, cot)
    return args, bl.blank_grad_plain(*args)


def _check_on_card(family, args, want, plan=None):
    """The wrapper's g (in ``plan``, through the probe's launch, where
    given) against the plain g."""
    if plan is None:
        grad = lc.noblank_grad_kernel if family == "noblank" else (
            bl.blank_grad_kernel)
        got = grad(*args)
    else:
        got = lattice_ab.grad_in_plan(family, args, plan,
                                      collections.Counter())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **GRAD_TOL)
    alpha, inlen = args[0], args[-3]
    past = (torch.arange(alpha.shape[0], device=alpha.device)[:, None]
            >= inlen[None, :].long())
    assert not bool((got[past[:, :, None].expand_as(got)] != 0).any())


# (T, B, labels): blank labels L give S = 2L + 1 slots.  The main shape,
# T = 1, both sides of the chunks-warp layout's end (T past a chunk), the
# second shape's width at T past a chunk, both sides of the warps layout's
# end, the rows layout's threads striding evenly and unevenly, past the
# shard backward's widest row, and the rows layout's widest row
CARD_CASES = {
    "noblank": [(10, 256, 10), (1, 9, 10), (37, 5, 32), (37, 6, 33),
                (21, 3, 157), (5, 2, 1024), (5, 2, 1025), (3, 2, 2048),
                (3, 2, 2049), (2, 2, 5283), (2, 2, 9686), (2, 1, 29056),
                (33, 3, 1)],
    "blank": [(10, 256, 5), (1, 9, 5), (37, 5, 15), (37, 6, 16),
              (21, 3, 20), (5, 2, 511), (5, 2, 512), (3, 2, 1023),
              (3, 2, 1024), (2, 2, 2193), (2, 2, 4008), (2, 1, 12913),
              (33, 3, 0)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("index", range(13))
def test_backward_kernel_matches_plain_at_the_layout_boundaries(
        cuda_device, family, index):
    T, B, labels = CARD_CASES[family][index]
    args, want = _case(family, T, B, labels, cuda_device, seed=index)
    _check_on_card(family, args, want)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
@pytest.mark.parametrize("labels", [6, 35])
@pytest.mark.parametrize("T", [1, 8, 16, 17, 37])
def test_every_layout_matches_plain_at_one_width(cuda_device, family,
                                                 labels, T):
    """Each layout the launchers take, at a narrow and a wide width (blank:
    S = 13, 71), with T below, at and past one chunk."""
    args, want = _case(family, T, 7, labels * (2 if family == "noblank"
                                                else 1), cuda_device, seed=T)
    width = args[0].shape[2]
    for plan in lattice_ab.candidate_plans(width, BLANK[family]):
        _check_on_card(family, args, want, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(BLANK))
def test_backward_launch_refuses_a_plan_off_its_layout(cuda_device, family):
    args, _ = _case(family, 4, 3, 1025 if family == "noblank" else 512,
                    cuda_device, seed=0)
    width = args[0].shape[2]
    counts = collections.Counter()
    wrapper = lc.launch_counts if family == "noblank" else bl.launch_counts
    before = dict(wrapper)
    blank = family == "blank"
    bad = [
        # the warps layout past 1024 cells, the chunks-warp layout past 32
        ("warps", 8, 544, lc.backward_bytes("warps", width, 8, 544, blank)),
        ("chunks_warp", 16, 128, lc.backward_bytes("chunks_warp", width, 16,
                                                   128, blank)),
        # shared bytes off the layout's formula, a chunk not built
        ("rows", 0, 1024, 4),
        ("rows", 4, 1024, lc.backward_bytes("rows", width, 4, 1024, blank)),
    ]
    for plan in bad:
        with pytest.raises(RuntimeError, match="launch failed"):
            lattice_ab.grad_in_plan(family, args, plan, counts)
    assert not counts and wrapper == before
