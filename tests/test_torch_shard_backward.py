"""The shard backward kernels' plan and the C interface of every kernel
source, on the CPU (nothing here compiles or launches a kernel).

``shard_backward_plan`` picks the alpha chunk of the two shard backward
kernels (``csrc/noblank_lattice.cu``, ``csrc/blank_lattice.cu``) from the
lattice width: it must fit the block's shared memory, be one of the chunks
the kernels are built for, and refuse a width past its limit before any
launch.  The ctypes argument types of every ``extern "C"`` launcher are
held against the source's own parameter list: a slip there passes a pointer
as an int, or shifts every argument by one, and nothing else would notice.
And each build of ``probes/shard_sweep.py`` changes its source in exactly
the places it names.
"""

import ctypes
import re

import pytest
import torch

from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.probes import shard_sweep

FAMILIES = {"noblank": dict(weights=2), "blank": dict(weights=3, mask_bytes=1)}
# the plan's chunk boundaries: the widest width of each chunk and the next
BOUNDARIES = {"noblank": (818, 819, 2526, 2527), "blank": (658, 659, 2057,
                                                          2058)}
LIMIT = {"noblank": 5282, "blank": 4385}  # the widest width one row fits


def _bytes(family, width, chunk):
    """The kernels' shared-memory layout in bytes (``shard_floats_per_cell``
    floats and the mask bytes per cell)."""
    spec = FAMILIES[family]
    floats = (2 + spec["weights"]) * chunk + 5 + spec["weights"]
    return width * (4 * floats + spec.get("mask_bytes", 0))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("width", [1, 24, 49, 64, 65, "b0", "b1", "b2", "b3",
                                   4097, "limit"])
def test_shard_backward_plan_fits_and_takes_the_largest_chunk(family, width):
    if width == "limit":
        width = LIMIT[family]
    elif isinstance(width, str):
        width = BOUNDARIES[family][int(width[1])]
    chunk, threads, smem = lc.shard_backward_plan(width, **FAMILIES[family])
    assert chunk in lc.SHARD_CHUNKS and chunk & (chunk - 1) == 0
    assert smem == _bytes(family, width, chunk) <= lc.SMEM_LIMIT == 232_448
    # no larger chunk would fit
    assert all(_bytes(family, width, c) > lc.SMEM_LIMIT
               for c in lc.SHARD_CHUNKS if c > chunk)
    # one block size: the kernels' launch bounds, whole warps
    assert threads == lc.SHARD_THREADS == 512


def test_shard_backward_plan_chunks_at_the_main_widths():
    # the main and long-T shard widths all take 16-row chunks
    for family, width in (("noblank", 64), ("noblank", 24), ("blank", 65),
                          ("blank", 49)):
        assert lc.shard_backward_plan(width, **FAMILIES[family])[0] == 16
    for family, (w16, w4, w4b, w1) in BOUNDARIES.items():
        chunks = [lc.shard_backward_plan(w, **FAMILIES[family])[0]
                  for w in (w16, w4, w4b, w1)]
        assert chunks == [16, 4, 4, 1], family


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shard_backward_plan_refuses_wider_rows(family):
    width = LIMIT[family] + 1
    with pytest.raises(ValueError, match=f"width {width}"):
        lc.shard_backward_plan(width, **FAMILIES[family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shard_backward_kernel_refuses_the_width_before_any_launch(family):
    width = LIMIT[family] + 1
    alpha = torch.zeros((2, 1, width))
    lens = torch.ones(1, dtype=torch.int32)
    row = torch.zeros((1, width))
    bar = torch.zeros(1)
    counts = lc.launch_counts if family == "noblank" else bl.launch_counts
    before = dict(counts)
    with pytest.raises(ValueError, match=f"width {width}"):
        if family == "noblank":
            lc.noblank_shard_grad_kernel(alpha, lens, lens, bar, row, row,
                                         row)
        else:
            bl.blank_shard_grad_kernel(alpha, row.to(torch.uint8), lens,
                                       lens, bar, row, row, row)
    assert counts == before


def _launchers(source):
    """``name -> [parameter, ...]`` of the ``extern "C"`` block of
    ``csrc/<source>``."""
    text = (cuda_build.CSRC / source).read_text()
    block = text[text.index('extern "C" {'):]
    return {m[1]: [" ".join(p.split()) for p in m[2].split(",")]
            for m in re.finditer(r"cudaError_t\s+(\w+)\(([^)]*)\)\s*\{",
                                 block)}


def test_every_kernel_source_has_signatures():
    sources = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    assert sources == sorted(cuda_build.SIGNATURES)


@pytest.mark.parametrize("source", sorted(cuda_build.SIGNATURES))
def test_launcher_parameters_match_the_ctypes_signatures(source):
    launchers = _launchers(source)
    signatures = cuda_build.SIGNATURES[source]
    assert sorted(launchers) == sorted(signatures)
    for name, params in launchers.items():
        kinds = []
        for p in params:
            if "*" in p or p.startswith("cudaStream_t "):
                kinds.append(ctypes.c_void_p)
            elif p.startswith("int "):
                kinds.append(ctypes.c_int)
            else:
                pytest.fail(f"{source}::{name}: unexpected parameter {p!r}")
        assert params[-1].startswith("cudaStream_t "), name
        assert tuple(kinds) == tuple(signatures[name]), name


def test_launcher_parser_reads_pointers_ints_and_the_stream():
    params = _launchers("noblank_lattice.cu")["noblank_shard_backward"]
    assert params[0] == "const float* alpha"
    assert params[7] == "float* g"
    assert params[10:16] == ["int T", "int B", "int L", "int chunk",
                             "int threads", "int smem"]
    assert params[-1] == "cudaStream_t stream"


@pytest.mark.parametrize("family", ["noblank", "blank"])
@pytest.mark.parametrize("build", list(shard_sweep.DEFAULT_BUILDS))
def test_sweep_builds_change_the_source_where_they_say(family, build):
    text = (cuda_build.CSRC / f"{family}_lattice.cu").read_text()
    got = shard_sweep.variant_source(text, family, build)
    assert (got == text) == (build == "source")
    for old, new in shard_sweep._EDITS["backward"].get(build, {}).get(
            family, []):
        assert text.count(old) == 1 and got.count(new) >= 1


def test_sweep_refuses_an_unknown_build():
    with pytest.raises(ValueError, match="unknown build"):
        shard_sweep.variant_source("", "noblank", "rows64")
