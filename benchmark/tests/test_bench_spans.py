"""The readers of the program's spans on hand-made spans and records, and
the device record's reduction with the program's host ranges in it."""

import statistics
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, program_spans, spec, trace
from benchmark.tests import parked
from ctc_tpu_torch.utils import profiling

MS = 1_000_000  # ns
CELL = {"check_steps": 3, "warmup_steps": 2}


def _span(name, start_ms, end_ms, step=None):
    return SimpleNamespace(name=name, start_ns=int(start_ms * MS),
                           end_ns=int(end_ms * MS), step=step)


@pytest.fixture
def spans(monkeypatch):
    def use(found):
        monkeypatch.setattr(program_spans, "program_spans", lambda: found)
    return use


def _read(metric, record):
    return spec.reader(metric).read(record)


SETUP_SPANS = [
    _span("ctc/data/build/decoder", 0, 400),
    _span("ctc/data/dataset", 500, 1500),
    _span("ctc/models/build", 1500, 1800),
    _span("ctc/models/init", 2000, 2500),
    _span("ctc/train/init", 1900, 3000),
    _span("ctc/data/decode", 3000, 5000),
    _span("ctc/data/decode", 4000, 6000),  # another thread's, overlapping
    _span("ctc/ops/build/noblank_lattice.cu", 7000, 7250, step=0),
    _span("ctc/train/read", 7300, 7310, step=0),
    _span("ctc/data/decode", 8000, 9000, step=4),  # not kept by a program
    _span("ctc/data/decode", 20000, 21000, step=5),  # in the window
    _span("ctc/ops/build/blank_lattice.cu", 20000, 20100, step=40),
]


@pytest.mark.parametrize("metric,want", [
    ("setup_data_s", 0.4 + 1.0 + 3.0),
    ("setup_build_s", 0.25),
    ("setup_init_s", 0.3 + 1.1),
])
def test_setup_readers(spans, metric, want):
    """Set-up's and step 0's spans count, nested or overlapping ones once;
    a later step's do not."""
    spans(SETUP_SPANS)
    assert _read(metric, {"cell": CELL}) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["setup_data_s", "setup_build_s",
                                    "setup_init_s", "step_turnaround_ms"])
def test_readers_give_none_without_spans(spans, metric):
    spans(None)
    record = {"cell": CELL, "profile": {"device": [("k", 1.0, 2.0)]}}
    assert _read(metric, record) is None


def test_setup_reader_reads_zero_where_a_layer_has_no_span(spans):
    spans([_span("ctc/data/dataset", 0, 10)])
    assert _read("setup_build_s", {"cell": CELL}) == 0.0


def test_step_turnaround_is_the_idle_that_holds_each_read(spans):
    """Each turn: the idle interval that holds the read's end, less the
    wait for the next batch inside it; the median over the turns."""
    # kernels (seconds): busy 10.000-10.100, idle to 10.103, busy to
    # 10.200, idle to 10.225, busy to 10.300, idle to 10.302, busy to
    # 10.400, idle to 10.404, busy to 10.5
    device = [("a", 10.000, 10.060), ("b", 10.050, 10.100),
              ("c", 10.103, 10.200), ("d", 10.225, 10.300),
              ("e", 10.302, 10.400), ("f", 10.404, 10.500)]
    spans([_span("ctc/train/read", 5000, 5001, step=0),        # set-up
           _span("ctc/train/read", 10090, 10101, step=7),      # idle 3 ms
           _span("ctc/train/wait", 10101.5, 10102, step=8),
           _span("ctc/train/read", 10190, 10201, step=8),      # 25 ms,
           _span("ctc/train/wait", 10201, 10221, step=9),      # 20 waited
           _span("ctc/train/read", 10250, 10260, step=9),      # busy: 0
           _span("ctc/train/read", 10390, 10401, step=10),     # idle 4 ms
           _span("ctc/train/read", 10490, 10501, step=11)])    # past last
    got = _read("step_turnaround_ms", {"cell": CELL,
                                       "profile": {"device": device}})
    assert got == pytest.approx(statistics.median([2.5, 5, 0, 4]),
                                abs=1e-6)


def test_union_and_gaps():
    assert program_spans.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [
        [0, 4], [5, 6]]
    assert program_spans.idle_gaps([("a", 0.0, 2.0), ("b", 1.0, 3.0),
                                    ("c", 5.0, 6.0)]) == [(3.0, 5.0)]


def test_covered_s_counts_overlaps_once():
    assert program_spans.covered_s([(0, 2 * MS), (MS, 3 * MS),
                                    (5 * MS, 6 * MS)]) == pytest.approx(4e-3)
    assert program_spans.covered_s([]) == 0.0


class _Event:
    def __init__(self, name, begin, end, device):
        self._args = name, begin, end, device

    def name(self):
        return self._args[0]

    def start_ns(self):
        return int(self._args[1] * 1e9)

    def end_ns(self):
        return int(self._args[2] * 1e9)

    def device_type(self):
        return self._args[3]


def test_reduce_names_gaps_by_program_ranges_and_counts_kernels_only():
    """The program's ranges are host events (function ranges: the profiler
    lays no copy of them on the device); the device's work is its kernels
    and copies alone, the benchmark's mirrored range left out."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Event("ctc/train/read", 1.000, 1.010, cpu),
        _Event("ctc/train/log", 1.010, 1.016, cpu),
        _Event("benchmark: data wait", 1.016, 1.017, cpu),
        _Event("benchmark: data wait", 1.0, 1.1, cuda),
        _Event("ctc/models/i3d/Mixed_3b", 1.017, 1.030, cpu),
        _Event("aten::conv3d", 1.018, 1.020, cpu),
        _Event("kernel_a", 1.000, 1.009, cuda),
        _Event("kernel_b", 1.021, 1.030, cuda),
        _Event("Memcpy HtoD", 1.030, 1.031, cuda),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    out = trace.reduce(prof, steps=1, window_s=0.031)
    assert [k[0] for k in out["kernels"]] == ["kernel_a", "kernel_b"]
    assert out["busy_s"] == pytest.approx(0.019)
    (name, gap), = out["breakdown"]["idle_gaps"]
    assert name == "ctc/train/log" and gap == pytest.approx(0.012)


NEW = ("step_turnaround_ms", "setup_data_s", "setup_build_s", "setup_init_s")


def test_a_traced_run_reads_the_program_spans(tmp_path, monkeypatch):
    """A whole traced run on the CPU, at a small size, from a recorder as
    a process starts it: the set-up readers read its real spans; the
    profiled steps' reads and waits are kept for the turn's reader, which
    has no device record to read on the CPU."""
    for name, value in (("_kept", []), ("_counts", {}), ("_on", False),
                        ("_setup", True), ("_step", None)):
        monkeypatch.setattr(profiling, name, value)
    cell = parked.cell("features-default", tmp_path)
    cell.update(train_videos=40, val_videos=10, warmup_steps=2,
                profile_steps=3)
    cell["per_layer"] += [m for m in spec.benchmark()["per_layer"]
                          if m["name"] in NEW]
    r = harness.run_cell(cell["name"], 2**31 + 5, 0.3, True, device="cpu",
                         root_dir=str(tmp_path / "run"), cell=cell)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items() if k in NEW}
    assert set(got) == set(NEW) - {"step_turnaround_ms"}
    assert got["setup_data_s"] > 0 and got["setup_init_s"] > 0
    assert got["setup_build_s"] == 0.0  # no kernel library on the CPU
    kept = profiling.spans()
    setup = {s.name for s in kept if s.step is None}
    assert {"ctc/data/dataset", "ctc/models/build",
            "ctc/train/init"} <= setup
    # step 0, then the profiled steps (the window and the steps before it
    # are not kept); each read is followed by the next step's wait
    steps = sorted({s.step for s in kept if s.name == "ctc/train/read"})
    assert steps[0] == 0 and len(steps) >= 1 + cell["profile_steps"]
    assert steps[1] > cell["check_steps"] + cell["warmup_steps"]
    reads = [s for s in kept if s.name == "ctc/train/read"]
    waits = [s for s in kept if s.name == "ctc/train/wait"]
    for read in reads[1:-1]:
        nxt = next(w for w in waits if w.step == read.step + 1)
        assert read.end_ns <= nxt.start_ns
