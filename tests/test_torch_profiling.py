"""The span recorder of ``ctc_tpu_torch.utils.profiling``: off it is one
shared no-op; on, spans nest by thread and carry the trainer's step; their
times lie on the profiler's clock; a process keeps its set-up's spans
unswitched, and at most ``KEPT`` of a name; and the program opens them where its layers meet (the CLI's
set-up, each step's phases, the I3D's endpoints, the TimeSformer's parts
of each block, timed on the device too where it runs on a card), also
into a ``--profile-dir`` trace."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.data.loading import Prefetcher
from ctc_tpu_torch.models.i3d import ENDPOINTS, InceptionI3d
from ctc_tpu_torch.models.timesformer import TimeSformer
from ctc_tpu_torch.utils import profiling
from ctc_tpu_torch.utils.profiling import span

SETUP = ["ctc/data/dataset", "ctc/models/build", "ctc/models/init",
         "ctc/train/init"]
STEP = ["ctc/train/wait", "ctc/train/to_device", "ctc/train/zero_grad",
        "ctc/models/head", "ctc/ops/loss", "ctc/train/backward",
        "ctc/train/optimizer", "ctc/train/read", "ctc/train/log"]


@pytest.fixture
def recorder(monkeypatch):
    """The recorder as a process starts it: off, in set-up, empty; as it
    was after the test."""
    for name, value in (("_kept", []), ("_counts", {}), ("_on", False),
                        ("_setup", True), ("_step", None)):
        monkeypatch.setattr(profiling, name, value)
    return profiling


def _cli(tmp_path, *extra):
    return main(["--dataset", "synthetic", "--epochs", "1",
                 "--batch-size", "4", "--temporal", "6",
                 "--extract-feat-dim", "8", "--v-class", "7",
                 "--cache-dir", str(tmp_path), "--name", "spans",
                 "--print-train-freq", "100", "--print-test-freq", "100",
                 "--device", "cpu", *extra])


def test_off_is_one_shared_no_op(recorder):
    recorder.set_step(1)  # past the set-up, no profiler, not switched on
    assert span("ctc/a") is span("ctc/b") is profiling.OFF
    with span("ctc/a") as s:
        assert s is None
    assert recorder.spans() == []


def test_spans_nest_with_parents_and_steps_on_each_thread(recorder):
    recorder.record(True)
    recorder.set_step(5)

    def decoded():
        for i in range(3):
            with span("ctc/data/decode"):
                with span("ctc/data/inner"):
                    pass
            yield i

    with span("ctc/train/wait") as wait:
        got = list(Prefetcher(decoded, depth=1))
    assert got == [0, 1, 2]
    kept = recorder.spans()
    assert [s.name for s in kept][-1] == "ctc/train/wait"
    assert wait.parent is None and wait.thread == threading.get_ident()
    worker = [s for s in kept if s.name.startswith("ctc/data/")]
    assert len(worker) == 6
    assert {s.thread for s in worker} - {wait.thread} == {worker[0].thread}
    for s in worker:
        assert s.step == 5
        assert s.start_ns <= s.end_ns
        if s.name == "ctc/data/inner":
            assert s.parent.name == "ctc/data/decode"
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
        else:
            assert s.parent is None  # the worker's own stack


def test_threads_lose_no_span_and_keep_their_own_parents(recorder):
    """More threads than cores open nested spans with the interpreter
    switching threads as often as it can: every span is kept once, under
    its own thread's parent."""
    recorder.record(True)
    threads, depth = 16, 200

    def work(i):
        for _ in range(depth):
            with span(f"ctc/data/outer{i}"):
                with span(f"ctc/data/inner{i}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    kept = recorder.spans()
    assert len(kept) == 2 * threads * depth
    for s in kept:
        if "inner" in s.name:
            assert s.parent.name == s.name.replace("inner", "outer")
            assert s.parent.thread == s.thread
        else:
            assert s.parent is None


def test_span_lies_within_its_profiler_event(recorder):
    """The span's times are ``time.time_ns()``, the clock of the
    profiler's events: it lies inside its own range's event, within
    0.5 ms at each end."""
    recorder.set_step(1)  # past the set-up: kept for the profiler alone
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("ctc/train/outer") as outer:
            torch.ones(64, 64).sum()
            with span("ctc/train/inner") as inner:
                torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert recorder.spans() == [inner, outer]  # kept under a profiler
    for s in (outer, inner):
        e = events[s.name]
        assert e.start_ns() <= s.start_ns <= e.start_ns() + 500_000
        assert e.end_ns() - 500_000 <= s.end_ns <= e.end_ns()
    assert inner.parent is outer


def test_setup_is_kept_unswitched_until_the_first_step_ends(recorder):
    """Set-up and step 0 are kept, at most ``KEPT`` spans of a name."""
    for _ in range(profiling.KEPT + 3):
        with span("ctc/models/i3d/Mixed_3b"):
            pass
    with span("ctc/data/dataset"):
        pass
    recorder.set_step(0)
    with span("ctc/ops/build/noblank_lattice.cu"):
        pass
    recorder.set_step(1)
    assert span("ctc/train/wait") is profiling.OFF
    kept = [(s.name, s.step) for s in recorder.spans()]
    assert kept == ([("ctc/models/i3d/Mixed_3b", None)]
                    * profiling.KEPT
                    + [("ctc/data/dataset", None),
                       ("ctc/ops/build/noblank_lattice.cu", 0)])
    recorder.set_step(0)  # set-up ends once a process
    assert span("ctc/train/wait") is profiling.OFF
    recorder.record(True)  # recording keeps spans past set-up, as many
    with span("ctc/train/wait"):
        pass
    assert recorder.spans()[-1].name == "ctc/train/wait"
    recorder.record(False)
    assert span("ctc/train/wait") is profiling.OFF


def test_a_profiler_keeps_at_most_kept_spans_of_a_name(recorder,
                                                       monkeypatch):
    """Under a long profile the kept list stops growing at ``KEPT`` spans
    of a name, while each span still opens its range in the trace."""
    monkeypatch.setattr(profiling, "KEPT", 5)
    recorder.set_step(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(8):
            with span("ctc/train/read"):
                pass
    assert [s.name for s in recorder.spans()] == ["ctc/train/read"] * 5
    assert sum(e.name() == "ctc/train/read"
               for e in prof.profiler.kineto_results.events()) == 8


def test_cli_records_setup_once_and_each_step_in_order(recorder, tmp_path):
    recorder.record(True)
    _cli(tmp_path)
    kept = recorder.spans()
    assert all(s.name.startswith("ctc/") for s in kept)
    setup = [s for s in kept if s.step is None]
    assert sorted(s.name for s in setup) == SETUP
    init = next(s for s in setup if s.name == "ctc/models/init")
    assert init.parent.name == "ctc/train/init"
    train = [s for s in kept if s.step is not None
             and s.name != "ctc/train/wait"
             and "ctc/train/backward" in {t.name for t in kept
                                          if t.step == s.step}]
    steps = sorted({s.step for s in train})
    assert steps == list(range(len(steps))) and len(steps) >= 2
    for step in steps:
        names = [s.name for s in kept if s.step == step]
        assert names == STEP, (step, names)


def test_a_group_of_k_steps_is_one_group_span(recorder, tmp_path):
    recorder.record(True)
    _cli(tmp_path, "--steps-per-dispatch", "2")
    kept = recorder.spans()
    groups = [s for s in kept if s.name == "ctc/train/group"]
    assert groups and [s.step for s in groups] == list(
        range(0, 2 * len(groups), 2))
    for g in groups:
        inner = [s for s in kept if s.parent is g]
        assert [s.name for s in inner].count("ctc/models/head") == 2


def test_i3d_opens_one_span_per_endpoint(recorder):
    recorder.record(True)
    model = InceptionI3d(final_endpoint="Mixed_3c", num_classes=None)
    clips = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 4, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        model(clips)
    names = [n for n, _ in ENDPOINTS]
    want = [f"ctc/models/i3d/{n}"
            for n in names[:names.index("Mixed_3c") + 1]]
    kept = recorder.spans()
    assert [s.name for s in kept] == want + ["ctc/models/i3d/avg_pool",
                                             "ctc/models/i3d"]
    assert all(s.parent is kept[-1] for s in kept[:-1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_timesformer_keeps_its_parts_of_each_block(recorder, request,
                                                   device):
    """Under ``record(True)`` a forward of the 12 blocks keeps 12
    ``temporal``, ``spatial`` and ``mlp`` spans inside
    ``ctc/models/timesformer``, beside ``embed`` and ``norm``; each has a
    device time on the card and none on the CPU."""
    if device == "cuda":
        request.getfixturevalue("card")
    recorder.record(True)
    model = TimeSformer(img_size=32, frames=2, dim=64, depth=12,
                        num_heads=1).to(device)
    with torch.no_grad():
        model(torch.zeros((1, 2, 2, 32, 32, 3), device=device))
    kept = recorder.spans()
    top = kept[-1]
    assert top.name == "ctc/models/timesformer" and top.device_s is None
    parts = [s.name.rsplit("/", 1)[1] for s in kept[:-1]]
    assert parts == ["embed"] + ["temporal", "spatial", "mlp"] * 12 + [
        "norm"]
    assert all(s.parent is top for s in kept[:-1])
    for s in kept[:-1]:
        if device == "cuda":
            assert s.device_s > 0
        else:
            assert s.device_s is None


def test_device_spans_off_are_the_shared_no_op(recorder):
    """With the recorder off a span that would time the device is the
    same no-op as any other, and a forward keeps nothing."""
    recorder.set_step(1)
    for device in (torch.device("cpu"), torch.device("cuda")):
        assert span("ctc/models/timesformer/temporal",
                    device=device) is profiling.OFF
    with torch.no_grad():
        TimeSformer(img_size=32, frames=2, dim=64, depth=2, num_heads=1)(
            torch.zeros((1, 1, 2, 32, 32, 3)))
    assert recorder.spans() == []


def test_profile_dir_trace_holds_the_spans(recorder, tmp_path):
    trace_dir = tmp_path / "trace"
    _cli(tmp_path, "--profile-dir", str(trace_dir))
    (found,) = trace_dir.glob("*.json")
    names = {e.get("name", "") for e in
             json.loads(found.read_text())["traceEvents"]}
    assert {n for n in STEP if n != "ctc/train/wait"} <= names
    # kept while the profiler recorded, the first epoch's steps
    assert {s.name for s in recorder.spans()} >= set(STEP[1:])
