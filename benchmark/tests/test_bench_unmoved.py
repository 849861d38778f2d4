"""What the two pixels cells and the parked features cell read stays what
it was before the model-specific steps moved into the configurations'
reference modules: the initial weights, the reference's batches and
steps, a whole small run's check numbers and the FLOPs ``mfu`` divides
by, bit for bit.  The values below were computed on the CPU by the harness
as it stood before that move (torch 2.13), with the thread counts these
tests set, since a CPU reduction's order follows the thread count."""

import hashlib
import json

import pytest
import torch

from benchmark import harness, spec
from benchmark.reference import train as ref_train
from benchmark.tests import parked

SEED = 2**31 + 21
WEIGHTS = {
    "i3d-lstm-charades":
        "dd27736b2d010c55014d3c88d9f9c71763ef6bc85887bfaf69fddaaa2501e47c",
    "lstm-head-charades":
        "84a064af07b2e74668183b231cf1fe00db8cb812edb6dc58cae934506dc7dad8",
}
#: batches, then first gradient and parameters, of two reference steps at
#: B=2, T=4 on 20 videos (4 threads)
PIXELS = {
    "pixels-frozen-resident": (
        [12.878087997436523, 12.891777992248535],
        "9bfc89747b42ee32fb70351e7a99dcc51fe04f6bf65fbefa9ce7b29da5e2d609",
        "5ed70e1d571b991c83fd2c56e8defbac4c24f2846df936f5943a3a7e77e9c0a5"),
    "pixels-finetune-resident": (
        [13.02784252166748, 13.217053413391113],
        "9bfc89747b42ee32fb70351e7a99dcc51fe04f6bf65fbefa9ce7b29da5e2d609",
        "592e4cb1297ff58e4f11c8412351766c78c81cad87b1d13c65daecbd25f572e2"),
}
#: a small run of the parked features cell as test_bench_faults runs it
#: (1 thread)
FEATURES_LOSSES = [31.235681533813477, 31.68512535095215, 31.2392520904541]
FEATURES_CHECKS = {"batch_mismatches": 0, "input_gap": 0.0,
                   "loss_gap": 6.105615548316331e-08,
                   "grad_gap": 1.9986089681948096e-07,
                   "change_gap": 7.436187086760882e-06}
#: mfu of a fixed record: (window steps, value)
MFU = {"pixels-frozen-resident": (285, 30.931032121136266),
       "pixels-finetune-resident": (65, 19.543997043909837)}


@pytest.fixture
def threads():
    saved = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(saved)


def _digest(named):
    h = hashlib.sha256()
    for name, value in named:
        h.update(name.encode())
        h.update(torch.as_tensor(value).detach().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_initial_weights_are_the_parents(name):
    conf = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    model = spec.model(conf)
    w = ref_train.initial_weights(model, model.shapes(conf), SEED, "cpu")
    assert _digest(w.items()) == WEIGHTS[name]


@pytest.mark.parametrize("name", sorted(PIXELS))
def test_pixels_reference_steps_are_the_parents(name, threads, tmp_path):
    threads(4)
    cell = spec.cell(name)
    cell.update(train_videos=20, val_videos=10, batch_size=2)
    cell["config"] = {**cell["config"], "geometry": {
        **cell["config"]["geometry"], "temporal": 4}}
    paths = harness.write_inputs(cell, SEED, str(tmp_path / "run"),
                                 str(tmp_path / "corpus"))
    model = spec.model(cell["config"])
    w = ref_train.initial_weights(model, model.shapes(cell["config"]), SEED,
                                  "cpu")
    batches = harness.reference_batches(cell, paths, SEED, 2)
    out = harness.reference_steps(cell, batches, w, SEED, "cpu")
    losses, want_batches, want_steps = PIXELS[name]
    assert out["losses"] == losses
    assert _digest((k, b[k]) for b in batches for k in sorted(b)) \
        == want_batches
    assert _digest((k, v) for part in ("grad1", "params")
                   for k, v in out[part].items()) == want_steps


def test_features_run_gives_the_parents_numbers(threads, tmp_path,
                                                monkeypatch):
    threads(1)
    seen = {}
    steps = harness.reference_steps

    def recording(*args, **kwargs):
        seen.update(steps(*args, **kwargs))
        return seen

    monkeypatch.setattr(harness, "reference_steps", recording)
    cell = parked.cell("features-default", tmp_path)
    cell.update(train_videos=40, val_videos=10, warmup_steps=1,
                profile_steps=2)
    r = harness.run_cell(cell["name"], SEED, 0.3, False, device="cpu",
                         root_dir=str(tmp_path / "run"), cell=cell)
    assert seen["losses"] == FEATURES_LOSSES
    assert {k: c["value"] for k, c in r["checks"].items()} \
        == FEATURES_CHECKS
    assert r["correct"]


@pytest.mark.parametrize("name", sorted(MFU))
def test_mfu_reads_the_parents_value(name):
    steps, value = MFU[name]
    record = {"window_steps": steps, "window_s": 50.0371,
              "cell": spec.cell(name),
              "device_name": "NVIDIA H100 80GB HBM3"}
    assert spec.reader("mfu").read(record) == value
