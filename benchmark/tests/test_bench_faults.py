"""Whole runs on the CPU, at a small size, with the timed path broken
underneath: each fault that a cell can have makes ``correct`` false, and
the unbroken run is correct."""

import numpy as np
import pytest

from benchmark import harness, spec
from benchmark.tests import parked
from ctc_tpu_torch import losses
from ctc_tpu_torch.data import native_loader
from ctc_tpu_torch.data.loaders import charades_ctc_next_pred
from ctc_tpu_torch.train.optim import TorchStyleAdam


def _small(cell, **kw):
    cell.update({"train_videos": 40, "val_videos": 10, "warmup_steps": 1,
                 "profile_steps": 2, **kw})
    return cell


def _run(cell, tmp_path, seed=2**31 + 21):
    return harness.run_cell(cell["name"], seed, 0.3, False, device="cpu",
                            root_dir=str(tmp_path / "run"), cell=cell)


def unchanged_state(monkeypatch):
    monkeypatch.setattr(TorchStyleAdam, "step", lambda self, *a, **k: {})


def half_batch(monkeypatch):
    full = losses.LOSS_FNS["noblank"]

    def half(logits, paths, inlen, tgt, **kw):
        n = logits.shape[1] // 2
        return full(logits[:, :n], paths[:n], inlen[:n], tgt[:n], **kw)

    monkeypatch.setitem(losses.LOSS_FNS, "noblank", half)


def altered_target(monkeypatch):
    collate = charades_ctc_next_pred.collate_verb_ctc

    def altered(data, idx, feats):
        batch = collate(data, idx, feats)
        batch["paths"][0, 0] = (batch["paths"][0, 0] + 1) % 33
        return batch

    monkeypatch.setattr(charades_ctc_next_pred, "collate_verb_ctc", altered)


def altered_loss(monkeypatch):
    full = losses.LOSS_FNS["noblank"]
    monkeypatch.setitem(losses.LOSS_FNS, "noblank",
                        lambda *a, **k: full(*a, **k) * 1.01)


def test_a_sound_run_is_correct(tmp_path):
    r = _run(_small(parked.cell("features-default", tmp_path)), tmp_path)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_target, altered_loss])
def test_a_fault_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    r = _run(_small(parked.cell("features-default", tmp_path)), tmp_path)
    assert not r["correct"], r["checks"]


def _small_frozen():
    cell = _small(spec.cell("pixels-frozen-resident"), batch_size=2,
                  train_videos=20)
    cell["config"] = {**cell["config"], "geometry": {
        **cell["config"]["geometry"], "temporal": 4}}
    return cell


@pytest.mark.parametrize("fault, number", [
    (unchanged_state, "change_gap_median"), (half_batch, "loss_gap_first")])
def test_a_frozen_fault_fails_its_number(fault, number, monkeypatch,
                                         tmp_path):
    """The frozen cell compares the first step's loss and the median
    leaf's gradient and change: a state left unchanged fails the change,
    half of each batch the first loss, each by far."""
    monkeypatch.setattr(native_loader, "build_error", "PIL, as on the card")
    fault(monkeypatch)
    r = _run(_small_frozen(), tmp_path)
    check = r["checks"][number]
    assert not r["correct"]
    assert check["value"] > 100 * check["limit"], r["checks"]


def test_an_altered_frame_is_not_correct(monkeypatch, tmp_path):
    """The resident cell, whose batches the data layer decodes in set-up,
    with one decoded value moved by a grey level."""
    monkeypatch.setattr(native_loader, "build_error", "PIL, as on the card")
    decode = native_loader.decode_frames

    def altered(paths, *a, **k):
        out = decode(paths, *a, **k)
        out[0, 0, 0, 0] += np.float32(2 / 255)
        return out

    monkeypatch.setattr(native_loader, "decode_frames", altered)
    r = _run(_small_frozen(), tmp_path)
    assert not r["correct"]
    assert r["checks"]["input_gap"]["value"] > 0
