"""ctc_tpu_torch's command-line entry point on the CPU: it writes the same CSV
files with the same columns as ctc_tpu's, resumes and evaluates, trains the
blank loss and decodes from its checkpoint, draws the same synthetic batches
as ctc_tpu's loader, refuses CUDA without a card, and refuses every flag
whose code is not ported."""

import csv

import numpy as np
import pytest
import torch

from ctc_tpu import config as jax_config
from ctc_tpu.cli.main import main as jax_main
from ctc_tpu.data.loaders import synthetic as jax_synthetic
from ctc_tpu_torch import config
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.data.loaders import synthetic

TINY = ["--dataset", "synthetic", "--extract-feat-dim", "16",
        "--batch-size", "4", "--temporal", "4", "--print-train-freq", "1",
        "--print-test-freq", "1"]


def _csv_shapes(run_dir):
    """{file name: set of row lengths} over the run's CSV logs."""
    out = {}
    for path in sorted(run_dir.glob("*.csv")):
        with open(path, newline="") as f:
            out[path.name] = {len(row) for row in csv.reader(f)}
    return out


def test_same_csv_files_and_columns_as_jax(tmp_path):
    jax_main(TINY + ["--epochs", "2", "--lattice-impl", "xla",
                     "--cache-dir", str(tmp_path / "jax")])
    history = main(TINY + ["--epochs", "2", "--device", "cpu",
                           "--cache-dir", str(tmp_path / "torch")])
    assert len(history) == 2
    want = _csv_shapes(tmp_path / "jax" / "test")
    got = _csv_shapes(tmp_path / "torch" / "test")
    assert set(want) == {"score.csv", "test_log.csv", "train_log.csv"}
    assert got == want
    assert (tmp_path / "torch" / "test" / "log.txt").exists()
    assert len(list((tmp_path / "torch" / "test").glob("model_*.txt"))) == 2


def test_resume_and_evaluate(tmp_path, capsys):
    cache = str(tmp_path / "run")
    main(TINY + ["--epochs", "1", "--device", "cpu", "--cache-dir", cache])
    history = main(TINY + ["--epochs", "2", "--device", "cpu",
                           "--cache-dir", cache,
                           "--resume", str(tmp_path / "run" / "test")])
    assert len(history) == 1  # epoch 1 only: epoch 0 came from the ckpt
    assert "resumed epoch 0" in capsys.readouterr().out
    metrics = main(TINY + ["--evaluate", "--device", "cpu",
                           "--cache-dir", cache,
                           "--resume", str(tmp_path / "run" / "test")])
    assert set(metrics) == {"loss", "top1", "top5"}


def test_blank_loss_trains_and_decodes(tmp_path):
    """--loss blank learns on the CPU (plain lattice), then --evaluate
    --decode (greedy and beam) decodes from its checkpoint, one CSV row per
    val window."""
    cache = str(tmp_path / "run")
    blank = TINY + ["--loss", "blank", "--c-class", "9", "--temporal", "8",
                    "--batch-size", "8", "--lr", "1e-2", "--device", "cpu",
                    "--cache-dir", cache]
    history = main(blank + ["--epochs", "4"])
    losses = [h["train"]["loss"] for h in history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    resume = ["--evaluate", "--decode", "--resume", str(tmp_path / "run" /
                                                        "test")]
    for extra in ([], ["--decode-beam", "4"]):
        metrics = main(blank + resume + extra)
        with open(metrics["decoded_csv"], newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["batch", "index", "length", "path"]
        assert len(rows) - 1 == 2 * 8
        for row in rows[1:]:
            path = [int(c) for c in row[3].split()]
            assert len(path) == int(row[2]) and 0 not in path


@pytest.mark.parametrize("loss", ["noblank", "blank"])
def test_synthetic_batches_match_jax_loader(tmp_path, loss):
    """The port's loader draws ctc_tpu's batches; under --loss blank the
    paths are capped at T/2 labels so every target is feasible."""
    argv = ["--dataset", "synthetic", "--extract-feat-dim", "8",
            "--batch-size", "3", "--temporal", "6", "--c-class", "11",
            "--loss", loss, "--cache-dir", str(tmp_path)]
    want = jax_synthetic.get(jax_config.parse(argv))
    got = synthetic.get(config.parse(argv))
    for got_split, want_split in zip(got, want):
        assert len(got_split) == len(want_split)
        for g, w in zip(got_split, want_split):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], np.asarray(w[key]))
    if loss == "blank":
        assert all(b["paths"].shape[1] == 3 for b in got[0])


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(TINY + ["--epochs", "1", "--cache-dir", str(tmp_path)])


@pytest.mark.parametrize(
    "flags,item",
    [
        (["--data-parallel", "2"], "item 14"),
        (["--model-parallel", "2"], "item 14"),
        (["--seq-parallel", "2", "--data-parallel", "2"], "item 14"),
        (["--num-hosts", "2"], "item 14"),
        (["--steps-per-dispatch", "2"], "item 14"),
        (["--accum-grad", "2"], "item 14"),
        (["--profile-dir", "trace"], "item 14"),
        (["--skip-nonfinite"], "item 14"),
        (["--grad-norm-freq", "2"], "item 14"),
        (["--max-restarts", "1"], "item 14"),
        (["--compute-dtype", "bf16"], "item 16"),
        (["--loss", "joint"], "item 8"),
        (["--video-eval"], "item 10"),
        (["--transition-metrics"], "item 10"),
        (["--dataset", "charades_pixels"], "item 12"),
        pytest.param(["--dataset", "charades_ctc_next_pred"], "item 12",
                     id="charades-without-features-dir-item 12"),
        (["--rgb-pretrained-weights", "rgb_i3d.pt"], "item 12"),
    ],
    ids=lambda x: x if isinstance(x, str) else x[0].lstrip("-"),
)
def test_unported_flags_raise(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        main(TINY + ["--epochs", "1", "--device", "cpu",
                     "--cache-dir", str(tmp_path)] + flags)
