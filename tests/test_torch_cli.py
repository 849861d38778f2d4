"""ctc_tpu_torch's command-line entry point on the CPU: it writes the same CSV
files with the same columns as ctc_tpu's, resumes and evaluates, refuses
CUDA without a card, and refuses every flag whose code is not ported."""

import csv

import pytest
import torch

from ctc_tpu.cli.main import main as jax_main
from ctc_tpu_torch.cli.main import main

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


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(TINY + ["--epochs", "1", "--cache-dir", str(tmp_path)])


@pytest.mark.parametrize(
    "flags,item",
    [
        (["--data-parallel", "2"], "item 14"),
        (["--model-parallel", "2"], "item 14"),
        (["--seq-parallel", "2"], "item 14"),
        (["--num-hosts", "2"], "item 14"),
        (["--steps-per-dispatch", "2"], "item 14"),
        (["--accum-grad", "2"], "item 14"),
        (["--profile-dir", "trace"], "item 14"),
        (["--skip-nonfinite"], "item 14"),
        (["--grad-norm-freq", "2"], "item 14"),
        (["--max-restarts", "1"], "item 14"),
        (["--compute-dtype", "bf16"], "item 16"),
        (["--loss", "blank"], "item 7"),
        (["--loss", "joint"], "item 8"),
        (["--decode"], "item 9"),
        (["--decode-beam", "2"], "item 9"),
        (["--decode-align"], "item 9"),
        (["--video-eval"], "item 10"),
        (["--transition-metrics"], "item 10"),
        (["--dataset", "charades_ctc_next_pred"], "item 11"),
        (["--dataset", "charades_pixels"], "item 12"),
    ],
    ids=lambda x: x if isinstance(x, str) else x[0].lstrip("-"),
)
def test_unported_flags_raise(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        main(TINY + ["--epochs", "1", "--device", "cpu",
                     "--cache-dir", str(tmp_path)] + flags)
