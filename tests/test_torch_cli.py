"""ctc_tpu_torch's command-line entry point on the CPU: it writes the same CSV
files with the same columns as ctc_tpu's, resumes and evaluates, trains the
blank loss and decodes from its checkpoint, draws the same synthetic batches
as ctc_tpu's loader, refuses CUDA without a card, runs the one-card
trainer flags as ctc_tpu's CLI does, and refuses every flag whose code is
not ported; ``--evaluate`` prints the video mAP, reads
``--groundtruth-lookup`` and writes the ``--my-dataset`` predictions."""

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
from ctc_tpu_torch.models import LSTMHead

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
    # the synthetic loader's val_video split adds the video mAP, as in
    # ctc_tpu
    assert set(metrics) == {"loss", "top1", "top5", "video_mAP"}


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
        (["--compute-dtype", "bf16"], "item 16"),
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


def _score_rows(run_dir):
    with open(run_dir / "score.csv", newline="") as f:
        return [[float(c) for c in row] for row in csv.reader(f)]


@pytest.mark.parametrize(
    "flags",
    [["--steps-per-dispatch", "2"], ["--accum-grad", "2"],
     ["--profile-dir", "TRACE"], ["--skip-nonfinite"],
     ["--grad-norm-freq", "2"], ["--max-restarts", "1"]],
    ids=lambda f: f[0].lstrip("-"),
)
def test_trainer_feature_flags_run_like_jax(tmp_path, monkeypatch, flags):
    """The one-card trainer flags (ROADMAP item 14's first half) run to
    the end on the CPU, and score.csv matches ctc_tpu's CLI run under the
    same flags from the same initial weights, dropout off: the epoch, the
    train and val losses to rtol 1e-5, top-1 and top-5 exactly."""
    from ctc_tpu.train import Trainer as JaxTrainer
    from ctc_tpu_torch.models import lstm_head_from_jax
    from ctc_tpu_torch.train import Trainer
    from torch_trainer_pair import np_tree

    weights = {}
    jax_init = JaxTrainer.init_state

    def jax_init_keeping_weights(self, batch):
        state = jax_init(self, batch)
        weights["jax"] = lstm_head_from_jax(np_tree(state.params),
                                            np_tree(state.batch_stats))
        return state

    port_init = Trainer.init_state
    monkeypatch.setattr(JaxTrainer, "init_state", jax_init_keeping_weights)
    monkeypatch.setattr(Trainer, "init_state",
                        lambda self, state_dict=None:
                        port_init(self, weights["jax"]))
    argv = TINY + ["--epochs", "2", "--dropout", "0"]
    runs = {}
    for pkg, entry, extra in (("jax", jax_main, ["--lattice-impl", "xla"]),
                              ("torch", main, ["--device", "cpu"])):
        trace = str(tmp_path / f"{pkg}_trace")
        history = entry(argv + [trace if f == "TRACE" else f for f in flags]
                        + extra + ["--cache-dir", str(tmp_path / pkg)])
        assert len(history) == 2
        runs[pkg] = _score_rows(tmp_path / pkg / "test")
    want, got = runs["jax"], runs["torch"]
    assert [r[0] for r in got] == [r[0] for r in want] == [0, 1]
    np.testing.assert_allclose([r[1:3] for r in got], [r[1:3] for r in want],
                               rtol=1e-5)
    assert [r[3:] for r in got] == [r[3:] for r in want]
    if flags[0] == "--profile-dir":
        assert len(list((tmp_path / "torch_trace").glob("*.json"))) == 1


@pytest.mark.parametrize(
    "flags,keys",
    [
        (["--video-eval"], {"mAP"}),
        (["--transition-metrics"], {"trans_top1", "trans_top5",
                                    "recall_top1", "recall_top5"}),
        (["--loss", "joint"], set()),
        (["--loss", "joint", "--joint-object-weight", "2"], set()),
    ],
    ids=["video-eval", "transition-metrics", "joint", "joint-object-weight"],
)
def test_evaluation_and_joint_flags_train(tmp_path, flags, keys):
    """The flags of ROADMAP items 8 and 10 train on the CPU; each adds its
    keys to the val metrics."""
    history = main(TINY + ["--epochs", "1", "--device", "cpu",
                           "--cache-dir", str(tmp_path)] + flags)
    assert len(history) == 1
    assert {"loss", "top1", "top5"} | keys == set(history[0]["val"])
    assert np.isfinite(history[0]["train"]["loss"])


def test_video_eval_scores_like_jax(tmp_path):
    """--video-eval --transition-metrics: the same CSV files and columns
    as ctc_tpu's run (score.csv gains the mAP column), each epoch's mAP
    is its checkpoint's score, and --evaluate from that checkpoint prints
    the same video mAP."""
    flags = ["--epochs", "2", "--video-eval", "--transition-metrics"]
    jax_history = jax_main(TINY + flags + ["--lattice-impl", "xla",
                                           "--cache-dir",
                                           str(tmp_path / "jax")])
    history = main(TINY + flags + ["--device", "cpu",
                                   "--cache-dir", str(tmp_path / "torch")])
    run = tmp_path / "torch" / "test"
    assert (_csv_shapes(run) == _csv_shapes(tmp_path / "jax" / "test")
            == {"score.csv": {6}, "test_log.csv": {5}, "train_log.csv": {5}})
    assert set(history[0]["val"]) == set(jax_history[0]["val"])
    rows = list(csv.reader(open(run / "score.csv", newline="")))
    maps = [h["val"]["mAP"] for h in history]
    assert [float(r[5]) for r in rows] == maps
    assert sorted(p.name for p in run.glob("model_*.txt")) == [
        f"model_{e:03d}_{m:.4f}.txt" for e, m in enumerate(maps)]
    metrics = main(TINY + ["--evaluate", "--device", "cpu", "--cache-dir",
                           str(tmp_path / "torch"), "--resume", str(run)])
    assert metrics["video_mAP"] == pytest.approx(maps[-1], rel=0, abs=1e-12)


def _evaluate(tmp_path, capsys, extra):
    """Train one epoch, then --evaluate from its checkpoint with
    ``extra``; returns ``(metrics, stdout of the evaluation)``."""
    cache = str(tmp_path / "run")
    base = TINY + ["--device", "cpu", "--cache-dir", cache]
    main(base + ["--epochs", "1"])
    capsys.readouterr()
    metrics = main(base + ["--evaluate", "--resume",
                           str(tmp_path / "run" / "test")] + extra)
    return metrics, capsys.readouterr().out


def test_evaluate_prints_the_video_map(tmp_path, capsys):
    metrics, out = _evaluate(tmp_path, capsys, [])
    assert f"video mAP: {metrics['video_mAP']:.4f}" in out
    assert "not ported" not in out and "skipped" not in out
    assert np.isfinite(metrics["video_mAP"])


def test_evaluate_reads_the_groundtruth_lookup(tmp_path, capsys):
    """A --groundtruth-lookup pickle overrides the rebuilt table: the
    rebuilt table gives the rebuilt mAP, a table with other verbs another
    one, each equal to evaluate_videos against that table."""
    from ctc_tpu_torch.eval.video import evaluate_videos
    from ctc_tpu_torch.utils.groundtruth import save_groundtruth

    cfg = config.parse(TINY + ["--cache-dir", str(tmp_path)])
    data, table = synthetic.get_val_video(cfg)
    shifted = {vid: [[s, o, (v + 1) % cfg.v_class] for s, o, v in rows]
               for vid, rows in table.items()}
    rebuilt, out = _evaluate(tmp_path, capsys, [])
    for name, gt in (("same.p", table), ("shifted.p", shifted)):
        path = str(tmp_path / name)
        save_groundtruth(path, gt)
        metrics, out = _evaluate(tmp_path, capsys,
                                 ["--groundtruth-lookup", path])
        assert f"groundtruth lookup: {path} ({len(table)} videos)" in out
        model = LSTMHead(cfg.extract_feat_dim, cfg.head_classes)
        from ctc_tpu_torch.train import checkpoints
        from ctc_tpu_torch.train.trainer import TrainState, torch_style_adam

        state = TrainState(model, torch_style_adam(model.parameters()))
        checkpoints.load(str(tmp_path / "run" / "test"), state)
        want = evaluate_videos(model, data, gt, num_verbs=cfg.v_class)
        assert metrics["video_mAP"] == want["mAP"]
        if name == "same.p":
            assert metrics["video_mAP"] == rebuilt["video_mAP"]
        else:
            assert metrics["video_mAP"] != rebuilt["video_mAP"]


def test_evaluate_warns_about_a_missing_lookup(tmp_path, capsys):
    rebuilt, _ = _evaluate(tmp_path, capsys, [])
    missing = str(tmp_path / "nowhere.p")
    metrics, out = _evaluate(tmp_path, capsys,
                             ["--groundtruth-lookup", missing])
    assert (f"WARNING: --groundtruth-lookup {missing} not found; using the "
            "rebuilt gt table") in out
    assert "groundtruth lookup:" not in out
    assert metrics["video_mAP"] == rebuilt["video_mAP"]


def test_evaluate_writes_own_video_predictions(tmp_path, capsys,
                                               monkeypatch):
    """--my-dataset names a loader whose ``get`` gives dense windows with
    features: one CSV row of top-5 classes per window."""
    import sys
    import types

    from ctc_tpu_torch.data.synthetic import synthetic_val_video

    data, _ = synthetic_val_video(num_videos=3, windows_per_video=4,
                                  temporal=4, feat_dim=16)
    fake = types.ModuleType("ctc_tpu_torch.data.loaders.own_windows")
    fake.get = lambda cfg: (data, None)
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    _, out = _evaluate(tmp_path, capsys, ["--my-dataset", "own_windows"])
    path = tmp_path / "run" / "test" / "myvideo_predictions.csv"
    assert f"own-video predictions: 12 windows -> {path}" in out
    rows = list(csv.reader(open(path, newline="")))
    assert rows[0] == ["id", "window", "top1", "top2", "top3", "top4",
                       "top5"]
    assert [r[:2] for r in rows[1:]] == [
        [f"SYN{v:03d}", str(w)] for v in range(3) for w in range(4)]
    assert all(0 <= int(c) < 33 for r in rows[1:] for c in r[2:])


def test_evaluate_own_video_with_frames_names_item_12(tmp_path, capsys):
    """The own-video loaders extract features from frames on disk (item
    12): ctc_tpu's message reports it and the evaluation goes on."""
    frames = tmp_path / "my" / "YUME0"
    frames.mkdir(parents=True)
    for j in range(600):
        open(frames / f"YUME0-{j + 1:06d}.jpg", "wb").close()
    # the own-video windows at the preset's geometry
    metrics, out = _evaluate(tmp_path, capsys,
                             ["--rgb-my-data", str(tmp_path / "my"),
                              "--temporal", "10", "--gap", "2",
                              "--num-trans", "2"])
    assert "own-video eval skipped:" in out and "item 12" in out
    assert np.isfinite(metrics["video_mAP"])
    assert not (tmp_path / "run" / "test" / "myvideo_predictions.csv").exists()
