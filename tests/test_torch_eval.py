"""ctc_tpu_torch's video-level evaluation against ctc_tpu's on the CPU.

The mAP and relation modules are numpy on both sides and must agree
exactly on the same arrays (ties and rows without ground truth
included).  The model-driven functions (``score_windows``,
``evaluate_videos``, ``evaluate_videos_joint``, ``evaluate_own_video``)
run ctc_tpu's LSTM head and the port's from the same weights
(``lstm_head_from_jax``): window scores to rtol 1e-5 (f32 matmuls and the
LSTM recurrence sum in another order), mAPs to 1e-6.
"""

import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu import config as jax_config
from ctc_tpu import eval as jeval
from ctc_tpu.data import synthetic as jsynthetic
from ctc_tpu.data.loaders import synthetic as jax_loader
from ctc_tpu.eval import video as jvideo
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu.train.trainer import torch_style_adam as jax_adam
from ctc_tpu_torch import config
from ctc_tpu_torch import eval as teval
from ctc_tpu_torch.data import synthetic as tsynthetic
from ctc_tpu_torch.data.loaders import synthetic as loader
from ctc_tpu_torch.eval import video as tvideo
from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax

from test_torch_charades import assert_same

SEEDS = [0, 1, 2]
SCORE_RTOL = 1e-5
MAP_ATOL = 1e-6
T, F, V, O = 6, 16, 9, 5


def _scores_and_gt(rng, n=12, c=7):
    """Scores on a 0.5 grid (ties) and a multi-hot gt with empty rows and
    a class without positives."""
    scores = np.round(rng.standard_normal((n, c)) * 2) / 2
    gt = (rng.random((n, c)) < 0.3).astype(np.int64)
    gt[:2] = 0
    gt[:, -1] = 0
    return scores, gt


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["mean_average_precision", "charades_map"])
def test_map_matches_ctc_tpu(name, seed):
    scores, gt = _scores_and_gt(np.random.default_rng(seed))
    got = getattr(teval, name)(scores, gt)
    want = getattr(jeval, name)(scores, gt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("use_07", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_voc_ap_matches_ctc_tpu(seed, use_07):
    rng = np.random.default_rng(seed)
    rec = np.sort(rng.random(9)).astype(np.float32)
    prec = rng.random(9).astype(np.float32)
    assert (teval.voc_ap(rec, prec, use_07)
            == jeval.voc_ap(rec, prec, use_07))


def _relation_case(rng, videos=5, objects=6, verbs=8):
    """Per-video gt (o, v) pairs and best-first predictions with repeats;
    one gt video gets no prediction."""
    gt, pred = {}, {}
    for i in range(videos):
        vid = f"v{i}"
        gt[vid] = [(int(rng.integers(objects)), int(rng.integers(verbs)))
                   for _ in range(int(rng.integers(1, 4)))]
        if i == videos - 1:
            continue
        rows = [(float(np.round(rng.standard_normal(), 1)),
                 (int(rng.integers(objects)), int(rng.integers(verbs))))
                for _ in range(int(rng.integers(1, 30)))]
        pred[vid] = sorted(rows, key=lambda x: x[0], reverse=True)
    return gt, pred


@pytest.mark.parametrize("seed", SEEDS)
def test_tagging_and_relation_eval_match_ctc_tpu(seed):
    gt, pred = _relation_case(np.random.default_rng(seed))
    for vid in pred:
        got = teval.eval_tagging_scores(gt[vid], pred[vid])
        want = jeval.eval_tagging_scores(gt[vid], pred[vid])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert_same(teval.eval_visual_relation(pred, gt),
                jeval.eval_visual_relation(pred, gt))


@pytest.mark.parametrize("seed", SEEDS)
def test_compose_predictions_match_ctc_tpu(seed):
    rng = np.random.default_rng(seed)
    s, o, v = (np.round(rng.standard_normal(n), 1) for n in (16, 38, 33))
    assert (teval.compose_predictions(s, o, v)
            == jeval.compose_predictions(s, o, v))
    assert (teval.compose_ov_predictions(o, v)
            == jeval.compose_ov_predictions(o, v))
    assert (teval.compose_ov_predictions(o, v, keep_each=3, keep_total=5)
            == jeval.compose_ov_predictions(o, v, keep_each=3,
                                            keep_total=5))


def _video_case(rng, videos=6, windows=3, classes=V):
    """Window ids, per-window scores and a ``{vid: [[s, o, v]]}`` table
    (one video missing from the scores)."""
    ids = [f"vid{i}" for i in range(videos) for _ in range(windows)]
    scores = rng.standard_normal((len(ids), classes)).astype(np.float32)
    gt = {f"vid{i}": [[0, int(rng.integers(O)), int(rng.integers(V))]
                      for _ in range(int(rng.integers(1, 4)))]
          for i in range(videos + 1)}
    return ids, scores, gt


@pytest.mark.parametrize("seed", SEEDS)
def test_aggregate_and_video_map_match_ctc_tpu(seed):
    ids, scores, gt = _video_case(np.random.default_rng(seed))
    got = tvideo.aggregate_video_scores(ids, scores)
    want = jvideo.aggregate_video_scores(ids, scores)
    assert_same(got, want)
    for gt_col, classes in ((2, V), (1, O)):
        s = {vid: row[:classes] for vid, row in got.items()}
        g = tvideo.video_verb_map(s, gt, classes, gt_col)
        w = jvideo.video_verb_map(s, gt, classes, gt_col)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_video_relation_eval_matches_ctc_tpu(seed):
    rng = np.random.default_rng(seed)
    ids, scores, gt = _video_case(rng, classes=V + O)
    v = tvideo.aggregate_video_scores(ids, scores[:, :V])
    o = tvideo.aggregate_video_scores(ids, scores[:, V:])
    assert_same(tvideo.video_relation_eval(o, v, gt),
                jvideo.video_relation_eval(o, v, gt))


def _heads(classes, seed=4):
    """ctc_tpu's LSTM head and state, and the port's head with the same
    weights."""
    jmodel = JaxLSTMHead(hidden=classes, dropout_rate=0.0)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((T, 2, F), jnp.float32), train=False)
    stats = jax.tree_util.tree_map(lambda x: x + 0.1,
                                   variables["batch_stats"])
    jstate = JaxTrainState.create(params=variables["params"],
                                  batch_stats=stats, tx=jax_adam(1e-3))
    model = LSTMHead(F, classes, dropout_rate=0.0)
    model.load_state_dict(lstm_head_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, stats)))
    return jmodel, jstate, model


def _val_video(seed=0):
    return tsynthetic.synthetic_val_video(
        num_videos=7, windows_per_video=3, temporal=T, feat_dim=F, v_class=V,
        o_class=O, seed=seed)


@pytest.mark.parametrize("reduce", ["final", "mean"])
@pytest.mark.parametrize("batch_size", [10, 4])
def test_score_windows_matches_ctc_tpu(batch_size, reduce):
    jmodel, jstate, model = _heads(V)
    data, _ = _val_video()
    got = tvideo.score_windows(model, data["features"], batch_size, reduce)
    want = jvideo.score_windows(jmodel, jstate, data["features"], batch_size,
                                reduce)
    assert got.shape == (21, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=SCORE_RTOL,
                               atol=1e-6)


def test_score_windows_refuses_an_unknown_reduction():
    _, _, model = _heads(V)
    with pytest.raises(ValueError, match="reduce"):
        tvideo.score_windows(model, _val_video()[0]["features"],
                             reduce="max")


@pytest.mark.parametrize("gt_col", [2, 1])
def test_evaluate_videos_matches_ctc_tpu(gt_col):
    classes = V if gt_col == 2 else O
    jmodel, jstate, model = _heads(classes)
    data, gt = _val_video(seed=1)
    got = tvideo.evaluate_videos(model, data, gt, num_verbs=classes,
                                 gt_col=gt_col, batch_size=4)
    want = jvideo.evaluate_videos(jmodel, jstate, data, gt,
                                  num_verbs=classes, gt_col=gt_col,
                                  batch_size=4)
    assert np.isfinite(got["mAP"])
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=0,
                               atol=MAP_ATOL)
    np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"],
                               rtol=0, atol=MAP_ATOL)
    assert set(got["video_scores"]) == set(want["video_scores"])
    for vid, s in got["video_scores"].items():
        np.testing.assert_allclose(s, want["video_scores"][vid],
                                   rtol=SCORE_RTOL, atol=1e-6)


@pytest.mark.parametrize("reduce", ["final", "mean"])
def test_evaluate_videos_joint_matches_ctc_tpu(reduce):
    jmodel, jstate, model = _heads(V + O)
    data, gt = _val_video(seed=2)
    kw = dict(num_verbs=V, num_objects=O, reduce=reduce)
    got = tvideo.evaluate_videos_joint(model, data, gt, **kw)
    want = jvideo.evaluate_videos_joint(jmodel, jstate, data, gt, **kw)
    for key in ("mAP", "object_mAP", "relation_mAP"):
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=MAP_ATOL, err_msg=key)
    for key in ("recall_at", "prec_at"):
        assert set(got[key]) == set(want[key])
        for n, value in got[key].items():
            np.testing.assert_allclose(value, want[key][n], rtol=0,
                                       atol=MAP_ATOL, err_msg=f"{key} {n}")
    with pytest.raises(ValueError, match="joint head width"):
        tvideo.evaluate_videos_joint(model, data, gt, num_verbs=V,
                                     num_objects=O + 1)


def test_evaluate_own_video_matches_ctc_tpu(tmp_path):
    jmodel, jstate, model = _heads(V)
    data, _ = _val_video(seed=3)
    data["ids"] = ["YUME0"] * 12 + ["YUME1"] * 9
    got_csv, want_csv = tmp_path / "torch.csv", tmp_path / "jax.csv"
    got = tvideo.evaluate_own_video(model, data, out_csv=str(got_csv),
                                    topk=3)
    want = jvideo.evaluate_own_video(jmodel, jstate, data,
                                     out_csv=str(want_csv), topk=3)
    np.testing.assert_array_equal(got["topk"], want["topk"])
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=SCORE_RTOL, atol=1e-6)
    rows = list(csv.reader(open(got_csv, newline="")))
    assert rows == list(csv.reader(open(want_csv, newline="")))
    assert rows[0] == ["id", "window", "top1", "top2", "top3"]
    assert len(rows) == 22
    assert rows[1][:2] == ["YUME0", "0"] and rows[13][:2] == ["YUME1", "0"]


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_val_video_matches_ctc_tpu(seed):
    kw = dict(num_videos=5, windows_per_video=2, temporal=T, feat_dim=F,
              v_class=V, o_class=O, seed=seed)
    assert_same(tsynthetic.synthetic_val_video(**kw),
                jsynthetic.synthetic_val_video(**kw))


@pytest.mark.parametrize("loss", ["noblank", "binary", "joint"])
def test_synthetic_loader_val_video_matches_ctc_tpu(tmp_path, loss):
    argv = ["--dataset", "synthetic", "--extract-feat-dim", "8",
            "--temporal", "5", "--loss", loss, "--manual-seed", "3",
            "--cache-dir", str(tmp_path)]
    assert_same(loader.get_val_video(config.parse(argv)),
                jax_loader.get_val_video(jax_config.parse(argv)))


def test_head_is_object_space_matches_ctc_tpu(tmp_path):
    for loss in ("noblank", "binary", "blank", "joint", "ce", "bce", "mlce"):
        argv = ["--loss", loss, "--cache-dir", str(tmp_path)]
        assert (config.parse(argv).head_is_object_space
                == jax_config.parse(argv).head_is_object_space), loss


def test_eval_package_exports_ctc_tpus_names():
    assert set(teval.__all__) == set(jeval.__all__)
    for name in teval.__all__:
        assert callable(getattr(teval, name))


def test_score_windows_runs_on_the_models_device(monkeypatch):
    """Each batch goes to the model's device; the scores come back as
    numpy."""
    _, _, model = _heads(V)
    seen = []
    real = tvideo._eval_logits

    def spy(m, feats):
        out = real(m, feats)
        seen.append((feats.shape[0], out.device.type))
        return out

    monkeypatch.setattr(tvideo, "_eval_logits", spy)
    data, _ = _val_video()
    scores = tvideo.score_windows(model, data["features"], batch_size=10)
    assert seen == [(10, "cpu"), (10, "cpu"), (1, "cpu")]
    assert isinstance(scores, np.ndarray)
    assert next(model.parameters()).device == torch.device("cpu")
