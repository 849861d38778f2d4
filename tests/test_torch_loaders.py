"""ctc_tpu_torch's Charades loaders and command-line runs on cached features,
on the CPU, against ctc_tpu's on one seeded Charades-format corpus
(``ctc_tpu_torch.data.charades_corpus``: CSVs, empty frames, feature
files): every registry loader's batches, the val_video and groundtruth
splits, the refusals of feature extraction, and the three runs the card's
smoke makes (the ``cli.exe`` preset with ``--loss noblank``,
``charades_ver2 --loss binary`` and ``charades_ver2_c_class --loss
blank``), each of which must learn and hold three train steps on its first
batch with a defined loss to ctc_tpu's, from the same weights, at
``tests/test_torch_trainer.py``'s tolerances (elements whose Adam input
sits near Adam's eps aside), and the c_class windows whose blank-CTC loss
is the sentinel's."""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ctc_tpu import config as jax_config
from ctc_tpu.losses.blank import ctc_loss as jax_blank_loss
from ctc_tpu.cli import exe as jax_exe
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.train.schedule import step_decay_schedule as jax_schedule
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu.train.trainer import make_train_step as jax_train_step
from ctc_tpu.train.trainer import torch_style_adam as jax_adam
from ctc_tpu_torch import config
from ctc_tpu_torch.cli import exe
from ctc_tpu_torch.cli.main import get_dataset, main
from ctc_tpu_torch.data.charades_corpus import write_corpus
from ctc_tpu_torch.losses.blank import ctc_loss as blank_loss
from ctc_tpu_torch.losses.blank import min_frames
from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
from ctc_tpu_torch.train.schedule import step_decay_schedule
from ctc_tpu_torch.train.trainer import (
    TrainState,
    make_train_step,
    to_device,
    torch_style_adam,
)

from test_torch_charades import assert_same
from test_torch_trainer import (
    LOSS_TOL,
    PARAM_ATOL,
    ZERO_GRAD_PARAMS,
    _bias_gap,
    _np_tree,
)

FEAT = 16
#: Adam's eps and second-moment decay in both packages (optax.scale_by_adam
#: and torch.optim.Adam defaults)
ADAM_EPS = 1e-8
ADAM_B2 = 0.999
#: Adam inputs with an RMS within this many eps are rounding-sensitive:
#: Adam's step lr u / (|u| + eps) moves by lr eps du / (|u| + eps)^2 for a
#: rounding du of u (the widest seen past PARAM_ATOL: 10.2 eps)
NEAR_EPS = 16
BN_STATS = ("feature_head.bn.running_mean", "feature_head.bn.running_var")
#: a blank-CTC loss past this is the lattice sentinel's (1e30) scale
SENTINEL_SCALE = 1e20
GEOMETRY = ["--temporal", "10", "--gap", "2", "--num-trans", "2"]
REGISTRY = ["charades", "charades_ctc_next_pred", "charades_ver2",
            "charades_ver3", "charades_ver2_c_class", "charades_my_pred",
            "myvideo", "myvideo_ver3", "myvideo_c_class", "synthetic"]
OWN_VIDEO = ["charades_my_pred", "myvideo", "myvideo_ver3",
             "myvideo_c_class"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    out = write_corpus(str(root), seed=1, train_videos=60, val_videos=16,
                       feat_dim=FEAT)
    out["root"] = root
    return out


def _paths(corpus):
    return ["--rgb-data", corpus["rgb_data"],
            "--train-file", corpus["train_file"],
            "--val-file", corpus["val_file"],
            "--features-dir", corpus["features_dir"],
            "--extract-feat-dim", str(FEAT)]


def _cfgs(corpus, tmp_path, extra):
    argv = GEOMETRY + _paths(corpus) + ["--batch-size", "4"] + extra
    return (config.parse(argv + ["--cache-dir", str(tmp_path / "torch")]),
            jax_config.parse(argv + ["--cache-dir", str(tmp_path / "jax")]))


def test_registry_modules_importable():
    for name in REGISTRY:
        mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{name}")
        assert callable(mod.get), name


LOADER_CASES = [
    ("charades_ctc_next_pred", "noblank"),
    ("charades_ctc_next_pred", "binary"),
    ("charades_ctc_next_pred", "joint"),
    ("charades", "binary"),
    ("charades_ver2", "binary"),
    ("charades_ver2_c_class", "blank"),
    ("charades_ver3", "ce"),
    ("charades_ver3", "bce"),
]


@pytest.mark.parametrize("dataset,loss", LOADER_CASES,
                         ids=[f"{d}-{l}" for d, l in LOADER_CASES])
def test_loader_batches_match(corpus, tmp_path, dataset, loss):
    cfg, jcfg = _cfgs(corpus, tmp_path, ["--dataset", dataset,
                                         "--loss", loss])
    mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{dataset}")
    jmod = importlib.import_module(f"ctc_tpu.data.loaders.{dataset}")
    got = mod.get(cfg)
    assert_same(got, jmod.get(jcfg))
    assert len(got[0]) >= 2 and len(got[1]) >= 1


@pytest.mark.parametrize("dataset,fn", [
    ("charades_ctc_next_pred", "get_val_video"),
    ("charades_ver2", "get_val_video"),
    ("charades_ver2", "get_future_groundtruth"),
])
def test_val_video_and_groundtruth_match(corpus, tmp_path, dataset, fn):
    cfg, jcfg = _cfgs(corpus, tmp_path, ["--dataset", dataset])
    mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{dataset}")
    jmod = importlib.import_module(f"ctc_tpu.data.loaders.{dataset}")
    got = getattr(mod, fn)(cfg)
    assert_same(got, getattr(jmod, fn)(jcfg))
    assert got if fn == "get_future_groundtruth" else got[1]


@pytest.mark.parametrize("dataset", ["charades", "charades_ctc_next_pred",
                                     "charades_ver2", "charades_ver3",
                                     "charades_ver2_c_class"])
def test_empty_splits_return_empty_batches(tmp_path, dataset):
    """A header-only CSV gives ([], []) and reads no features."""
    csv_path = tmp_path / "empty.csv"
    csv_path.write_text(
        "id,subject,scene,quality,relevance,verified,script,objects,"
        "descriptions,actions,length\n")
    cfg = config.parse(["--rgb-data", str(tmp_path / "rgb"),
                        "--train-file", str(csv_path),
                        "--val-file", str(csv_path),
                        "--cache-dir", str(tmp_path / "cache")])
    mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{dataset}")
    assert mod.get(cfg) == ([], [])


@pytest.mark.parametrize("dataset", ["charades_ctc_next_pred",
                                     "charades_ver2"])
def test_missing_features_file_raises(corpus, tmp_path, dataset):
    cfg, _ = _cfgs(corpus, tmp_path, ["--dataset", dataset])
    cfg.features_dir = str(tmp_path / "no_features")
    mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{dataset}")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        mod.get(cfg)


@pytest.mark.parametrize("dataset", ["charades_ctc_next_pred",
                                     "charades_ver2_c_class"])
def test_extraction_without_features_dir_raises(corpus, tmp_path, dataset,
                                                monkeypatch):
    """Without --features-dir a loader no longer raises: it extracts its
    features (ROADMAP item 12, ported) with the frozen I3D into
    ``<cache>/<key>_<split>``; here through a stub extractor that records
    the windows it is given (the I3D's own extraction is held to
    ctc_tpu's in tests/test_torch_pixels_extract.py).  The corpus's frames
    are empty files, so decoding them raises."""
    from ctc_tpu_torch.data.loaders import _common

    cfg, _ = _cfgs(corpus, tmp_path, ["--dataset", dataset])
    cfg.features_dir = ""
    cfg.device = "cpu"
    seen = []

    def extract(data, extractor, out_dir, **kw):
        seen.append((os.path.relpath(out_dir, cfg.cache), kw))
        n, t = len(data["ids"]), len(data["rgb_image_paths"][0])
        return np.zeros((n, t, FEAT), np.float32)

    monkeypatch.setattr(_common, "extract_split_features", extract)
    mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{dataset}")
    train, val = mod.get(cfg)
    assert len(train) and len(val)
    assert all(not b["feats"].any() for b in train)
    key = {"charades_ctc_next_pred": "features",
           "charades_ver2_c_class": "features_cclass"}[dataset]
    assert [d for d, _ in seen] == [f"{key}_train", f"{key}_val"]
    assert seen[0][1] == {"gap": 2, "inputsize": 224}
    monkeypatch.undo()
    with pytest.raises(OSError, match="cannot identify image file"):
        mod.get(cfg)


@pytest.mark.parametrize("dataset", OWN_VIDEO)
def test_own_video_loaders(tmp_path, dataset):
    """No frames: ctc_tpu's empty windows and no table.  Frames on disk:
    the features are extracted from them (ROADMAP item 12, ported); these
    frames are empty files, so decoding them raises, as in ctc_tpu."""
    argv = GEOMETRY + ["--rgb-my-data", str(tmp_path / "my"),
                       "--cache-dir", str(tmp_path / "cache")]
    mod = importlib.import_module(f"ctc_tpu_torch.data.loaders.{dataset}")
    jmod = importlib.import_module(f"ctc_tpu.data.loaders.{dataset}")
    got = mod.get(config.parse(argv))
    assert_same(got, jmod.get(jax_config.parse(argv)))
    assert len(got[0]["ids"]) == 0 and got[1] is None
    d = tmp_path / "my" / "YUME0"
    d.mkdir(parents=True)
    for j in range(600):
        open(d / f"YUME0-{j + 1:06d}.jpg", "wb").close()
    with pytest.raises(OSError, match="cannot identify image file"):
        mod.get(config.parse(argv + ["--device", "cpu"]))


def test_exe_preset_is_ctc_tpus():
    assert exe.PRESET == jax_exe.PRESET


#: the smoke's three runs: (entry point, flags before the path overrides)
RUNS = {
    "exe-noblank": (exe.run, []),
    "ver2-binary": (main, GEOMETRY + ["--dataset", "charades_ver2",
                                      "--loss", "binary"]),
    "c_class-blank": (main, GEOMETRY + ["--dataset", "charades_ver2_c_class",
                                        "--loss", "blank"]),
}


def _run_argv(corpus, tmp_path, name):
    entry, flags = RUNS[name]
    cache = str(tmp_path / "runs")
    argv = flags + _paths(corpus) + ["--cache-dir", cache,
                                     "--resume", str(tmp_path / "fresh"),
                                     "--device", "cpu"]
    return entry, argv


def _feasible(cfg, batch) -> np.ndarray:
    """Which windows of a batch have a defined loss: under ``--loss
    blank``, those whose input covers the target's ``min_frames``."""
    if cfg.loss != "blank":
        return np.ones(len(batch["target_lengths"]), bool)
    need = min_frames(batch["paths"], batch["target_lengths"]).numpy()
    return need <= batch["input_lengths"]


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_run_learns(corpus, tmp_path, name):
    """Each run trains.  Where a train window's blank-CTC target needs more
    frames than the window has (c_class at T=10, see
    test_infeasible_blank_windows_match_ctc_tpu), the epoch loss is at
    the sentinel's scale in both epochs, so learning shows in top-1."""
    entry, argv = _run_argv(corpus, tmp_path, name)
    history = entry(argv + ["--epochs", "2"])
    losses = [h["train"]["loss"] for h in history]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), losses
    cfg = config.parse((exe.PRESET if entry is exe.run else []) + argv)
    if all(_feasible(cfg, b).all() for b in get_dataset(cfg)[0]):
        assert losses[1] < losses[0], losses
        return
    assert min(losses) > SENTINEL_SCALE, losses
    top1 = [h["train"]["top1"] for h in history]
    assert top1[1] > top1[0], top1


def test_infeasible_blank_windows_match_ctc_tpu(corpus, tmp_path):
    """charades_ver2_c_class at the preset's T=10: a window's target is as
    long as T when its video has 10 or more action starts, and the
    reference's fill of class 0 (the blank id) past the window's starts
    cannot be skipped into, so some targets need more than T frames.  On
    this corpus, drawn to Charades' published means, ctc_tpu's blank loss
    is at the sentinel's scale on exactly the windows min_frames marks,
    and the port's per-window loss equals it on every window."""
    cfg, _ = _cfgs(corpus, tmp_path, ["--dataset", "charades_ver2_c_class",
                                      "--loss", "blank"])
    rng = np.random.default_rng(5)
    infeasible = 0
    for batch in get_dataset(cfg)[0]:
        logits = rng.standard_normal(
            (batch["feats"].shape[1], len(batch["paths"]), cfg.head_classes),
            dtype=np.float32)
        args = (batch["paths"], batch["input_lengths"],
                batch["target_lengths"])
        want = np.asarray(jax_blank_loss(jnp.asarray(logits), *args,
                                         reduction="none",
                                         implementation="xla"))
        got = blank_loss(torch.from_numpy(logits),
                         *(torch.from_numpy(a) for a in args),
                         reduction="none").numpy()
        np.testing.assert_allclose(got, want, **LOSS_TOL)
        bad = ~_feasible(cfg, batch)
        np.testing.assert_array_equal(want > SENTINEL_SCALE, bad)
        infeasible += int(bad.sum())
    assert infeasible > 0


def _adam_rms(jstate) -> dict:
    """Each parameter element's root mean square of its Adam inputs
    g + wd w so far on the ctc_tpu side, by torch name: the square root of
    ctc_tpu's bias-corrected second moment (after the first step, |g + wd
    w| itself).  Adam divides by it plus ADAM_EPS."""
    adam = next(s for s in jstate.opt_state
                if isinstance(s, optax.ScaleByAdamState))
    nu = lstm_head_from_jax(_np_tree(adam.nu), _np_tree(jstate.batch_stats))
    corr = 1.0 - ADAM_B2 ** int(adam.count)
    return {name: (v / corr).sqrt() for name, v in nu.items()
            if name not in BN_STATS}


def _assert_steps_close(model, jstate, k, mean_shift, lr, near_eps,
                        near=NEAR_EPS * ADAM_EPS):
    """test_torch_trainer.py's parameter check, except on the elements
    whose Adam input has had an RMS within ``near`` (NEAR_EPS Adam eps) at
    a step so far (``near_eps``, updated here): there Adam's step u / (|u|
    + eps) turns on a sum of cancelling f32 terms, so rounding moves it by
    a share of lr either way, as for the zero-gradient proj.bias, and the
    moved weight keeps it.  Those are held within 2 lr a step; every other
    element at PARAM_ATOL."""
    want = lstm_head_from_jax(_np_tree(jstate.params),
                              _np_tree(jstate.batch_stats))
    got = model.state_dict()
    got["feature_head.bn.running_mean"] = (
        got["feature_head.bn.running_mean"] - mean_shift)
    rms = _adam_rms(jstate)
    for name, r in rms.items():
        near_eps[name] = near_eps.get(name, False) | (r <= near)
    for name, w in want.items():
        dev = (got[name] - w).abs()
        if name in ZERO_GRAD_PARAMS:
            assert float(dev.max()) <= 2 * lr, name
            continue
        exempt = near_eps.get(name, torch.zeros_like(dev, dtype=torch.bool))
        held = torch.where(exempt, 0.0, dev)
        assert float(held.max()) <= PARAM_ATOL, (
            f"{name} step {k}: {int((held > PARAM_ATOL).sum())} elements "
            f"past {PARAM_ATOL}, max |dev| {float(held.max())}")
        assert float(dev.max()) <= 2 * lr * (k + 1), (name, k)
        wide = exempt & (dev > PARAM_ATOL)
        if wide.any():  # shown with -s
            print(f"{name} step {k}: {int(exempt.sum())} of {w.numel()} "
                  f"near eps; past {PARAM_ATOL}: |dev| "
                  f"{[f'{x:.3g}' for x in dev[wide].tolist()]}, Adam input "
                  f"RMS / eps {[f'{x:.3g}' for x in (rms[name][wide] / ADAM_EPS).tolist()]}")


@pytest.mark.parametrize("name", list(RUNS))
def test_three_train_steps_match_ctc_tpu(corpus, tmp_path, name):
    """The run's first Charades batch whose windows all have a defined
    loss, three steps from the same weights (dropout off) with the run's
    learning rate, weight decay and schedule, against ctc_tpu's train
    step."""
    entry, argv = _run_argv(corpus, tmp_path, name)
    if entry is exe.run:
        argv = exe.PRESET + argv
    cfg = config.parse(argv)
    train = get_dataset(cfg)[0]
    batch = next(b for b in train if _feasible(cfg, b).all())
    classes, (batch_size, temporal, _) = cfg.head_classes, batch["feats"].shape
    jmodel = JaxLSTMHead(hidden=classes, dropout_rate=0.0)
    variables = jmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((temporal, batch_size, FEAT)),
                            train=False)
    jparams, jstats = variables["params"], variables["batch_stats"]
    sched = (cfg.lr, cfg.lr_decay_rate, len(train))
    jstate = JaxTrainState.create(
        params=jparams, batch_stats=jstats,
        tx=jax_adam(jax_schedule(*sched), cfg.weight_decay))
    jstep = jax_train_step(jmodel, cfg.loss, "xla", 0.0)
    model = LSTMHead(FEAT, classes, dropout_rate=0.0)
    model.load_state_dict(lstm_head_from_jax(_np_tree(jparams),
                                             _np_tree(jstats)))
    state = TrainState(model, torch_style_adam(model.parameters(),
                                               cfg.weight_decay))
    step = make_train_step(cfg.loss, None, 0.0, step_decay_schedule(*sched))
    mean_shift = torch.zeros(classes)
    near_eps = {}
    for k in range(3):
        # running_mean += momentum * (batch mean of proj(x), bias included)
        mean_shift = 0.9 * mean_shift + 0.1 * _bias_gap(model, jstate.params)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        for key in ("top1", "top5"):
            assert float(m[key]) == pytest.approx(float(jm[key])), key
        _assert_steps_close(model, jstate, k, mean_shift, cfg.lr, near_eps)


def test_cli_refuses_cuda_without_a_card(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, argv = _run_argv(corpus, tmp_path, "exe-noblank")
    argv = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        exe.run(argv + ["--epochs", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(RUNS["ver2-binary"][1] + argv + ["--epochs", "1"])


def test_exe_without_features_dir_refuses_extraction(corpus, tmp_path):
    """The preset names I3D weights; without cached features they are read
    to extract features (ROADMAP item 12, ported), so a run whose preset
    weights file is missing stops there, naming it, before any step."""
    _, argv = _run_argv(corpus, tmp_path, "exe-noblank")
    i = argv.index("--features-dir")
    argv = argv[:i] + argv[i + 2:]
    with pytest.raises(FileNotFoundError, match="rgb_i3d_pretrained.pt"):
        exe.run(argv + ["--epochs", "1"])
