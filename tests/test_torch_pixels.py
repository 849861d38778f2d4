"""Pixels mode on the CPU: ctc_tpu_torch's I3DLSTM, its two-optimizer train
step, feature extraction and the ``charades_pixels`` command line against
ctc_tpu's, on one seeded Charades-format corpus of decodable JPEG frames
(``write_corpus(jpeg=True)``) and on seeded pixel batches.

Weights: the port's seeded ones carried to ctc_tpu (the backbone through
ctc_tpu's ``convert_torch_state_dict`` of a reference-layout file, the head
by :func:`head_to_jax`), or ctc_tpu's initial ones carried to the port by
``i3d_lstm_from_jax``.  Dropout is off.

Tolerances: a train step at ``Mixed_3c`` on 56 x 56 clips holds the loss to
rtol 1e-5 (``tests/test_torch_trainer.py``'s) and the backbone's running
statistics to rtol 1e-5.  The head's parameters are held to atol 2e-5
(0.002 lr) behind a frozen backbone: its input, the features, differs from
ctc_tpu's by up to 1.4e-6 (the convolutions' summation order), and Adam's
step lr g / (|g| + eps) turns that into up to 1e-5 where |g| is a few tens
of eps (measured: 7e-6 at 40 eps, LR 1e-2).  Under finetune the features
come from batch statistics, which both sides take as flax does, E[x^2] -
E[x]^2: on post-ReLU activations, whose mean is large against their spread,
that cancels, and the backbone's gradients then agree only to a few percent
(measured: 4.2% of the largest element at ``Conv3d_2c_3x3``'s kernel, 0.4%
to 1.7% elsewhere; 6e-6 relative on the loss).  So under finetune the
backbone's SGD step (lr g) is held to 5% of its largest element, and the
head to atol 2e-4 (measured 8e-5).  Excepted are
``feature_head.proj.bias`` and the running mean that carries it (zero
gradient up to rounding, which Adam normalizes into a step of up to lr),
and the head elements whose Adam input has had an RMS within 16 Adam eps
(``tests/test_torch_loaders.py``'s rule; the 12% of features that a random
backbone cut at ``Mixed_3c`` leaves at zero give such elements): those are
held within 2 lr an update.  The backbone's BatchNorm running statistics to rtol
1e-5.  The full-width runs (224 x 224, stack 10, 1024-d) hold the losses to
rtol 1e-4: the I3D's convolutions sum 2^17-deep in another order on each
side (features measured to 6e-7 absolute, ``tests/test_torch_i3d.py``).
Top-1 and top-5 exactly.
"""

import csv
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from ctc_tpu.cli.main import main as jax_main
from ctc_tpu.data import features as jax_features
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.models.i3d import InceptionI3d as JaxI3d
from ctc_tpu.models.i3d import convert_torch_state_dict
from ctc_tpu.train import Trainer as JaxTrainer
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu_torch import config
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.data import charades, features, native_loader
from ctc_tpu_torch.data.charades_corpus import write_corpus
from ctc_tpu_torch.data.synthetic import synthetic_feature_batches
from ctc_tpu_torch.models import I3DLSTM, i3d_lstm_from_jax
from ctc_tpu_torch.models.i3d import InceptionI3d
from ctc_tpu_torch.train import Trainer
from ctc_tpu_torch.train.trainer import to_device

from test_torch_i3d import randomize_bn

LR = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-6
HEAD_ATOL = 2e-5
FINETUNE_HEAD_ATOL = 2e-4
BACKBONE_RTOL = 0.05
BIAS_CARRIERS = ("head.feature_head.proj.bias",
                 "head.feature_head.bn.running_mean")
FULL_LOSS_RTOL = 1e-4
#: Adam inputs with an RMS within this many eps are rounding-sensitive
#: (``tests/test_torch_loaders.py``'s rule)
NEAR_EPS = 16
GEOMETRY = ["--temporal", "4", "--gap", "2", "--num-trans", "2"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def head_to_jax(sd, prefix="head."):
    """flax ``params`` / ``batch_stats`` of ctc_tpu's LSTMHead from the
    port's head ``state_dict`` (the inverse of ``lstm_head_from_jax``)."""
    g = {k[len(prefix):]: v.detach().numpy() for k, v in sd.items()
         if k.startswith(prefix)}
    params = {
        "feature_head": {
            "proj": {"kernel": g["feature_head.proj.weight"].T,
                     "bias": g["feature_head.proj.bias"]},
            "bn": {"scale": g["feature_head.bn.weight"],
                   "bias": g["feature_head.bn.bias"]},
        },
        "input_gates": {"kernel": g["input_gates.weight"].T,
                        "bias": g["input_gates.bias"]},
        "recurrent_kernel": g["recurrent_kernel"],
    }
    stats = {"feature_head": {"bn": {
        "mean": g["feature_head.bn.running_mean"],
        "var": g["feature_head.bn.running_var"]}}}
    return params, stats


def port_pixels_model(seed=0, **kw):
    model = I3DLSTM(hidden=33, dropout_rate=0.0, **kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    randomize_bn(model.i3d, seed)
    return model


class JaxPixels(fnn.Module):
    """ctc_tpu's I3DLSTM with the backbone cut at ``final_endpoint``,
    composed from ctc_tpu's InceptionI3d and LSTMHead as I3DLSTM composes
    them (its own backbone is always the full chain)."""

    final_endpoint: str = "Mixed_3c"
    freeze_backbone: bool = True

    @fnn.compact
    def __call__(self, clips, *, train=False):
        feats = JaxI3d(final_endpoint=self.final_endpoint, name="i3d")(
            clips, train=train and not self.freeze_backbone)
        if self.freeze_backbone:
            feats = jax.lax.stop_gradient(feats)
        feats = jnp.transpose(feats, (1, 0, 2)).astype(jnp.float32)
        return JaxLSTMHead(hidden=33, dropout_rate=0.0, name="head")(
            feats, train=train)


def jax_state(jtr, model):
    """ctc_tpu's train state of ``jtr`` holding the port ``model``'s
    weights (flax's init of the backbone is skipped: unjitted, it takes
    tens of seconds on the CPU)."""
    conv = convert_torch_state_dict(model.i3d.state_dict())
    head_params, head_stats = head_to_jax(model.state_dict())
    params = {"i3d": conv["params"], "head": head_params}
    stats = {"i3d": conv["batch_stats"], "head": head_stats}
    # copies: jnp.asarray of a numpy view of a tensor may share its memory,
    # which the port's step then updates in place while JAX still reads it
    copy = partial(jax.tree_util.tree_map, lambda a: jnp.array(np.array(a)))
    return JaxTrainState.create(params=copy(params),
                                batch_stats=copy(stats), tx=jtr.tx)


def adam_rms(opt):
    """Each head element's RMS of its Adam inputs so far: the square root
    of the port's bias-corrected second moment."""
    corr = 1.0 - 0.999 ** int(opt.count)
    return [(v / corr).sqrt() for v in opt.exp_avg_sq]


def pixel_batches(n, *, b=2, t=4, size=56, seed=0):
    """``n`` batches of seeded clips ``[b, t, 10, size, size, 3]`` with
    the synthetic loader's verb paths."""
    out = synthetic_feature_batches(num_batches=n, batch_size=b,
                                    temporal=t, feat_dim=1, num_classes=33,
                                    seed=seed)
    rng = np.random.default_rng(seed)
    for batch in out:
        batch["feats"] = rng.standard_normal(
            (b, t, 10, size, size, 3)).astype(np.float32)
    return out


@pytest.mark.parametrize("finetune", [False, True],
                         ids=["frozen", "finetune"])
def test_two_optimizer_steps_match_jax_at_mixed_3c(finetune):
    """Train steps of the pixels model (backbone cut at Mixed_3c, 56 x 56
    clips, B=4, T=4) through ctc_tpu_torch's Trainer with ``i3d_optimizer``
    against ctc_tpu's Trainer with the same dict: Adam on the head; SGD on
    the backbone under finetune (its BatchNorm on batch statistics, its
    running statistics moved), one step; nothing on a frozen backbone,
    which stays bit for bit unchanged over two steps."""
    batches = pixel_batches(1 if finetune else 2, b=4)
    opts = {"lr": LR, "momentum": 0.9, "weight_decay": 1e-4,
            "finetune": finetune}
    common = dict(loss_kind="noblank", lr=LR, weight_decay=1e-4, seed=0,
                  print_freq=1000, i3d_optimizer=opts)
    jtr = JaxTrainer(JaxPixels(freeze_backbone=not finetune),
                     implementation="xla", **common)
    model = port_pixels_model(final_endpoint="Mixed_3c",
                              freeze_backbone=not finetune)
    jstate = jax_state(jtr, model)
    tr = Trainer(model, device="cpu", **common)
    state = tr.init_state(model.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    head = [n for n, p in model.named_parameters()
            if not n.startswith("i3d.")]
    near = {}
    rng = jax.random.PRNGKey(0)
    for batch in batches:
        jstate, jm = jtr.train_step(jstate, batch, rng)
        state, m = tr.train_step(state, to_device(batch, "cpu"),
                                 tr.generator)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        for name, rms in zip(head, adam_rms(state.optimizer)):
            near[name] = near.get(name, False) | (rms <= NEAR_EPS * 1e-8)
    want = i3d_lstm_from_jax(np_tree(jstate.params),
                             np_tree(jstate.batch_stats))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        dev = (got[name] - w).abs()
        if name.startswith("i3d.") and "running" in name:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        elif name.startswith("i3d."):
            step = (w - before[name]).abs().max()
            assert float(dev.max()) <= BACKBONE_RTOL * float(step), name
        else:
            assert float(dev.max()) <= 2 * LR * len(batches), name
            if name in BIAS_CARRIERS:
                continue
            held = torch.where(near.get(name, torch.zeros_like(dev).bool()),
                               0.0, dev)
            atol = FINETUNE_HEAD_ATOL if finetune else HEAD_ATOL
            assert float(held.max()) <= atol, (name, float(held.max()))
    moved = [k for k in got if k.startswith("i3d.")
             and not torch.equal(before[k], got[k])]
    if finetune:
        assert moved == [k for k in got if k.startswith("i3d.")]
        assert int(model.i3d.Mixed_3b.b0.bn.num_batches_tracked) == 1
        assert len(state.optimizer.sgd.params) == len(
            list(model.i3d.parameters()))
    else:
        assert moved == []
        assert state.optimizer.sgd is None
        assert not any(p.requires_grad for p in model.i3d.parameters())
        assert all(p.grad is None for p in model.i3d.parameters())


def test_finetune_step_against_the_float64_step():
    """The Trainer's f32 finetune step at ``Mixed_3c`` (56 x 56 clips,
    B=4, T=4) against the exact step, the same forward and backward in
    float64 (the loss in f32: the lattice takes f32 only) and SGD's first
    update ``-lr (g + wd p)``: the loss and the running statistics to rtol
    1e-5, each backbone tensor's SGD step to 2% of its largest element
    (measured: 0.83% at ``Mixed_3c.b1a``'s BatchNorm bias, median 0.11%).
    ``chip_smoke.py`` holds the card's and the CPU's full-depth steps to
    the exact step the same way."""
    from ctc_tpu_torch.losses import LOSS_FNS

    batch = to_device(pixel_batches(1, b=4)[0], "cpu")
    model = port_pixels_model(final_endpoint="Mixed_3c",
                              freeze_backbone=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, device="cpu", lr=LR, weight_decay=1e-4,
                 i3d_optimizer={"lr": LR, "momentum": 0.9,
                                "weight_decay": 1e-4, "finetune": True})
    state = tr.init_state(model.state_dict())
    _, m = tr.train_step(state, batch, tr.generator)
    exact = port_pixels_model(final_endpoint="Mixed_3c",
                              freeze_backbone=False,
                              i3d_act_dtype=torch.float64).double()
    logits = exact(batch["feats"].double(), train=True)
    assert logits.dtype == torch.float64
    loss = LOSS_FNS["noblank"](logits.float(), batch["paths"],
                               batch["input_lengths"],
                               batch["target_lengths"])
    loss.backward()
    np.testing.assert_allclose(float(m["loss"]), float(loss.detach()),
                               rtol=1e-5)
    got, want = model.state_dict(), exact.state_dict()
    for name, p in exact.named_parameters():
        if name.startswith("i3d."):
            step = -LR * (p.grad + 1e-4 * p.detach())
            dev = ((got[name] - before[name]).double() - step).abs().max()
            assert float(dev) <= 0.02 * float(step.abs().max()), name
    for name in want:
        if name.startswith("i3d.") and "running" in name:
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_frozen_backbone_stays_out_of_the_gradient_exchange():
    """On a mesh the exchange's flat buffer holds the parameters that
    train and the running statistics of the modules that own them: a
    frozen backbone's are in neither; a finetuned one's are in both."""
    from ctc_tpu_torch.parallel.collectives import GradExchange

    for finetune in (False, True):
        model = I3DLSTM(hidden=33, final_endpoint="Mixed_3c",
                        freeze_backbone=not finetune)
        ex = GradExchange(model, None)
        part = model if finetune else model.head
        assert ex.n_grad == sum(p.numel() for p in part.parameters())
        assert ex.n_stats == sum(b.numel() for b in part.buffers()
                                 if b.is_floating_point())


@pytest.mark.parametrize("saved,resumed", [
    (False, False), (True, True), (False, True), (True, False)],
    ids=["frozen", "finetune", "frozen_to_finetune", "finetune_to_frozen"])
def test_optimizer_state_resumes_only_into_its_own_structure(saved,
                                                             resumed):
    """The optimizer's state loads into an optimizer of its own structure
    whole (moments, SGD trace, count, skipped); a frozen backbone's state
    resumed under --finetune-i3d, or the reverse, raises as ctc_tpu's
    restore against its template does, and leaves the state untouched."""
    from ctc_tpu_torch.train.optim import TorchStyleAdam, TorchStyleSGD

    def optimizer(finetune, seed):
        gen = torch.Generator().manual_seed(seed)
        head = [torch.randn(3, 4, generator=gen), torch.randn(4,
                                                              generator=gen)]
        i3d = [torch.randn(2, 3, 3, generator=gen)]
        sgd = TorchStyleSGD(i3d, lambda c: 0.1) if finetune else None
        opt = TorchStyleAdam(head, skip_nonfinite=True, sgd=sgd)
        for step in range(3):
            for p in opt.all_params:
                p.grad.copy_(torch.randn(p.shape, generator=gen)
                             * (float("nan") if step == 1 else 1.0))
            opt.step(torch.tensor(step), 0.01)
        return opt

    src = optimizer(saved, 0)
    assert int(src.count) == 2 and int(src.skipped) == 1
    dst = optimizer(resumed, 1)
    before = [t.clone() for t in dst.tensors()]
    if saved != resumed:
        with pytest.raises(ValueError, match="frozen"):
            dst.load_state_dict(src.state_dict())
        for cur, old in zip(dst.tensors(), before):
            assert torch.equal(cur, old)
        return
    dst.load_state_dict(src.state_dict())
    assert len(dst.tensors()) == len(src.tensors())
    for cur, want in zip(dst.tensors(), src.tensors()):
        assert torch.equal(cur, want)


def test_feat_chunk_equals_one_shot_and_guards_raise():
    """Chunked extraction of the folded clips equals one shot; the chunk's
    guards raise as ctc_tpu's do (in the model and at parse time)."""
    x = torch.from_numpy(pixel_batches(1, b=2, t=3)[0]["feats"])
    one = port_pixels_model(final_endpoint="Mixed_3c")
    chunked = I3DLSTM(hidden=33, dropout_rate=0.0, feat_chunk=2,
                      final_endpoint="Mixed_3c")
    chunked.load_state_dict(one.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(chunked(x), one(x), rtol=1e-6,
                                   atol=1e-6)
    bad = I3DLSTM(hidden=33, feat_chunk=4, final_endpoint="Mixed_3c")
    with pytest.raises(ValueError, match="must divide B\\*T=6"):
        bad(x)
    with pytest.raises(ValueError, match="requires freeze_backbone"):
        I3DLSTM(feat_chunk=2, freeze_backbone=False)
    with pytest.raises(ValueError, match="requires a frozen backbone"):
        config.parse(["--i3d-chunk", "10", "--finetune-i3d"])
    with pytest.raises(ValueError, match="must divide"):
        config.parse(["--i3d-chunk", "3", "--temporal", "10"])
    assert config.parse(["--i3d-chunk", "20", "--temporal", "10"]).i3d_chunk


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_corpus")
    out = write_corpus(str(root), seed=0, train_videos=4, val_videos=2,
                       feat_dim=16, jpeg=True)
    # checkpoints in the reference's layout: with its logits head, and
    # without (ctc_tpu's pixels CLI takes only the latter: it puts a
    # checkpoint's logits into the backbone's parameter tree, which its
    # optimizer state then does not match)
    model = port_pixels_model(seed=4)
    full = InceptionI3d()
    full.load_state_dict(model.i3d.state_dict(), strict=False)
    torch.save(full.state_dict(), root / "rgb_i3d.pt")
    torch.save(model.i3d.state_dict(), root / "rgb_i3d_backbone.pt")
    return out, str(root / "rgb_i3d.pt"), model


def paths(corpus):
    out, weights, _ = corpus
    return ["--rgb-data", out["rgb_data"], "--train-file", out["train_file"],
            "--val-file", out["val_file"]]


def score_rows(run_dir):
    with open(os.path.join(run_dir, "score.csv"), newline="") as f:
        return [[float(c) for c in row] for row in csv.reader(f)]


def test_extraction_matches_jax_and_reads_its_cache(corpus, tmp_path):
    """extract_split_features over the corpus's train windows with the
    reference-layout checkpoint equals ctc_tpu's; a second call returns
    the cached file, memory-mapped."""
    out, weights, _ = corpus
    labels = charades.parse_charades_csv(out["train_file"])
    counts = {v: charades.count_frames(out["rgb_data"], v) for v in labels}
    data, _ = charades.prepare_windows(labels, counts, "train", 4, 2, 2,
                                       rgb_root=out["rgb_data"])
    assert len(data["ids"]) >= 2
    model = InceptionI3d()
    model.load_state_dict(torch.load(weights))
    assert model.logits is not None
    got = features.extract_split_features(
        data, features.I3DFeatureExtractor(model, device="cpu"),
        str(tmp_path / "port"), gap=2, batch_size=2)
    jvars = convert_torch_state_dict(torch.load(weights))
    want = jax_features.extract_split_features(
        data, jax_features.I3DFeatureExtractor(jvars),
        str(tmp_path / "jax"), gap=2, batch_size=2)
    assert got.shape == (len(data["ids"]), 4, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    again = features.extract_split_features(data, None,
                                            str(tmp_path / "port"), gap=2)
    assert isinstance(again, np.memmap)
    np.testing.assert_array_equal(again, got)


def test_cli_pixels_matches_jax(corpus, tmp_path, monkeypatch, capsys):
    """``--dataset charades_pixels --device cpu`` for one epoch at 224 x
    224, stack 10, 1024-d (B=2, T=4, frozen backbone from
    ``--rgb-pretrained-weights``) writes ctc_tpu's score.csv: losses to
    rtol 1e-4, top-1 and top-5 exactly."""
    _, weights, model = corpus
    weights = weights.replace(".pt", "_backbone.pt")
    port_init = Trainer.init_state
    monkeypatch.setattr(JaxTrainer, "init_state",
                        lambda self, batch: jax_state(self, model))
    monkeypatch.setattr(Trainer, "init_state",
                        lambda self, sd=None: port_init(self,
                                                        model.state_dict()))
    argv = (["--dataset", "charades_pixels", "--batch-size", "2",
             "--epochs", "1", "--dropout", "0", "--lr", str(LR),
             "--rgb-pretrained-weights", weights] + GEOMETRY
            + paths(corpus))
    jax_main(argv + ["--lattice-impl", "xla",
                     "--cache-dir", str(tmp_path / "jax")])
    history = main(argv + ["--device", "cpu",
                           "--cache-dir", str(tmp_path / "torch")])
    printed = capsys.readouterr().out
    assert f"JPEG decoder: {native_loader.decoder()}" in printed
    assert "loaded pretrained I3D backbone" in printed
    assert len(history) == 1
    want = score_rows(tmp_path / "jax" / "test")
    got = score_rows(tmp_path / "torch" / "test")
    np.testing.assert_allclose([r[1:3] for r in got],
                               [r[1:3] for r in want], rtol=FULL_LOSS_RTOL)
    assert [r[3:] for r in got] == [r[3:] for r in want]


@pytest.mark.parametrize("flags", [
    ["--finetune-i3d"],
    ["--i3d-chunk", "4"],
    ["--compute-dtype", "bf16", "--i3d-act-dtype", "bf16"],
], ids=["finetune", "chunk", "bf16"])
def test_cli_pixels_flags_train(corpus, tmp_path, flags):
    """The pixels flags train at full width on the CPU: finite losses; the
    backbone moves only under --finetune-i3d (against the seed's initial
    weights); the checkpoint holds it, with the SGD momentum where it
    trains, and a run resumes from it; a resume that flips
    --finetune-i3d (the frozen bf16 run's checkpoint resumed finetuned,
    the finetuned one's resumed frozen) raises."""
    argv = (["--dataset", "charades_pixels", "--batch-size", "2",
             "--dropout", "0", "--device", "cpu", "--lr", str(LR),
             "--cache-dir", str(tmp_path)] + GEOMETRY + paths(corpus)
            + flags)
    history = main(argv + ["--epochs", "1"])
    assert np.isfinite(history[0]["train"]["loss"])
    ckpt = torch.load(tmp_path / "test" / "ckpt" / "0.pt",
                      weights_only=True)
    init = I3DLSTM(hidden=33)
    init.reset_parameters(torch.Generator().manual_seed(0))
    key = "i3d.Conv3d_1a_7x7.conv3d.weight"
    moved = not torch.equal(ckpt["model"][key], init.state_dict()[key])
    assert moved == (flags[0] == "--finetune-i3d")
    assert ("momentum" in ckpt["optimizer"]) == moved
    resume = ["--epochs", "2", "--resume", str(tmp_path / "test")]
    resumed = main(argv + resume)
    assert len(resumed) == 1 and np.isfinite(resumed[0]["train"]["loss"])
    if "--i3d-chunk" in flags:  # frozen only: flipping is a parse error
        return
    flipped = ([a for a in argv if a != "--finetune-i3d"] if moved
               else argv + ["--finetune-i3d"])
    with pytest.raises(ValueError, match="optimizer state does not match"):
        main(flipped + resume)


def test_cli_extracts_features_without_features_dir(corpus, tmp_path,
                                                    capsys):
    """A Charades dataset without --features-dir extracts its features
    with the frozen I3D (the --rgb-pretrained-weights checkpoint), caches
    them, trains the head on them, and reads the cache on the next run;
    without weights it warns, as ctc_tpu does."""
    _, weights, _ = corpus
    argv = (["--dataset", "charades_ctc_next_pred", "--batch-size", "2",
             "--device", "cpu", "--epochs", "1",
             "--cache-dir", str(tmp_path)] + GEOMETRY + paths(corpus))
    history = main(argv + ["--rgb-pretrained-weights", weights])
    assert np.isfinite(history[0]["train"]["loss"])
    cached = tmp_path / "test" / "features_train" / "features.npy"
    assert np.load(cached).shape[1:] == (4, 1024)
    stamp = os.stat(cached).st_mtime_ns
    printed = capsys.readouterr().out
    assert "JPEG decoder: pil (feature extraction)" in printed
    assert "WARNING: --rgb-pretrained-weights not set" not in printed
    main(argv + ["--rgb-pretrained-weights", weights])
    assert os.stat(cached).st_mtime_ns == stamp
    main(argv + ["--cache-dir", str(tmp_path / "random")])
    assert "WARNING: --rgb-pretrained-weights not set" in (
        capsys.readouterr().out)
