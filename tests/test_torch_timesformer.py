"""The TimeSformer backbone (``--rgb-arch timesformer``) on the CPU at a
small size, against the benchmark's plain reference
(``benchmark/reference/timesformer_lstm.py``, written out from the
official ``vit.py``): features, logits, loss and gradients on seeded
weights with every block's ``temporal_fc`` drawn; the token layout; the
command line frozen and finetuned on a seeded JPEG corpus; the flags it
refuses; the benchmark cell's check, sound and with planted faults.

Small size: 2 blocks, 128 wide in 2 heads of 64 (the reference takes the
published head width), 4 frames of 32² in 16² patches, B=2, T=3.

Tolerances: in float64 the two sides compute the same sums in other
orders (a layout's view against the reference's permutes, the fused
attention against the written-out softmax), so the features, logits and
gradients agree to 1e-10 (1e-8 relative for the gradients, which the
lattice's log-adds sum); in float32, and for the loss, which the
program's lattice computes in float32, to 2e-5: rounding over a few
hundred terms a product.
"""

import functools

import numpy as np
import pytest
import torch

from benchmark import harness, spec
from benchmark.reference import lstm_head
from benchmark.reference import timesformer_lstm as ref
from benchmark.reference import train as ref_train
from ctc_tpu_torch import config as config_lib
from ctc_tpu_torch import losses
from ctc_tpu_torch.cli import main as cli_main
from ctc_tpu_torch.data import native_loader
from ctc_tpu_torch.data.charades_corpus import write_corpus
from ctc_tpu_torch.losses.noblank import no_blank_ctc_loss
from ctc_tpu_torch.models import TimeSformer, TimeSformerLSTM
from ctc_tpu_torch.models.timesformer import from_official
from ctc_tpu_torch.train.optim import TorchStyleAdam

SMALL = dict(img_size=32, frames=4, dim=128, depth=2, num_heads=2)
CONF = {"embed_dim": 128, "num_heads": 2, "depth": 2, "patch_size": 16,
        "mlp_ratio": 4, "stack": 4, "inputsize": 32, "feature_dim": 128,
        "hidden": 9}
B, T, KEEP = 2, 3, 0.7
F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=2e-5, atol=2e-5)


def _weights(dtype=torch.float32):
    """The reference's initial weights, LayerNorm and biases moved off
    their starts so that every term is seen."""
    w = ref_train.initial_weights(ref, ref.shapes(CONF), 7, "cpu")
    g = torch.Generator().manual_seed(8)
    return {k: (v + 0.1 * torch.randn(v.shape, generator=g)
                if v.dim() == 1 and "running_var" not in k else v).to(dtype)
            for k, v in w.items()}


def _model(w, *, finetune=False, dtype=torch.float32):
    model = TimeSformerLSTM(hidden=CONF["hidden"], dropout_rate=1 - KEEP,
                            freeze_backbone=not finetune, **SMALL)
    model.load_state_dict({k: w[k] if k in w else torch.zeros_like(v)
                           for k, v in model.state_dict().items()})
    return model.to(dtype)


def _batch(dtype=torch.float32):
    g = torch.Generator().manual_seed(9)
    lengths = torch.tensor([3, 1])
    paths = torch.randint(0, CONF["hidden"], (B, T), generator=g)
    paths[torch.arange(T)[None] >= lengths[:, None]] = -1
    clips = torch.rand((B, T, 4, 32, 32, 3), generator=g) * 2 - 1
    return {"feats": clips.to(dtype), "paths": paths,
            "target_lengths": lengths}


def _program_loss(model, batch, generator):
    """The program's logits, and its loss (the lattice takes float32)."""
    logits = model(batch["feats"], train=True, generator=generator)
    return no_blank_ctc_loss(logits.float(), batch["paths"],
                             torch.full((B,), T),
                             batch["target_lengths"]), logits


def test_names_and_shapes_are_the_references():
    conf = {**CONF, "embed_dim": 768, "num_heads": 12, "depth": 12,
            "stack": 8, "inputsize": 224, "feature_dim": 768, "hidden": 33}
    with torch.device("meta"):
        model = TimeSformerLSTM(hidden=33)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("tracked")}
    assert got == ref.shapes(conf)
    backbone = sum(v.numel() for k, v in model.named_parameters()
                   if k.startswith("timesformer."))
    assert backbone == 121_258_752  # the published 121.3 M without a head
    assert ref.timesformer_flops(1, **ref.widths(conf)) == pytest.approx(
        0.392e12, rel=2e-3)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, F64),
                                        (torch.float32, F32)],
                         ids=["f64", "f32"])
def test_features_logits_and_loss_match_the_reference(dtype, tol):
    w = _weights(dtype)
    assert all(w[f"timesformer.blocks.{i}.temporal_fc.weight"].abs().sum()
               > 0 for i in range(2))
    model, batch = _model(w, dtype=dtype), _batch(dtype)
    clips = batch["feats"].reshape((B * T,) + batch["feats"].shape[2:])
    with torch.no_grad():
        got = model.features(batch["feats"], train=False)
        want = ref.timesformer_features(lstm_head.sub(w, ref.PREFIX), clips)
    torch.testing.assert_close(got.reshape(B * T, -1), want, **tol)
    loss, logits = _program_loss(model, batch, torch.Generator()
                                 .manual_seed(5))
    mask = torch.empty((T, B, CONF["hidden"])).bernoulli_(
        KEEP, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(logits, lstm_head.head_logits(
        lstm_head.sub(w, "head."), want.reshape(B, T, -1).transpose(0, 1),
        mask.to(dtype), KEEP), **tol)
    ref_loss = ref.loss(w, batch, finetune=False, keep=KEEP,
                        generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(loss, ref_loss.float(), **F32)


@pytest.mark.parametrize("finetune", [False, True],
                         ids=["frozen", "finetune"])
def test_gradients_match_the_reference(finetune):
    """In float64, through the program's model and the reference's
    lattice (the program's takes float32 alone): frozen, the head's
    leaves' gradients (no backbone leaf has one); finetuned, every
    leaf's."""
    w = _weights(torch.float64)
    model = _model(w, finetune=finetune, dtype=torch.float64)
    batch = _batch(torch.float64)
    _, logits = _program_loss(model, batch,
                              torch.Generator().manual_seed(5))
    lstm_head.noblank_loss(logits, batch["paths"],
                           batch["target_lengths"]).backward()
    got = {k: p.grad for k, p in model.named_parameters() if p.requires_grad}
    assert any(k.startswith("timesformer.") for k in got) == finetune
    names = [k for k in w if ref.optimizer(k, finetune)]
    assert sorted(names) == sorted(got)
    leaves = {k: w[k].clone().requires_grad_(True) for k in names}
    want = torch.autograd.grad(
        ref.loss({**w, **leaves}, batch, finetune=finetune, keep=KEEP,
                 generator=torch.Generator().manual_seed(5)),
        list(leaves.values()))
    for k, g in zip(names, want):
        torch.testing.assert_close(got[k], g, rtol=1e-8, atol=1e-10,
                                   msg=k)


def test_temporal_part_mixes_each_patch_over_its_frames_alone():
    """One patch of one frame changed: after block 0's temporal part (its
    ``temporal_fc``), that patch's tokens change in every frame, and no
    other token does."""
    torch.manual_seed(0)
    model = TimeSformer(**SMALL).double()
    seen = []
    model.blocks[0].temporal_fc.register_forward_hook(
        lambda mod, args, out: seen.append(out.detach()))
    clips = torch.rand((1, 1, 4, 32, 32, 3), dtype=torch.float64)
    moved = clips.clone()
    moved[0, 0, 2, 16:, :16] += 0.5  # frame 2, patch (1, 0)
    with torch.no_grad():
        model(clips)
        model(moved)
    # b (h w t) m: [patch, frame, channel]
    diff = (seen[1] - seen[0]).abs().amax(-1).view(4, 4)
    patch = 1 * 2 + 0
    assert (diff[patch] > 1e-6).all()
    assert (diff[torch.arange(4) != patch] == 0).all()


def test_official_checkpoint_loads_without_its_classifier():
    torch.manual_seed(1)
    src = TimeSformerLSTM(**SMALL)
    official = {f"model.{k}": v for k, v in
                src.timesformer.state_dict().items()}
    official["model.head.weight"] = torch.zeros(400, 128)
    official["model.head.bias"] = torch.zeros(400)
    dst = TimeSformerLSTM(**SMALL)
    dst.load_backbone(official)
    for k, v in src.timesformer.state_dict().items():
        assert torch.equal(dst.timesformer.state_dict()[k], v), k
    assert from_official({"model.head.bias": 1}) == {}


@pytest.mark.parametrize("argv, match", [
    (["--rgb-arch", "timesformer", "--dataset", "charades_pixels",
      "--compute-dtype", "bf16"], "--compute-dtype bf16"),
    (["--rgb-arch", "timesformer", "--dataset", "charades_pixels",
      "--i3d-act-dtype", "bf16"], "--i3d-act-dtype bf16"),
    (["--rgb-arch", "timesformer"], "feature extraction"),
    (["--rgb-arch", "timesformer", "--dataset", "synthetic"],
     "--dataset synthetic"),
], ids=["compute-bf16", "act-bf16", "extraction", "features"])
def test_timesformer_refuses_what_it_does_not_take(argv, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        config_lib.parse(argv + ["--cache-dir", str(tmp_path)])


def test_an_unknown_rgb_arch_fails_at_parse_time(tmp_path, capsys):
    with pytest.raises(SystemExit):
        config_lib.parse(["--rgb-arch", "bogus", "--cache-dir",
                          str(tmp_path)])
    assert "invalid choice: 'bogus'" in capsys.readouterr().err
    for arch in ("i3d", "timesformer"):
        assert arch in config_lib.RGB_ARCHS
    with pytest.raises(ValueError, match="--rgb-arch"):
        config_lib.Config(rgb_arch="bogus",
                          cache_dir=str(tmp_path)).finalize()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_corpus")
    out = write_corpus(str(root), seed=0, train_videos=4, val_videos=2,
                       feat_dim=16, jpeg=True)
    torch.manual_seed(3)
    backbone = TimeSformer(**{**SMALL, "img_size": 224, "frames": 8})
    official = {f"model.{k}": v for k, v in backbone.state_dict().items()}
    torch.save(official, root / "timesformer_official.pt")
    return out, str(root / "timesformer_official.pt"), backbone


@pytest.mark.parametrize("finetune", [False, True],
                         ids=["frozen", "finetune"])
def test_cli_trains_timesformer(corpus, tmp_path, monkeypatch, capsys,
                                finetune):
    """``--rgb-arch timesformer`` through ``cli.main``: the backbone that
    ``build_model`` picks (narrowed to the small widths) sees clips of 8
    frames; the loss is finite; the official checkpoint is loaded; the
    backbone moves only under ``--finetune-i3d``, with SGD's momentum in
    the checkpoint; the run resumes."""
    out, weights, backbone = corpus
    small = {k: v for k, v in SMALL.items() if k not in ("img_size",
                                                          "frames")}
    monkeypatch.setattr(cli_main, "TimeSformerLSTM",
                        functools.partial(TimeSformerLSTM, **small))
    shapes = []
    forward = TimeSformer.forward

    def spy(self, clips, **kw):
        shapes.append(tuple(clips.shape))
        return forward(self, clips, **kw)

    monkeypatch.setattr(TimeSformer, "forward", spy)
    argv = ["--dataset", "charades_pixels", "--rgb-arch", "timesformer",
            "--batch-size", "2", "--temporal", "4", "--gap", "2",
            "--num-trans", "2", "--dropout", "0", "--device", "cpu",
            "--rgb-data", out["rgb_data"], "--train-file", out["train_file"],
            "--val-file", out["val_file"], "--cache-dir", str(tmp_path),
            "--rgb-pretrained-weights", weights]
    if finetune:
        argv.append("--finetune-i3d")
    history = cli_main.main(argv + ["--epochs", "1"])
    assert "loaded pretrained TimeSformer backbone" in capsys.readouterr().out
    assert np.isfinite(history[0]["train"]["loss"])
    assert shapes and set(shapes) == {(2, 4, 8, 224, 224, 3)}
    ckpt = torch.load(tmp_path / "test" / "ckpt" / "0.pt",
                      weights_only=True)["model"]
    key = "timesformer.blocks.0.temporal_attn.qkv.weight"
    moved = not torch.equal(ckpt[key],
                            backbone.state_dict()[key.split(".", 1)[1]])
    assert moved == finetune
    resumed = cli_main.main(argv + ["--epochs", "2", "--resume",
                                    str(tmp_path / "test")])
    assert len(resumed) == 1 and np.isfinite(resumed[0]["train"]["loss"])


def unchanged_state(monkeypatch):
    monkeypatch.setattr(TorchStyleAdam, "step", lambda self, *a, **k: {})


def half_batch(monkeypatch):
    full = losses.LOSS_FNS["noblank"]

    def half(logits, paths, inlen, tgt, **kw):
        n = logits.shape[1] // 2
        return full(logits[:, :n], paths[:n], inlen[:n], tgt[:n], **kw)

    monkeypatch.setitem(losses.LOSS_FNS, "noblank", half)


@pytest.mark.parametrize("fault, number", [
    (None, None), (unchanged_state, "change_gap_median"),
    (half_batch, "loss_gap_first")], ids=["sound", "unchanged", "half"])
def test_the_cells_check_sees_the_planted_faults(fault, number, monkeypatch,
                                                 tmp_path):
    """``timesformer-frozen-resident`` whole through the harness at the
    small widths, B=2, T=4, 64² frames (PIL decodes on both sides, as on
    the card): correct, and not correct with a fault, whose number then
    exceeds its limit 100-fold."""
    monkeypatch.setattr(native_loader, "build_error", "PIL, as on the card")
    monkeypatch.setattr(native_loader, "_lib", None)
    small = {k: v for k, v in SMALL.items() if k not in ("img_size",
                                                          "frames")}
    monkeypatch.setattr(cli_main, "TimeSformerLSTM",
                        functools.partial(TimeSformerLSTM, **small))
    cell = spec.cell("timesformer-frozen-resident")
    cell.update(train_videos=20, val_videos=10, warmup_steps=1,
                batch_size=2)
    conf = cell["config"]
    cell["config"] = {**conf, "embed_dim": 128, "num_heads": 2, "depth": 2,
                      "feature_dim": 128, "inputsize": 64,
                      "geometry": {**conf["geometry"], "temporal": 4}}
    if fault:
        fault(monkeypatch)
    r = harness.run_cell(cell["name"], 2**31 + 21, 0.3, False, device="cpu",
                         root_dir=str(tmp_path / "run"), cell=cell)
    assert r["correct"] == (fault is None), r["checks"]
    if fault:
        check = r["checks"][number]
        assert check["value"] > 100 * check["limit"], r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_published_widths_match_the_reference_on_the_card(card):
    """At the published widths, 4 clips: the port's forward (fused
    attention) against the reference's, both float32 with TF32 off."""
    from ctc_tpu_torch.models import full_f32_precision

    full_f32_precision()
    conf = {**CONF, "embed_dim": 768, "num_heads": 12, "depth": 12,
            "stack": 8, "inputsize": 224, "feature_dim": 768, "hidden": 33}
    w = ref_train.initial_weights(ref, ref.shapes(conf), 11, "cuda")
    model = TimeSformerLSTM(hidden=33).to("cuda")
    model.load_state_dict({k: w[k] if k in w else torch.zeros_like(v)
                           for k, v in model.state_dict().items()})
    clips = torch.rand((1, 4, 8, 224, 224, 3), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        got = model.features(clips, train=False)[0]
        want = ref.timesformer_features(lstm_head.sub(w, ref.PREFIX),
                                        clips[0])
    # 12 blocks of 768-deep sums in other orders, LayerNorm after each
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
