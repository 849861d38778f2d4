"""Pixels mode on the CPU, the train steps: ctc_tpu_torch's I3DLSTM and
its two-optimizer train step against ctc_tpu's on seeded pixel batches,
the finetune step against the float64 step, the gradient exchange and
the optimizer state of a frozen or finetuned backbone, and chunked
extraction inside the model.  (Extraction and the command line are in
``test_torch_pixels_extract.py`` and ``test_torch_pixels_cli.py``.)

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
1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from ctc_tpu.train import Trainer as JaxTrainer
from ctc_tpu_torch import config
from ctc_tpu_torch.models import I3DLSTM, i3d_lstm_from_jax
from ctc_tpu_torch.train import Trainer
from ctc_tpu_torch.train.trainer import to_device

from torch_pixels_oracle import (
    BACKBONE_RTOL, BIAS_CARRIERS, FINETUNE_HEAD_ATOL, HEAD_ATOL, LOSS_TOL,
    LR, NEAR_EPS, JaxPixels, adam_rms, jax_state, np_tree, pixel_batches,
    port_pixels_model,
)


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

