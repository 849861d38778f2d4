"""ctc_tpu_torch's joint (object, verb) loss against ctc_tpu's on the CPU:
the loss and its gradient (ctc_tpu's XLA scan and its Pallas kernel in
interpret mode) at object weights 1 and 3, the packed batches, three
joint train steps from the same weights, the CLI's joint run with the
relation eval, and ``--loss joint`` with ``--seq-parallel`` refused as
ctc_tpu refuses it; on the card, the loss through the lattice kernels
against the plain path.

Tolerances: the lattice's (loss rtol/atol 1e-5, gradient rtol 2e-3 /
atol 2e-5; the JAX suite's own for its Pallas kernel against the XLA
scan).  The train steps: loss, top-1 and top-5 as
``tests/test_torch_trainer.py``; parameters at its atol 2e-6 with the
exemption of ``tests/test_torch_loaders.py::_assert_steps_close``, whose
threshold here is the lattice gradient's atol: an element whose Adam
input has had an RMS below 2e-5 at a step so far (seen: 1 to 5 of 784 in
a kernel) has a gradient that the lattice holds to that absolute
tolerance only, and Adam divides by that RMS, so its step may move by a
share of lr; such elements are held within 2 lr a step.

JAX is imported inside the tests, not at the top: the card's machine has
no JAX, and the ``cuda`` test runs there on its own
(``python -m pytest tests/test_torch_joint.py -m cuda``).
"""

import csv

import numpy as np
import pytest
import torch

from ctc_tpu_torch import config, losses
from ctc_tpu_torch.data import synthetic_feature_batches
from ctc_tpu_torch.data.loaders import synthetic as loader
from ctc_tpu_torch.data.synthetic import pack_joint_batches
from ctc_tpu_torch.losses.joint import split_joint_logits, unpack_joint_paths

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
T, B, F, V, O = 8, 6, 16, 9, 5


def _joint_batches(num_batches=1, seed=0):
    return pack_joint_batches(
        synthetic_feature_batches(num_batches=num_batches, batch_size=B,
                                  temporal=T, feat_dim=F, num_classes=V,
                                  seed=seed),
        O,
    )


def _case(seed):
    """Joint logits and a packed batch, with input lengths below T and one
    sample whose verb and object lengths differ."""
    rng = np.random.default_rng(seed)
    (batch,) = _joint_batches(seed=seed)
    logits = (2.0 * rng.standard_normal((T, B, V + O))).astype(np.float32)
    in_len = batch["input_lengths"].copy()
    in_len[1:3] = [T - 2, T - 1]
    tgt = batch["target_lengths"].copy()
    tgt[:, 0] = np.minimum(tgt[:, 0], in_len)
    tgt[:, 1] = np.minimum(tgt[:, 1], in_len)
    tgt[3, 1] = max(tgt[3, 1] - 1, 1)
    return logits, batch["paths"], in_len, tgt


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("weight", [1.0, 3.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_joint_loss_and_gradient_match_ctc_tpu(seed, weight, impl):
    import jax
    import jax.numpy as jnp

    from ctc_tpu.losses.joint import joint_ov_ctc_loss as jax_joint

    logits, paths, in_len, tgt = _case(seed)

    def jax_loss(x):
        return jax_joint(x, jnp.asarray(paths), jnp.asarray(in_len),
                         jnp.asarray(tgt), implementation=impl,
                         interpret=(impl == "pallas"), object_weight=weight)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = losses.joint_ov_ctc_loss(x, torch.tensor(paths),
                                   torch.tensor(in_len), torch.tensor(tgt),
                                   object_weight=weight)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               **GRAD_TOL)


def test_joint_loss_is_the_sum_of_the_head_losses():
    logits, paths, in_len, tgt = _case(2)
    x, p = torch.tensor(logits), torch.tensor(paths)
    il, tl = torch.tensor(in_len), torch.tensor(tgt)
    v_logits, o_logits = split_joint_logits(x, p)
    v_paths, o_paths = unpack_joint_paths(p)
    assert v_logits.shape[-1] == V and o_logits.shape[-1] == O
    assert v_paths.dtype == torch.int32
    want = (losses.no_blank_ctc_loss(v_logits, v_paths, il, tl[:, 0])
            + 3.0 * losses.no_blank_binary_ctc_loss(o_logits, o_paths, il,
                                                    tl[:, 1]))
    got = losses.LOSS_FNS["joint"](x, p, il, tl, object_weight=3.0)
    assert float(got) == float(want)


@pytest.mark.parametrize("seed", [0, 4])
def test_pack_joint_batches_matches_ctc_tpu(seed):
    from ctc_tpu.data.synthetic import pack_joint_batches as jax_pack

    from test_torch_charades import assert_same

    raw = synthetic_feature_batches(num_batches=2, batch_size=B, temporal=T,
                                    feat_dim=F, num_classes=V, seed=seed)
    got = pack_joint_batches(raw, O)
    assert_same(got, jax_pack(raw, O))
    assert got[0]["paths"].shape == (B, T, 1 + O)
    assert got[0]["target_lengths"].shape == (B, 2)


def test_synthetic_loader_joint_batches_match_ctc_tpu(tmp_path):
    from ctc_tpu import config as jax_config
    from ctc_tpu.data.loaders import synthetic as jax_loader

    from test_torch_charades import assert_same

    argv = ["--dataset", "synthetic", "--extract-feat-dim", "8",
            "--batch-size", "3", "--temporal", "6", "--loss", "joint",
            "--v-class", str(V), "--o-class", str(O),
            "--cache-dir", str(tmp_path)]
    assert_same(loader.get(config.parse(argv)),
                jax_loader.get(jax_config.parse(argv)))


@pytest.mark.parametrize("weight", [1.0, 3.0])
def test_three_joint_train_steps_match_ctc_tpu(weight):
    import functools

    import jax
    import jax.numpy as jnp

    from ctc_tpu.losses.joint import joint_ov_ctc_loss as jax_joint
    from ctc_tpu.models import LSTMHead as JaxLSTMHead
    from ctc_tpu.train.trainer import TrainState as JaxTrainState
    from ctc_tpu.train.trainer import make_train_step as jax_train_step
    from ctc_tpu.train.trainer import torch_style_adam as jax_adam
    from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
    from ctc_tpu_torch.train.trainer import (
        TrainState,
        make_train_step,
        to_device,
        torch_style_adam,
    )

    from test_torch_loaders import _assert_steps_close
    from test_torch_trainer import (
        LOSS_TOL as STEP_LOSS_TOL,
        LR,
        WD,
        _bias_gap,
        _np_tree,
    )

    jmodel = JaxLSTMHead(hidden=V + O, dropout_rate=0.0)
    variables = jmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((T, B, F), jnp.float32), train=False)
    jstate = JaxTrainState.create(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  tx=jax_adam(LR, WD))
    jstep = jax_train_step(
        jmodel, "joint", "xla",
        loss_fn=functools.partial(jax_joint, object_weight=weight))
    model = LSTMHead(F, V + O, dropout_rate=0.0)
    model.load_state_dict(lstm_head_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["batch_stats"])))
    state = TrainState(model, torch_style_adam(model.parameters(), WD))
    step = make_train_step(
        "joint", schedule=lambda k: LR,
        loss_fn=functools.partial(losses.joint_ov_ctc_loss,
                                  object_weight=weight))
    mean_shift = torch.zeros(V + O)
    near_eps = {}
    for k, batch in enumerate(_joint_batches(3, seed=1)):
        mean_shift = 0.9 * mean_shift + 0.1 * _bias_gap(model, jstate.params)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_LOSS_TOL)
        # top-k over the verb slice, as ctc_tpu scores it
        for key in ("top1", "top5"):
            assert float(m[key]) == pytest.approx(float(jm[key])), key
        _assert_steps_close(model, jstate, k, mean_shift, LR, near_eps,
                            near=GRAD_TOL["atol"])


def test_trainer_takes_the_object_weight():
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer

    (batch,) = _joint_batches(seed=3)
    out = {}
    for weight in (1.0, 3.0):
        trainer = Trainer(LSTMHead(F, V + O), loss_kind="joint",
                          joint_object_weight=weight, device="cpu")
        state = trainer.init_state()
        out[weight] = trainer.validate(state, [batch], epoch=0)["loss"]
    model = LSTMHead(F, V + O)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        x = model(torch.tensor(batch["feats"]).transpose(0, 1), train=False)
        for weight in (1.0, 3.0):
            want = losses.joint_ov_ctc_loss(
                x, torch.tensor(batch["paths"]),
                torch.tensor(batch["input_lengths"]),
                torch.tensor(batch["target_lengths"]), object_weight=weight)
            np.testing.assert_allclose(out[weight], float(want), rtol=1e-6)
    assert out[3.0] > out[1.0]


def test_joint_with_seq_parallel_is_refused_as_ctc_tpu_refuses(tmp_path):
    """ctc_tpu's sequence pipeline has no joint mode: its Trainer raises
    ValueError, and so does the port's, from the CLI too."""
    from ctc_tpu.cli.main import main as jax_main

    from ctc_tpu_torch.cli.main import main

    argv = ["--dataset", "synthetic", "--extract-feat-dim", "8",
            "--batch-size", "4", "--temporal", "4", "--loss", "joint",
            "--seq-parallel", "2", "--epochs", "1"]
    with pytest.raises(ValueError, match="seq_parallel needs a lattice "
                       "loss, got 'joint'") as want:
        jax_main(argv + ["--lattice-impl", "xla",
                         "--cache-dir", str(tmp_path / "jax")])
    with pytest.raises(ValueError) as got:
        main(argv + ["--device", "cpu", "--cache-dir", str(tmp_path / "t")])
    assert str(got.value) == str(want.value)


def test_cli_joint_run_and_relation_eval(tmp_path, capsys):
    """The port's twin of tests/test_joint.py::test_cli_joint_relation_eval:
    train 2 epochs with --loss joint and --video-eval (mAP per epoch in
    score.csv and as the checkpoint score), then --evaluate --decode
    prints the relation-tagging line and decodes the verb path of every
    val window."""
    from ctc_tpu_torch.cli.main import main

    common = [
        "--dataset", "synthetic", "--batch-size", "4", "--temporal", "8",
        "--extract-feat-dim", "16", "--dropout", "0.0", "--v-class", str(V),
        "--o-class", str(O), "--loss", "joint", "--cache-dir", str(tmp_path),
        "--name", "joint", "--print-train-freq", "100",
        "--print-test-freq", "100", "--device", "cpu",
    ]
    history = main(common + ["--epochs", "2", "--video-eval",
                             "--transition-metrics"])
    assert history[-1]["train"]["loss"] < history[0]["train"]["loss"]
    for h in history:
        assert np.isfinite(h["val"]["mAP"])
        assert {"trans_top1", "recall_top5"} <= set(h["val"])
    rows = list(csv.reader(open(tmp_path / "joint" / "score.csv")))
    assert [float(r[5]) for r in rows] == [h["val"]["mAP"] for h in history]
    assert "relation mAP:" in capsys.readouterr().out

    metrics = main(common + ["--epochs", "2", "--evaluate", "--decode",
                             "--resume", str(tmp_path / "joint")])
    out = capsys.readouterr().out
    assert f"resumed epoch 1 (score {history[-1]['val']['mAP']:.4f})" in out
    assert "relation tagging:" in out and "object mAP" in out
    assert np.isfinite(metrics["relation_mAP"])
    assert set(metrics["relation_recall_at"]) == {50, 100}
    assert set(metrics["relation_prec_at"]) == {1, 5, 10}
    assert np.isfinite(metrics["video_mAP"])
    assert np.isfinite(metrics["object_mAP"])
    # decoded verb paths stay in the verb class space
    rows = list(csv.reader(open(metrics["decoded_csv"])))[1:]
    assert len(rows) == 8
    for row in rows:
        assert all(0 <= int(c) < V for c in row[3].split())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("weight", [1.0, 3.0])
def test_joint_loss_on_the_kernels_matches_plain_on_card(cuda_device,
                                                         weight):
    """Each term runs the blank-free lattice kernels once forward and once
    backward; loss and gradient equal the plain path's."""
    from ctc_tpu_torch.ops import lattice_cuda as lc

    logits, paths, in_len, tgt = _case(5)
    args = [torch.tensor(a).to(cuda_device) for a in (paths, in_len, tgt)]
    out = {}
    for impl in ("cuda", "torch"):
        x = torch.tensor(logits).to(cuda_device).requires_grad_()
        before = dict(lc.launch_counts)
        loss = losses.joint_ov_ctc_loss(x, *args, implementation=impl,
                                        object_weight=weight)
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: lc.launch_counts[k] - before[k] for k in before}
        out[impl] = (float(loss.detach()), x.grad.cpu().numpy(), launched)
    assert out["cuda"][2]["noblank_lattice_forward"] == 2
    assert out["cuda"][2]["noblank_lattice_backward"] == 2
    assert not any(out["torch"][2].values())
    np.testing.assert_allclose(out["cuda"][0], out["torch"][0], **LOSS_TOL)
    np.testing.assert_allclose(out["cuda"][1], out["torch"][1], **GRAD_TOL)
