"""ctc_tpu_torch's train and eval steps against ctc_tpu's, from identical
weights, on the CPU (dropout off: the two packages draw dropout from
different generators).

Tolerances: the loss to rtol/atol 1e-5 (f32 on both sides, sums in another
order); parameters to atol 2e-6 after each step.  Adam moves each
parameter by about lr * g / (|g| + eps), so parameters agree to rounding
wherever the gradient stands above rounding noise.  The one exception is
``feature_head.proj.bias``: the per-timestep BatchNorm removes any shift, so
its gradient is zero up to rounding and Adam scales that noise into a step
of up to lr.  It is held to atol 2 * lr (and its gradient to 1e-5), and the
BatchNorm running mean, which carries that bias, is compared after taking
out the share the bias difference explains (momentum times the bias gap
before each step, decayed like the running mean itself).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu.data import synthetic_feature_batches
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.train.schedule import step_decay_schedule as jax_schedule
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu.train.trainer import make_eval_step as jax_eval_step
from ctc_tpu.train.trainer import make_train_step as jax_train_step
from ctc_tpu.train.trainer import torch_style_adam as jax_adam
from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
from ctc_tpu_torch.train import checkpoints
from ctc_tpu_torch.train.schedule import step_decay_schedule
from ctc_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    make_eval_step,
    make_train_step,
    to_device,
    torch_style_adam,
)

T, B, F, C = 8, 6, 32, 9
LR, WD = 1e-2, 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-6
ZERO_GRAD_PARAMS = ("feature_head.proj.bias",)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(n, seed):
    return synthetic_feature_batches(num_batches=n, batch_size=B,
                                     temporal=T, feat_dim=F, num_classes=C,
                                     seed=seed)


def _jax_init():
    model = JaxLSTMHead(hidden=C, dropout_rate=0.0)
    feats = jnp.zeros((T, B, F), jnp.float32)
    variables = model.init(jax.random.PRNGKey(3), feats, train=False)
    return model, variables["params"], variables["batch_stats"]


def _assert_params_close(torch_model, jparams, jstats, step, mean_shift):
    want = lstm_head_from_jax(_np_tree(jparams), _np_tree(jstats))
    got = torch_model.state_dict()
    got["feature_head.bn.running_mean"] = (
        got["feature_head.bn.running_mean"] - mean_shift)
    for name, w in want.items():
        atol = 2 * LR if name in ZERO_GRAD_PARAMS else PARAM_ATOL
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{name} step {step}")


def _bias_gap(torch_model, jparams):
    return (torch_model.feature_head.proj.bias.detach()
            - torch.tensor(np.asarray(jparams["feature_head"]["proj"]["bias"])))


@pytest.mark.parametrize(
    "decay_epochs,steps_per_epoch,ce_weight",
    [(30, 8, 0.0), (1, 1, 0.0), (30, 8, 0.5)],
    ids=["constant-lr", "decay-every-step", "ce-mix"],
)
def test_three_train_steps_match(decay_epochs, steps_per_epoch, ce_weight):
    """Per-step loss/top1/top5 and the parameters after each step; the
    decay-every-step case catches an off-by-one in the schedule count."""
    jmodel, jparams, jstats = _jax_init()
    jstate = JaxTrainState.create(
        params=jparams, batch_stats=jstats,
        tx=jax_adam(jax_schedule(LR, decay_epochs, steps_per_epoch), WD),
    )
    jstep = jax_train_step(jmodel, "noblank", "xla", ce_weight)

    model = LSTMHead(F, C, dropout_rate=0.0)
    model.load_state_dict(lstm_head_from_jax(_np_tree(jparams),
                                             _np_tree(jstats)))
    state = TrainState(model, torch_style_adam(model.parameters(), WD))
    step = make_train_step("noblank", None, ce_weight,
                           step_decay_schedule(LR, decay_epochs,
                                               steps_per_epoch))
    mean_shift = torch.zeros(C)
    for k, batch in enumerate(_batches(3, seed=0)):
        # running_mean += momentum * (batch mean of proj(x), bias included)
        mean_shift = 0.9 * mean_shift + 0.1 * _bias_gap(model, jstate.params)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        for key in ("top1", "top5"):
            assert float(m[key]) == pytest.approx(float(jm[key])), key
        _assert_params_close(model, jstate.params, jstate.batch_stats, k,
                             mean_shift)
        assert state.step == int(jstate.step) == k + 1


def test_zero_grad_parameter_is_rounding_noise():
    """The premise of the proj.bias tolerance: its gradient is ~0."""
    model = LSTMHead(F, C, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = TrainState(model, torch_style_adam(model.parameters(), 0.0))
    step = make_train_step("noblank", None, 0.0, lambda k: 0.0)
    step(state, to_device(_batches(1, seed=1)[0], "cpu"))
    g = model.feature_head.proj.bias.grad
    assert float(g.abs().max()) < 1e-5
    assert float(model.input_gates.bias.grad.abs().max()) > 1e-3


def test_eval_step_matches():
    jmodel, jparams, jstats = _jax_init()
    jstate = JaxTrainState.create(params=jparams, batch_stats=jstats,
                                  tx=jax_adam(LR, WD))
    model = LSTMHead(F, C, dropout_rate=0.0)
    model.load_state_dict(lstm_head_from_jax(_np_tree(jparams),
                                             _np_tree(jstats)))
    state = TrainState(model, torch_style_adam(model.parameters(), WD))
    batch = _batches(1, seed=2)[0]
    jm = jax_eval_step(jmodel, "noblank", "xla")(jstate, batch)
    m = make_eval_step("noblank")(state, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    for key in ("top1", "top5"):
        assert float(m[key]) == pytest.approx(float(jm[key])), key


def test_trainer_learns_and_checkpoints(tmp_path):
    train, val = _batches(6, seed=0), _batches(2, seed=1)
    trainer = Trainer(LSTMHead(F, C), lr=2e-2, steps_per_epoch=len(train),
                      cache_dir=str(tmp_path), device="cpu")
    state, history = trainer.fit(train, val, epochs=6)
    assert history[-1]["train"]["loss"] < history[0]["train"]["loss"] * 0.9
    fresh = Trainer(LSTMHead(F, C), device="cpu").init_state()
    restored, epoch, score = checkpoints.load(str(tmp_path), fresh)
    assert epoch == 5 and restored.step == state.step == 36
    for name, w in state.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[name], w,
                                   rtol=0, atol=0)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "3.pt", "4.pt", "5.pt"]
    assert (tmp_path / "ckpt_best.pt").exists()


def test_trainer_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Trainer(LSTMHead(F, C))
