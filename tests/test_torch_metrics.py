"""ctc_tpu_torch's metrics against ctc_tpu's on the CPU: the six metric
functions exactly (both sides count hits in f32 and scale them by the same
constants), on logits rounded to 0.5 so that ties occur (signed zeros
included), at path lengths 0, 1, a middle one and Lmax, on one-hot integer
paths and multi-hot paths; the batched DTW matcher against ctc_tpu's
per-sample one under ``vmap``; and the eval step's ``trans_*`` /
``recall_*`` against ctc_tpu's eval step from the same weights.

The eval steps' batch means are held to rtol 1e-6: each side sums the
per-sample f32 percentages in its own order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu.data.synthetic import pack_joint_batches as jax_pack_joint
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.train import metrics as jmetrics
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu.train.trainer import make_eval_step as jax_eval_step
from ctc_tpu.train.trainer import torch_style_adam as jax_adam
from ctc_tpu_torch.data import synthetic_feature_batches
from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
from ctc_tpu_torch.train import metrics
from ctc_tpu_torch.train.trainer import (
    TrainState,
    make_eval_step,
    to_device,
    torch_style_adam,
)

T, C, L = 7, 6, 5
SEEDS = [0, 1, 2, 3]
MEAN_RTOL = 1e-6


def _tied_scores(rng, shape):
    """Scores on a 0.5 grid: ties within a row, and -0.0 beside +0.0."""
    return (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)


def _paths(rng, kind):
    """``[L, C]`` path rows: the one-hot of an integer path (-1 padded,
    taken mod C as the eval step does) or random multi-hot rows."""
    if kind == "int":
        ids = rng.integers(-1, C, size=L)
        return np.eye(C, dtype=np.float32)[np.mod(ids, C)]
    return (rng.random((L, C)) < 0.3).astype(np.float32)


def _same(got, want):
    (g1, g5), g_vec = got
    (w1, w5), w_vec = want
    assert float(g1) == float(w1) and float(g5) == float(w5), (
        (float(g1), float(g5)), (float(w1), float(w5)))
    np.testing.assert_array_equal(g_vec.numpy(), np.asarray(w_vec))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["int", "multi_hot"])
@pytest.mark.parametrize("name", ["transition_accuracy",
                                  "transition_recall"])
def test_transition_metric_matches_ctc_tpu(name, kind, seed):
    rng = np.random.default_rng(seed)
    out = _tied_scores(rng, (T, C))
    target = _paths(rng, kind)
    for valid_len in (0, 1, 3, L):
        got = getattr(metrics, name)(torch.tensor(out), torch.tensor(target),
                                     valid_len)
        want = getattr(jmetrics, name)(jnp.asarray(out), jnp.asarray(target),
                                       valid_len)
        _same(got, want)


@pytest.mark.parametrize("name", ["transition_accuracy",
                                  "transition_recall"])
def test_batched_matcher_matches_per_sample_vmap(name):
    """One call over ``[B, T, C]`` equals ctc_tpu's per-sample function
    under ``vmap``, sample for sample."""
    rng = np.random.default_rng(7)
    B = 9
    out = _tied_scores(rng, (B, T, C))
    target = np.stack([_paths(rng, ("int", "multi_hot")[b % 2])
                       for b in range(B)])
    lens = np.array([0, 1, L, 2, 3, L, 1, 4, 0])
    got = getattr(metrics, name)(torch.tensor(out), torch.tensor(target),
                                 torch.tensor(lens))
    want = jax.vmap(getattr(jmetrics, name))(
        jnp.asarray(out), jnp.asarray(target), jnp.asarray(lens))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", SEEDS)
def test_sequence_accuracy_matches_ctc_tpu(seed):
    rng = np.random.default_rng(seed)
    out = _tied_scores(rng, (T, C))
    for target in range(C):
        _same(metrics.sequence_accuracy(torch.tensor(out), target),
              jmetrics.sequence_accuracy(jnp.asarray(out), target))


@pytest.mark.parametrize("seed", SEEDS)
def test_future_accuracy_matches_ctc_tpu(seed):
    rng = np.random.default_rng(seed)
    out = _tied_scores(rng, (T, C))
    for target in ((rng.random(C) < 0.4), np.zeros(C), np.ones(C)):
        target = target.astype(np.float32)
        _same(metrics.future_accuracy(torch.tensor(out),
                                      torch.tensor(target)),
              jmetrics.future_accuracy(jnp.asarray(out),
                                       jnp.asarray(target)))


@pytest.mark.parametrize("seed", SEEDS)
def test_multilabel_topk_accuracy_matches_ctc_tpu(seed):
    rng = np.random.default_rng(seed)
    out = _tied_scores(rng, (8, C))
    target = (rng.random((8, C)) < 0.4).astype(np.float32)
    _same(metrics.multilabel_topk_accuracy(torch.tensor(out),
                                           torch.tensor(target)),
          jmetrics.multilabel_topk_accuracy(jnp.asarray(out),
                                            jnp.asarray(target)))


@pytest.mark.parametrize("seed", SEEDS)
def test_topk_accuracy_matches_ctc_tpu(seed):
    rng = np.random.default_rng(seed)
    out = _tied_scores(rng, (8, C))
    target = rng.integers(0, C, size=8)
    _same(metrics.topk_accuracy(torch.tensor(out), torch.tensor(target)),
          jmetrics.topk_accuracy(jnp.asarray(out), jnp.asarray(target)))


def test_topk_ranks_ties_as_lax_top_k():
    """Equal scores rank the lower class first, and -0.0 ranks below
    +0.0, as ``jax.lax.top_k`` orders them."""
    out = np.array([[0.0, -0.0, 0.5, 0.0, -0.5, 0.5, np.inf, -np.inf]],
                   np.float32)
    got = metrics._topk_indices(torch.tensor(out), 8).numpy()
    want = np.asarray(jax.lax.top_k(jnp.asarray(out), 8)[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [6, 2, 5, 0, 3, 1, 4, 7])


F, V, O = 16, 9, 5


def _eval_case(loss):
    """``(classes, batch)``: a synthetic batch of the loss's path kind."""
    kind = {"binary": dict(binary=True), "blank": dict(max_path=3)}
    classes = V + O if loss == "joint" else V
    (batch,) = synthetic_feature_batches(
        num_batches=1, batch_size=6, temporal=T, feat_dim=F, num_classes=V,
        seed=11, **kind.get(loss, {}))
    if loss == "joint":
        (batch,) = jax_pack_joint([batch], O)
    return classes, batch


@pytest.mark.parametrize("loss", ["noblank", "binary", "blank", "joint"])
def test_eval_step_transition_metrics_match_ctc_tpu(loss):
    classes, batch = _eval_case(loss)
    jmodel = JaxLSTMHead(hidden=classes, dropout_rate=0.0)
    variables = jmodel.init(jax.random.PRNGKey(5),
                            jnp.zeros((T, 6, F), jnp.float32), train=False)
    jstate = JaxTrainState.create(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  tx=jax_adam(1e-3))
    want = jax_eval_step(jmodel, loss, "xla", transition_metrics=True)(
        jstate, batch)
    model = LSTMHead(F, classes, dropout_rate=0.0)
    model.load_state_dict(lstm_head_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"])))
    state = TrainState(model, torch_style_adam(model.parameters()))
    got = make_eval_step(loss, transition_metrics=True)(
        state, to_device(batch, "cpu"))
    assert set(got) == set(want) == {
        "loss", "top1", "top5", "trans_top1", "trans_top5", "recall_top1",
        "recall_top5"}
    for key in ("top1", "top5", "trans_top1", "trans_top5", "recall_top1",
                "recall_top5"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=MEAN_RTOL, err_msg=key)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5, atol=1e-5)


def test_eval_step_without_transition_metrics_adds_none():
    classes, batch = _eval_case("noblank")
    model = LSTMHead(F, classes)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = TrainState(model, torch_style_adam(model.parameters()))
    got = make_eval_step("noblank")(state, to_device(batch, "cpu"))
    assert set(got) == {"loss", "top1", "top5"}
