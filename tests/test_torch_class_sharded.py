"""ctc_tpu_torch's class-sharded binary CTC (the ``model`` axis) against
ctc_tpu's on the CPU.

JAX shards the class axis over a ``model`` mesh of conftest's virtual CPU
devices; the port runs the same M shards in turn in one process
(``make_local_mesh("model", M, "cpu")``), the lattice through its plain
version.  C = 38 (the object classes) and 157 (the action classes) divide
by none of M = 2, 3, 4, so the pad classes' masking is exercised.

Tolerances: the kernel tolerances of the JAX suite (loss rtol/atol 1e-5,
gradients rtol 2e-3 / atol 2e-5): both sides are f32 and sum the partial
emissions in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from ctc_tpu.data import synthetic_feature_batches
from ctc_tpu.parallel.class_sharded import (
    make_class_sharded_binary_loss as jax_sharded_loss,
)
from ctc_tpu.parallel.class_sharded import (
    make_class_sharded_binary_nll as jax_sharded_nll,
)
from ctc_tpu_torch.losses import no_blank_binary_ctc_loss
from ctc_tpu_torch.parallel import (
    make_class_sharded_binary_loss,
    make_class_sharded_binary_nll,
    make_local_mesh,
    shard_class_axis,
)
from ctc_tpu_torch.train.trainer import to_device

T, B, L = 10, 6, 5
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)


def _case(classes, seed=0):
    batch = synthetic_feature_batches(num_batches=1, batch_size=B,
                                      temporal=T, feat_dim=4,
                                      num_classes=classes, max_path=L,
                                      seed=seed, binary=True)[0]
    logits = np.random.default_rng(seed).normal(
        size=(T, B, classes)).astype(np.float32) * 2
    return (logits, batch["paths"].astype(np.float32),
            batch["input_lengths"], batch["target_lengths"])


def _pad(x, m):
    pad = (-x.shape[-1]) % m
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def _jax_mesh(m):
    return JaxMesh(np.asarray(jax.devices()[:m]), ("model",))


@pytest.mark.parametrize("classes", [38, 157])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_nll_and_gradients_match_jax(shards, classes):
    logits, paths, inl, tgt = _case(classes)
    logits_p, paths_p = _pad(logits, shards), _pad(paths, shards)
    jfn = jax_sharded_nll(_jax_mesh(shards), num_classes=classes,
                          implementation="xla", reduction="none")
    want = np.asarray(jfn(jnp.asarray(logits_p), jnp.asarray(paths_p),
                          jnp.asarray(inl), jnp.asarray(tgt)))
    want_grad = np.asarray(jax.grad(lambda lg: jnp.sum(jfn(
        lg, jnp.asarray(paths_p), jnp.asarray(inl), jnp.asarray(tgt))))(
        jnp.asarray(logits_p)))

    fn = make_class_sharded_binary_nll(
        make_local_mesh("model", shards, "cpu"), num_classes=classes,
        reduction="none")
    lg = torch.tensor(logits_p, requires_grad=True)
    got = fn(lg, torch.as_tensor(paths_p), torch.as_tensor(inl),
             torch.as_tensor(tgt))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **LOSS_TOL)
    np.testing.assert_allclose(lg.grad.numpy(), want_grad, **GRAD_TOL)
    assert not lg.grad[..., classes:].any()  # pad classes: no gradient


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_reductions_equal_the_unsharded_loss(reduction):
    logits, paths, inl, tgt = _case(38, seed=1)
    args = [torch.as_tensor(x) for x in (_pad(logits, 3), _pad(paths, 3),
                                         inl, tgt)]
    fn = make_class_sharded_binary_nll(make_local_mesh("model", 3, "cpu"),
                                       num_classes=38, reduction=reduction)
    want = no_blank_binary_ctc_loss(
        *[torch.as_tensor(x) for x in (logits, paths, inl, tgt)],
        reduction=reduction)
    np.testing.assert_allclose(float(fn(*args)), float(want), **LOSS_TOL)


def test_trainer_loss_pads_and_matches_jax():
    """The trainer's ``loss_fn``: C = 157 padded to 160 for 4 shards."""
    logits, paths, inl, tgt = _case(157, seed=2)
    jloss = jax_sharded_loss(_jax_mesh(4))
    want, want_grad = jax.value_and_grad(
        lambda lg: jloss(lg, jnp.asarray(paths), jnp.asarray(inl),
                         jnp.asarray(tgt), implementation="xla"))(
        jnp.asarray(logits))
    loss_fn = make_class_sharded_binary_loss(
        make_local_mesh("model", 4, "cpu"))
    lg = torch.tensor(logits, requires_grad=True)
    got = loss_fn(lg, torch.as_tensor(paths), torch.as_tensor(inl),
                  torch.as_tensor(tgt))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad),
                               **GRAD_TOL)


def test_shard_class_axis():
    mesh = make_local_mesh("model", 3, "cpu")
    x = torch.arange(2 * 6).reshape(2, 6)
    parts = shard_class_axis(x, mesh)
    assert [p.tolist() for p in parts] == [[[0, 1], [6, 7]], [[2, 3],
                                                             [8, 9]],
                                           [[4, 5], [10, 11]]]
    with pytest.raises(ValueError, match="pad"):
        shard_class_axis(x[:, :5], mesh)


def test_model_parallel_trainer_matches_jax():
    """``Trainer(model_parallel=3)`` against ctc_tpu's, from the same
    weights (``tests/torch_trainer_pair.py``): 3 steps, C = 38, losses and
    the state at that file's tolerances."""
    from torch_trainer_pair import LOSS_TOL as STEP_LOSS_TOL
    from torch_trainer_pair import assert_state_close, pair

    batch = synthetic_feature_batches(num_batches=1, batch_size=6,
                                      temporal=8, feat_dim=16,
                                      num_classes=38, max_path=4, seed=4,
                                      binary=True)[0]
    (jtr, jstate), (tr, state) = pair(batch, classes=38, loss_kind="binary",
                                      model_parallel=3)
    for _ in range(3):
        jstate, jm = jtr.train_step(jstate, batch, jax.random.PRNGKey(0))
        state, m = tr.train_step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_LOSS_TOL)
    assert_state_close(state, jstate, "model_parallel=3")
