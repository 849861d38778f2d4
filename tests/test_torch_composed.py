"""ctc_tpu_torch's composed meshes against ctc_tpu on the CPU: data x model
(the binary loss's class axis) and data x seq (the T pipeline, every
lattice loss, and the microbatch knob), the cases of
``tests/test_composed_parallel.py``.

The port's ranks are gloo processes (``tests/torch_ranks.py``): each trains
a :class:`Trainer` on a ``(data, second)`` mesh over its rows, its class or
T shards run in turn in the rank.  ctc_tpu's plain trainer on one device is
the reference, from the same weights, dropout off (JAX's own composed
meshes reproduce it, ``tests/test_composed_parallel.py``): the eval loss at
those weights and the train losses of 3 steps (2 for the knob) to the
kernel tolerance rtol/atol 1e-5, and the first step's reduced gradient
against the whole batch's at the kernel gradient tolerance rtol 2e-3 /
atol 2e-5.  (An eval after training would read the BatchNorm running mean,
which carries ``feature_head.proj.bias``: Adam moves that bias by rounding
noise, ``tests/torch_trainer_pair.py``.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ctc_tpu import losses as jax_losses
from ctc_tpu.data import synthetic_feature_batches
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.train import Trainer as JaxTrainer
from ctc_tpu_torch.models import lstm_head_from_jax
from torch_ranks import composed_cases, spawn

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)

# name: (data, second axis, size, loss, microbatches, batch seed, steps)
CASES = {
    "dm2x4_binary": (2, "model", 4, "binary", 0, 4, 3),
    "dm4x2_binary": (4, "model", 2, "binary", 0, 4, 3),
    "ds2x4_noblank": (2, "seq", 4, "noblank", 0, 1, 3),
    "ds4x2_noblank": (4, "seq", 2, "noblank", 0, 1, 3),
    "ds2x4_binary": (2, "seq", 4, "binary", 0, 1, 3),
    "ds2x4_blank": (2, "seq", 4, "blank", 0, 1, 3),
    "ds2x2_microbatches4": (2, "seq", 2, "noblank", 4, 2, 2),
}


def _batch(name):
    _, axis, _, loss, _, seed, _ = CASES[name]
    if axis == "model":  # C=30 does not divide by 4: pad classes masked
        return synthetic_feature_batches(
            num_batches=1, batch_size=8, temporal=12, feat_dim=16,
            num_classes=30, max_path=6, seed=seed, binary=True)[0]
    return synthetic_feature_batches(
        num_batches=1, batch_size=8, temporal=8, feat_dim=16,
        num_classes=11, max_path=4, seed=seed, binary=(loss == "binary"))[0]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_reference(name):
    """ctc_tpu's plain trainer on one device: its initial weights (the
    port's), the eval loss and the whole batch's gradient at them, and the
    train losses."""
    _, _, _, loss, _, _, steps = CASES[name]
    batch = _batch(name)
    classes = batch["paths"].shape[-1] if batch["paths"].ndim == 3 else 11
    model = JaxLSTMHead(hidden=classes, dropout_rate=0.0)
    tr = JaxTrainer(model, loss_kind=loss, lr=1e-3, seed=0,
                    implementation="xla")
    state = tr.init_state(batch)
    weights = {k: v.numpy() for k, v in lstm_head_from_jax(
        _np_tree(state.params), _np_tree(state.batch_stats)).items()}
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    feats = jnp.transpose(b["feats"], (1, 0, 2))

    def loss_of(p):
        logits, _ = model.apply({"params": p,
                                 "batch_stats": state.batch_stats}, feats,
                                train=True, mutable=["batch_stats"])
        return jax_losses.LOSS_FNS[loss](
            logits, b["paths"], b["input_lengths"], b["target_lengths"],
            implementation="xla")

    grads = lstm_head_from_jax(_np_tree(jax.grad(loss_of)(state.params)),
                               _np_tree(state.batch_stats))
    eval_loss = float(tr.eval_step(state, b)["loss"])
    losses = []
    for _ in range(steps):
        state, m = tr.train_step(state, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return weights, {"losses": losses, "eval_loss": eval_loss,
                     "grads": {k: v.numpy() for k, v in grads.items()
                               if "running" not in k}}


def _run(world, tmp_path_factory):
    """Every case of ``world`` ranks, in one launch of the ranks."""
    names = [n for n, c in CASES.items() if c[0] == world]
    refs = {n: _jax_reference(n) for n in names}
    cases = [(n, CASES[n][1], CASES[n][2], CASES[n][3], CASES[n][4],
              CASES[n][6]) for n in names]
    rdzv = tmp_path_factory.mktemp(f"composed{world}") / "rdzv"
    ranks = spawn(composed_cases,
                  (str(rdzv), cases, {n: _batch(n) for n in names},
                   {n: refs[n][0] for n in names}), world)
    return {n: (refs[n][1], [r[n] for r in ranks]) for n in names}


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    runs = {}

    def get(name):
        world = CASES[name][0]
        if world not in runs:
            runs[world] = _run(world, tmp_path_factory)
        return runs[world][name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_composed_mesh_trains_as_one_device(composed, name):
    want, ranks = composed(name)
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(rank["eval_loss"], want["eval_loss"],
                                   **LOSS_TOL)
    for k, w in want["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][k], w, **GRAD_TOL,
                                   err_msg=k)
