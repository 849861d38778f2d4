"""A ctc_tpu trainer and a ctc_tpu_torch trainer on the CPU from one set of
weights (carried across by ``lstm_head_from_jax``), dropout off, for the
tests of the trainer's features.

Tolerances (``tests/test_torch_trainer.py``): the loss to rtol/atol 1e-5;
parameters to atol 2e-6, except ``feature_head.proj.bias``, whose gradient
is zero up to rounding (the per-timestep BatchNorm removes any shift), so
Adam moves it by up to lr an update on each side: it is held to 2 lr an
update (``tests/test_torch_joint.py`` holds such elements so), and so is
the BatchNorm running mean, which carries it.

JAX is imported inside the functions: a test module that imports this
one may run its ``cuda`` tests on a machine without JAX.
"""

import numpy as np
import torch

T, B, F, C = 8, 6, 16, 9
LR = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL = 2e-6
BIAS_CARRIERS = ("feature_head.proj.bias", "feature_head.bn.running_mean")


def batches(n, seed, *, nan_at=(), batch_size=B, temporal=T, classes=C,
            max_path=None):
    """``n`` synthetic batches; those at ``nan_at`` get a NaN feature."""
    from ctc_tpu_torch.data import synthetic_feature_batches

    out = synthetic_feature_batches(num_batches=n, batch_size=batch_size,
                                    temporal=temporal, feat_dim=F,
                                    num_classes=classes, max_path=max_path,
                                    seed=seed)
    for i in nan_at:
        feats = out[i]["feats"].copy()
        feats[0, 0, 0] = np.nan
        out[i] = {**out[i], "feats": feats}
    return out


def np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def pair(first_batch, *, classes=C, **flags):
    """``((jax_trainer, jax_state), (trainer, state))`` with the same
    weights and the same ``flags``."""
    from ctc_tpu.models import LSTMHead as JaxLSTMHead
    from ctc_tpu.train import Trainer as JaxTrainer
    from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax
    from ctc_tpu_torch.train import Trainer

    common = dict(loss_kind="noblank", lr=LR, seed=0, print_freq=1000)
    common.update(flags)
    jtr = JaxTrainer(JaxLSTMHead(hidden=classes, dropout_rate=0.0),
                     implementation="xla", **common)
    jstate = jtr.init_state(first_batch)
    tr = Trainer(LSTMHead(F, classes, dropout_rate=0.0), device="cpu",
                 **common)
    state = tr.init_state(lstm_head_from_jax(np_tree(jstate.params),
                                             np_tree(jstate.batch_stats)))
    return (jtr, jstate), (tr, state)


def assert_state_close(state, jstate, label=""):
    """Parameters and BatchNorm statistics at the tolerances above, after
    as many updates as the port's optimizer has made."""
    from ctc_tpu_torch.models import lstm_head_from_jax

    want = lstm_head_from_jax(np_tree(jstate.params),
                              np_tree(jstate.batch_stats))
    got = state.model.state_dict()
    updates = max(int(state.optimizer.count), 1)
    for name, w in want.items():
        atol = (2 * LR * updates if name in BIAS_CARRIERS
                else PARAM_ATOL)
        np.testing.assert_allclose(got[name].detach().cpu().numpy(),
                                   w.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{name} {label}")


def jax_counts(opt_state) -> dict:
    """``{"count", "skipped"}`` of ctc_tpu's optimizer state: Adam's update
    count and ``skip_nonfinite_updates``' skipped count (0 without it)."""
    import optax

    found = {"skipped": 0}

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            found["count"] = int(s.count)
        elif type(s).__name__ == "SkipState":
            found["skipped"] = int(s.skipped)
        if isinstance(s, tuple):
            for x in s:
                walk(x)

    walk(opt_state)
    return found


def port_counts(state) -> dict:
    return {"count": int(state.optimizer.count),
            "skipped": int(state.optimizer.skipped)}


def assert_same_state(a, b):
    """Two port states equal bit for bit: parameters, BatchNorm
    statistics, gradient sums, the optimizer's tensors and the batch
    count."""
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    for x, y in zip([*a.optimizer.grads, *a.optimizer.tensors(), a.step],
                    [*b.optimizer.grads, *b.optimizer.tensors(), b.step]):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
