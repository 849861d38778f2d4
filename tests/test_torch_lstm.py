"""ctc_tpu_torch's LSTM head against ctc_tpu's flax LSTMHead, from the same
weights (carried across by ``lstm_head_from_jax``), on the CPU.

Tolerance rtol/atol 1e-5: both sides are f32 on the CPU and differ only in
the summation order of the 64-deep projection and the recurrent matmuls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu_torch.models import LSTMHead, lstm_head_from_jax

T, B, IN, H = 6, 5, 64, 11
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def pair(rng):
    """A flax head with non-trivial BN params/stats and its torch copy."""
    feats = (rng.standard_normal((T, B, IN))).astype(np.float32)
    jmodel = JaxLSTMHead(hidden=H, dropout_rate=0.0)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                            train=False)
    params = _np_tree(variables["params"])
    stats = _np_tree(variables["batch_stats"])
    bn = params["feature_head"]["bn"]
    bn["scale"] = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    bn["bias"] = (0.1 * rng.standard_normal(H)).astype(np.float32)
    sbn = stats["feature_head"]["bn"]
    sbn["mean"] = (0.1 * rng.standard_normal(H)).astype(np.float32)
    sbn["var"] = (1.0 + rng.random(H)).astype(np.float32)
    tmodel = LSTMHead(IN, H, dropout_rate=0.0)
    tmodel.load_state_dict(lstm_head_from_jax(params, stats))
    return feats, jmodel, params, stats, tmodel


def test_train_forward_and_running_stats_match(pair):
    feats, jmodel, params, stats, tmodel = pair
    out, mutated = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(feats),
        train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1)},
    )
    got = tmodel(torch.tensor(feats), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    new = mutated["batch_stats"]["feature_head"]["bn"]
    bn = tmodel.feature_head.bn
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), **TOL)


def test_eval_forward_matches(pair):
    feats, jmodel, params, stats, tmodel = pair
    out = jmodel.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(feats), train=False)
    with torch.no_grad():
        got = tmodel(torch.tensor(feats), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)


def test_conversion_layout():
    """Dense kernels [in, out] become nn.Linear's [out, in]."""
    H2 = 3
    params = {
        "feature_head": {
            "proj": {"kernel": np.arange(4 * H2, dtype=np.float32)
                     .reshape(4, H2), "bias": np.zeros(H2, np.float32)},
            "bn": {"scale": np.ones(H2, np.float32),
                   "bias": np.zeros(H2, np.float32)},
        },
        "input_gates": {"kernel": np.ones((H2, 4 * H2), np.float32),
                        "bias": np.zeros(4 * H2, np.float32)},
        "recurrent_kernel": np.eye(H2, 4 * H2, dtype=np.float32),
    }
    stats = {"feature_head": {"bn": {"mean": np.zeros(H2, np.float32),
                                     "var": np.ones(H2, np.float32)}}}
    sd = lstm_head_from_jax(params, stats)
    model = LSTMHead(4, H2)
    model.load_state_dict(sd)
    np.testing.assert_array_equal(model.feature_head.proj.weight.detach().numpy(),
                                  params["feature_head"]["proj"]["kernel"].T)
    np.testing.assert_array_equal(model.recurrent_kernel.detach().numpy(),
                                  params["recurrent_kernel"])


def test_init_follows_flax_lecun_normal():
    """Kernels are truncated normals of variance 1/fan_in (within 2 std),
    biases zero, like flax's Dense defaults."""
    model = LSTMHead(1024, 33)
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.feature_head.proj.weight.detach()
    std = (1.0 / 1024) ** 0.5
    # 33k draws: the sample std is within 3% of the target
    assert abs(float(w.std()) / std - 1.0) < 0.03
    bound = 2.0 * std / 0.87962566103423978
    assert float(w.abs().max()) <= bound + 1e-7
    assert float(model.feature_head.proj.bias.abs().max()) == 0.0
    assert float(model.input_gates.bias.abs().max()) == 0.0


def test_dropout_uses_the_given_generator():
    model = LSTMHead(8, 4, dropout_rate=0.5)
    x = torch.randn(3, 6, 8)
    a = model(x, train=True, generator=torch.Generator().manual_seed(5))
    b = model(x, train=True, generator=torch.Generator().manual_seed(5))
    c = model(x, train=True, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
