"""``--compute-dtype bf16`` and ``--i3d-act-dtype bf16`` on the CPU:
ctc_tpu_torch's bf16 modules against ctc_tpu's, from the same weights.

Bounds: ``tests/test_mixed_precision.py``'s, which hold ctc_tpu's bf16
modules to its f32 ones: the LSTM head rtol/atol 0.05, Unit3D rtol 0.1 /
atol 0.05, the I3D with bf16 activations a relative deviation (max |dev| /
max |f32|) under 0.1.  The two frameworks round to bf16 at the same places
(the matmul and conv inputs and outputs, flax's ``Dense(dtype=)`` and
``Conv(dtype=)``), but sum in another order, so the same bounds hold the
port's bf16 to ctc_tpu's bf16.  Outputs are float32 where ctc_tpu's are.
"""

import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu.cli.main import main as jax_main
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.models.i3d import InceptionI3d as JaxI3d
from ctc_tpu.models.i3d import Unit3D as JaxUnit3D
from ctc_tpu.models.i3d import convert_torch_state_dict
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.models import (
    I3DLSTM,
    InceptionI3d,
    LSTMHead,
    Unit3D,
    i3d_from_jax,
    lstm_head_from_jax,
)

from test_torch_i3d import clips, port_i3d

BF16 = torch.bfloat16


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_dev(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lstm_head_bf16_matches_jax(rng, train):
    """feature_head.proj and input_gates in bf16 (bias add included); the
    BatchNorm, the recurrent matmul and the carry in f32: the output is
    f32 and within the bounds of ctc_tpu's bf16 head and of the f32 one."""
    feats = rng.standard_normal((6, 4, 64)).astype(np.float32)
    jmodel = JaxLSTMHead(hidden=12, dropout_rate=0.0, dtype=jnp.bfloat16)
    variables = JaxLSTMHead(hidden=12, dropout_rate=0.0).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(feats), train=True)
    want = jmodel.apply(variables, jnp.asarray(feats), train=train,
                        mutable=["batch_stats"])[0]
    sd = lstm_head_from_jax(np_tree(variables["params"]),
                            np_tree(variables["batch_stats"]))
    model = LSTMHead(64, 12, dropout_rate=0.0, dtype=BF16)
    model.load_state_dict(sd)
    f32 = LSTMHead(64, 12, dropout_rate=0.0)
    f32.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), train=train)
        ref = f32(torch.from_numpy(feats), train=train)
    assert got.dtype == torch.float32
    assert model.recurrent_kernel.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0.05,
                               atol=0.05)
    assert not torch.equal(got, ref)  # the matmuls did run in bf16


def test_unit3d_bf16_matches_jax(rng):
    x = rng.standard_normal((2, 6, 16, 16, 8)).astype(np.float32)
    jmod = JaxUnit3D(12, (3, 3, 3), dtype=jnp.bfloat16)
    variables = JaxUnit3D(12, (3, 3, 3)).init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = Unit3D(8, 12, (3, 3, 3), dtype=BF16)
    port.load_state_dict(i3d_from_jax(np_tree(variables["params"]),
                                      np_tree(variables["batch_stats"])))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.float32  # BN and the activation stay f32
    assert port.conv3d.weight.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0.1, atol=0.05)


@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_i3d_bf16_matches_jax(act):
    """InceptionI3d(dtype=bf16, act_dtype=...) to Mixed_3c on 56 x 56
    clips: within rel 0.1 of ctc_tpu's same-dtype module and of the port's
    f32 one; bf16 activations give bf16 features, as in ctc_tpu."""
    act_dtype = BF16 if act == "bf16" else torch.float32
    jact = jnp.bfloat16 if act == "bf16" else jnp.float32
    f32 = port_i3d(3, final_endpoint="Mixed_3c", num_classes=None)
    port = InceptionI3d(num_classes=None, final_endpoint="Mixed_3c",
                        dtype=BF16, act_dtype=act_dtype)
    port.load_state_dict(f32.state_dict())
    x = clips((1, 2, 10, 56, 56, 3), 4)
    want = np.asarray(JaxI3d(final_endpoint="Mixed_3c",
                             dtype=jnp.bfloat16, act_dtype=jact).apply(
        convert_torch_state_dict(f32.state_dict()), jnp.asarray(x)),
        np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        ref = f32(torch.from_numpy(x))
    assert got.dtype == act_dtype
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert rel_dev(got, want) < 0.1
    assert rel_dev(got, ref.numpy()) < 0.1


def test_pixels_head_stays_f32():
    """In pixels mode --compute-dtype bf16 reaches the convolutions only:
    the head computes in f32 on f32 features."""
    model = I3DLSTM(hidden=5, dropout_rate=0.0, final_endpoint="Mixed_3c",
                    i3d_dtype=BF16, i3d_act_dtype=BF16)
    assert model.head.dtype is None and model.head.feature_head.dtype is None
    assert model.i3d.Mixed_3b.b0.dtype == BF16
    x = torch.from_numpy(clips((2, 2, 10, 56, 56, 3), 5))
    with torch.no_grad():
        out = model(x)
    assert out.dtype == torch.float32 and out.shape == (2, 2, 5)


def test_cli_bf16_runs_like_jax(tmp_path, monkeypatch):
    """``--compute-dtype bf16`` on the synthetic main path from the same
    initial weights as ctc_tpu's CLI under the same flag: each epoch's
    train and val loss within rtol 0.05 of ctc_tpu's."""
    from ctc_tpu.train import Trainer as JaxTrainer
    from ctc_tpu_torch.train import Trainer

    weights = {}
    jax_init = JaxTrainer.init_state

    def jax_init_keeping_weights(self, batch):
        state = jax_init(self, batch)
        weights["jax"] = lstm_head_from_jax(np_tree(state.params),
                                            np_tree(state.batch_stats))
        return state

    port_init = Trainer.init_state
    monkeypatch.setattr(JaxTrainer, "init_state", jax_init_keeping_weights)
    monkeypatch.setattr(Trainer, "init_state",
                        lambda self, state_dict=None:
                        port_init(self, weights["jax"]))
    argv = ["--dataset", "synthetic", "--extract-feat-dim", "16",
            "--batch-size", "4", "--temporal", "4", "--epochs", "2",
            "--dropout", "0", "--compute-dtype", "bf16"]
    rows = {}
    for pkg, entry, extra in (("jax", jax_main, ["--lattice-impl", "xla"]),
                              ("torch", main, ["--device", "cpu"])):
        entry(argv + extra + ["--cache-dir", str(tmp_path / pkg)])
        with open(tmp_path / pkg / "test" / "score.csv", newline="") as f:
            rows[pkg] = [[float(c) for c in r] for r in csv.reader(f)]
    assert len(rows["torch"]) == 2
    np.testing.assert_allclose([r[1:3] for r in rows["torch"]],
                               [r[1:3] for r in rows["jax"]], rtol=0.05)
