"""ctc_tpu_torch's data axis against ctc_tpu's on the CPU.

The port's ranks are gloo processes (``tests/torch_ranks.py``), each on its
rows of the batch; JAX's sharded step runs on ``make_mesh(data=D)`` over
conftest's virtual CPU devices.  From the same weights, dropout off, over 4
steps of Adam at a constant learning rate:

* the loss to rtol 1e-5 (f32 on both sides, sums in another order), top-1
  and top-5 equal;
* parameters and BatchNorm statistics to rtol 1e-5 / atol 1e-6, except
  ``feature_head.proj.bias`` and the running mean that carries it, whose
  gradient is zero up to rounding (the per-timestep BatchNorm removes any
  shift), held to 2 lr an update (``tests/torch_trainer_pair.py``);
* the first step's reduced gradient, BatchNorm's parameters included,
  against the gradient of the whole batch on one device (rtol 1e-4 /
  atol 1e-6: the pmean of the ranks' means against one mean).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_tpu import losses as jax_losses
from ctc_tpu.data import synthetic_feature_batches
from ctc_tpu.models import LSTMHead as JaxLSTMHead
from ctc_tpu.parallel import make_mesh as jax_make_mesh
from ctc_tpu.parallel import make_sharded_train_step as jax_sharded_step
from ctc_tpu.parallel import replicate as jax_replicate
from ctc_tpu.parallel import shard_batch as jax_shard_batch
from ctc_tpu.train.trainer import TrainState as JaxTrainState
from ctc_tpu.train.trainer import torch_style_adam as jax_adam
from ctc_tpu_torch.models import LSTMHead, TemporalBatchNorm, lstm_head_from_jax
from ctc_tpu_torch.parallel import (
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
)
from ctc_tpu_torch.parallel.collectives import pmean, psum
from ctc_tpu_torch.parallel.launch import spawn_ranks
from ctc_tpu_torch.parallel.mesh import pick_backend, rank_devices
from ctc_tpu_torch.train import Trainer
from torch_ranks import (
    TIMEOUT,
    batch_norm_case,
    data_parallel_case,
    failing_rank,
    restart_case,
    spawn,
)

T, B, F, C = 8, 8, 16, 9
LR = 1e-2
STEPS = 4
K = 4  # one group of make_sharded_multi_train_step
BIAS_CARRIERS = ("feature_head.proj.bias", "feature_head.bn.running_mean")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches():
    return synthetic_feature_batches(num_batches=STEPS, batch_size=B,
                                     temporal=T, feat_dim=F, num_classes=C,
                                     seed=5)


def _jax_init():
    model = JaxLSTMHead(hidden=C, dropout_rate=0.0)
    variables = model.init(jax.random.PRNGKey(3),
                           jnp.zeros((T, B, F), jnp.float32), train=False)
    return model, variables["params"], variables["batch_stats"]


def _jax_whole_batch_grads(model, params, stats, batch):
    """d loss / d params over the whole batch on one device, in the port's
    parameter names."""
    feats = jnp.transpose(jnp.asarray(batch["feats"]), (1, 0, 2))

    def loss_of(p):
        logits, _ = model.apply({"params": p, "batch_stats": stats}, feats,
                                train=True, mutable=["batch_stats"])
        return jax_losses.no_blank_ctc_loss(
            logits, jnp.asarray(batch["paths"]),
            jnp.asarray(batch["input_lengths"]),
            jnp.asarray(batch["target_lengths"]), implementation="xla")

    grads = jax.grad(loss_of)(params)
    out = lstm_head_from_jax(_np_tree(grads), _np_tree(stats))
    return {k: v.numpy() for k, v in out.items()
            if not k.startswith("feature_head.bn.running")}


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def data_parallel(request, tmp_path_factory):
    """JAX's sharded step on a D-device mesh and the port's D gloo ranks,
    from one set of weights, over the same batches."""
    world = request.param
    model, params, stats = _jax_init()
    batches = _batches()
    weights = {k: v.numpy()
               for k, v in lstm_head_from_jax(_np_tree(params),
                                              _np_tree(stats)).items()}
    mesh = jax_make_mesh(data=world, devices=jax.devices()[:world])
    step = jax_sharded_step(model, mesh, "noblank", implementation="xla")
    jstate = JaxTrainState.create(params=params, batch_stats=stats,
                                  tx=jax_adam(LR))
    jstate = jstate.replace(
        params=jax_replicate(jstate.params, mesh),
        batch_stats=jax_replicate(jstate.batch_stats, mesh),
        opt_state=jax.tree_util.tree_map(
            lambda x: jax_replicate(x, mesh) if hasattr(x, "shape") else x,
            jstate.opt_state))
    want = {"metrics": [], "states": []}
    for batch in batches:
        jstate, m = step(jstate, jax_shard_batch(batch, mesh),
                         jax.random.PRNGKey(0))
        want["metrics"].append({k: float(v) for k, v in m.items()})
        want["states"].append(
            {k: v.numpy() for k, v in lstm_head_from_jax(
                _np_tree(jstate.params), _np_tree(jstate.batch_stats)
            ).items()})
    want["grads"] = _jax_whole_batch_grads(model, params, stats, batches[0])
    rdzv = tmp_path_factory.mktemp(f"dp{world}") / "rdzv"
    got = spawn(data_parallel_case,
                (str(rdzv), weights, batches, LR, C, F, K), world)
    return want, got


def _assert_state_close(got, want, updates, label):
    for name, w in want.items():
        if name in BIAS_CARRIERS:
            np.testing.assert_allclose(got[name], w, rtol=0,
                                       atol=2 * LR * updates,
                                       err_msg=f"{name} {label}")
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {label}")


def test_loss_and_metrics_match_jax_sharded_step(data_parallel):
    want, got = data_parallel
    for i, (w, g) in enumerate(zip(want["metrics"], got[0]["metrics"])):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   err_msg=f"step {i}")
        assert g["top1"] == pytest.approx(w["top1"]), i
        assert g["top5"] == pytest.approx(w["top5"]), i


def test_weights_and_batch_norm_stats_match_jax(data_parallel):
    want, got = data_parallel
    for i, (w, g) in enumerate(zip(want["states"], got[0]["states"])):
        _assert_state_close(g, w, i + 1, f"step {i}")


def test_reduced_gradient_is_the_whole_batch_gradient(data_parallel):
    """BatchNorm's scale and bias, and the projection upstream of it, get
    the one-device gradient only if the synced statistics' backward sums
    every rank's cotangents."""
    want, got = data_parallel
    for name, w in want["grads"].items():
        np.testing.assert_allclose(got[0]["grads"][name], w, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_every_rank_holds_the_same_state(data_parallel):
    _, got = data_parallel
    for rank in got[1:]:
        for name, w in got[0]["states"][-1].items():
            np.testing.assert_array_equal(rank["states"][-1][name], w,
                                          err_msg=name)
        assert rank["metrics"] == got[0]["metrics"]


def test_multi_step_groups_equal_single_steps(data_parallel):
    """``make_sharded_multi_train_step`` (groups of K) gives the single
    steps' losses and state bit for bit."""
    _, got = data_parallel
    for rank in got:
        assert rank["multi_losses"] == [m["loss"] for m in rank["metrics"]]
        for name, w in rank["states"][-1].items():
            np.testing.assert_array_equal(rank["multi_state"][name], w,
                                          err_msg=name)


# ---------------------------------------------------------------------------
# sync BatchNorm alone: two ranks against one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch_norm(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 8, 6)).astype(np.float32) * 3 + 1
    cot = rng.normal(size=x.shape).astype(np.float32)
    rdzv = tmp_path_factory.mktemp("bn") / "rdzv"
    got = spawn(batch_norm_case, (str(rdzv), x, cot), 2)
    one = batch_norm_case_one_rank(x, cot)
    return one, got


def batch_norm_case_one_rank(x, cot):
    bn = TemporalBatchNorm(x.shape[2])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[2]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[2]))
    xs = torch.tensor(x, requires_grad=True)
    out = bn(xs, train=True)
    loss = (out * torch.as_tensor(cot)).sum(dim=(0, 2)).mean()
    loss.backward()
    return {"out": out.detach().numpy(), "x_grad": xs.grad.numpy(),
            "loss": float(loss.detach()),
            "grads": {k: p.grad.numpy() for k, p in bn.named_parameters()},
            "stats": {k: v.numpy() for k, v in bn.state_dict().items()
                      if k.startswith("running")}}


@pytest.mark.parametrize("part", ["output_and_stats", "gradients"])
def test_sync_batch_norm_two_ranks_equal_one(batch_norm, part):
    """Rank r's rows: its output is the one-rank output's rows; its input
    gradient is 2x theirs (each rank's loss is a mean over its half of the
    batch, and the synced statistics' backward brings the other rank's
    share); scale and bias gradients, pmean'd, are the one-rank ones."""
    one, got = batch_norm
    tol = dict(rtol=1e-5, atol=1e-6)
    half = one["out"].shape[1] // 2
    for rank, g in enumerate(got):
        rows = slice(rank * half, (rank + 1) * half)
        if part == "output_and_stats":
            np.testing.assert_allclose(g["out"], one["out"][:, rows], **tol)
            np.testing.assert_allclose(g["loss"], one["loss"], **tol)
            for k, v in one["stats"].items():
                np.testing.assert_allclose(g["stats"][k], v, **tol)
        else:
            np.testing.assert_allclose(g["x_grad"],
                                       2 * one["x_grad"][:, rows], **tol)
            for k, v in one["grads"].items():
                np.testing.assert_allclose(g["grads"][k], v, **tol)


def test_restart_restores_every_rank_from_one_checkpoint(tmp_path):
    """``fit(max_restarts=1)`` on 2 ranks over a loader that fails in
    epoch 1: every rank restores rank 0's epoch-0 checkpoint and ends where
    a run that never failed ends."""
    _, params, stats = _jax_init()
    weights = {k: v.numpy() for k, v in lstm_head_from_jax(
        _np_tree(params), _np_tree(stats)).items()}
    got = spawn(restart_case, (str(tmp_path / "rdzv"), weights, _batches(),
                               str(tmp_path)), 2)
    for rank in got:
        assert rank["restarted"]["epochs"] == rank["clean"]["epochs"] == 3
        for name, w in got[0]["clean"]["state"].items():
            np.testing.assert_array_equal(rank["restarted"]["state"][name],
                                          w, err_msg=name)
    assert sorted(p.name for p in (tmp_path / "restarted" / "ckpt").iterdir()
                  ) == ["0.pt", "1.pt", "2.pt"]


# ---------------------------------------------------------------------------
# the mesh, the batch split, the launcher (no ranks needed)
# ---------------------------------------------------------------------------


def test_make_mesh_rows_and_refusals():
    mesh = make_mesh(device="cpu")  # no process group: one rank
    assert mesh.shape == {"data": 1, "model": 1}
    assert make_mesh(1, seq=4, device="cpu").shape == {"data": 1, "seq": 4}
    assert make_mesh(model=3, device="cpu").devices == (
        torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="one second axis"):
        make_mesh(data=1, model=2, seq=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(seq=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="process group of 2"):
        make_mesh(data=2, device="cpu")


def test_rank_devices_and_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_devices("cuda", 1, 2) == (torch.device("cuda", 2),
                                          torch.device("cuda", 3))
    assert rank_devices("cpu", 3, 2) == (torch.device("cpu"),) * 2
    assert pick_backend("cuda", 4) == "nccl"  # a card a rank
    assert pick_backend("cuda", 2, 2) == "nccl"  # cards 0 and 2 first
    assert pick_backend("cuda", 8) == "gloo"  # ranks share cards
    assert pick_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick_backend("cuda", 1) == "nccl"
    assert pick_backend("cuda", 2) == "gloo"


@pytest.mark.parametrize("data,hosts,rank,rows", [
    (2, 1, 0, slice(0, 4)), (2, 1, 1, slice(4, 8)),
    (4, 2, 2, slice(0, 4)), (4, 2, 3, slice(4, 8)),
])
def test_shard_batch_keeps_the_ranks_rows(data, hosts, rank, rows):
    """A host's ranks keep equal contiguous blocks of the host batch."""
    batch = {"feats": np.arange(8 * 3).reshape(8, 3),
             "lengths": torch.arange(8)}
    mesh = Mesh(devices=(torch.device("cpu"),), axis="model", data=data,
                rank=rank, hosts=hosts)
    got = shard_batch(batch, mesh)
    np.testing.assert_array_equal(got["feats"], batch["feats"][rows])
    assert got["lengths"].tolist() == list(range(8))[rows]


def test_collectives_without_a_group_are_the_identity():
    x = torch.arange(3.0)
    assert psum(x, None) is x and pmean(x, None) is x
    init_distributed(None, 1, 0)  # one process: a no-op, as in JAX
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises while rank 0 would wait for ever: the launch ends
    both and carries rank 1's traceback."""
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn_ranks(failing_rank, (2,), 2, timeout=TIMEOUT)


def test_trainer_refuses_axes_it_cannot_shard():
    model = LSTMHead(F, C, dropout_rate=0.0)
    with pytest.raises(ValueError, match="cannot be combined"):
        Trainer(model, loss_kind="binary", model_parallel=2, seq_parallel=2,
                device="cpu")
    mesh = make_mesh(device="cpu")  # a data-only mesh
    with pytest.raises(ValueError, match="model"):
        Trainer(model, loss_kind="binary", mesh=mesh, model_parallel=4)
    with pytest.raises(ValueError, match="seq"):
        Trainer(model, loss_kind="noblank", mesh=mesh, seq_parallel=4)
    with pytest.raises(ValueError, match="binary"):
        Trainer(model, loss_kind="noblank", model_parallel=2, device="cpu")
