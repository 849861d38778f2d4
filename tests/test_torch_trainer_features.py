"""ctc_tpu_torch's one-card trainer features against ctc_tpu's on the CPU:
gradient accumulation (``accum_grad``), K steps per dispatch
(``steps_per_dispatch``, train and eval, with and without the sequence
pipeline), ``skip_nonfinite`` on a NaN batch, crash recovery
(``fit(max_restarts=)``) and ``device_prefetch``; on the card, K steps as
one CUDA graph against K eager steps.

Inputs come from a seed with numpy, the weights are carried across by
``lstm_head_from_jax`` and dropout is off wherever the two packages are
compared (they draw dropout from different generators); tolerances as in
``tests/torch_trainer_pair.py``.  The port's K-step path on the CPU runs
the same step function on the same values as its single steps, so the
two are held equal bit for bit (dropout on).

JAX is imported inside the tests: the card's machine has no JAX, and the
``cuda`` tests run there on their own
(``python -m pytest tests/test_torch_trainer_features.py -m cuda``).
"""

import numpy as np
import pytest
import torch

from torch_trainer_pair import (
    BIAS_CARRIERS,
    LOSS_TOL,
    C,
    F,
    assert_same_state,
    assert_state_close,
    batches,
    jax_counts,
    np_tree,
    pair,
    port_counts,
)

from ctc_tpu_torch.train.graphs import to_device


def _port_trainer(dropout=0.0, **flags):
    """A port trainer on the CPU and its state from the trainer's seed."""
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer

    common = dict(loss_kind="noblank", lr=1e-2, seed=0, print_freq=1000,
                  device="cpu")
    tr = Trainer(LSTMHead(F, C, dropout_rate=dropout), **{**common, **flags})
    return tr, tr.init_state()


def test_gradient_accumulation_matches_ctc_tpu():
    """accum_grad=2: the first batch moves no parameter (only BatchNorm's
    statistics and the gradient sum); the second steps Adam once on the
    sum of both gradients, as ctc_tpu's MultiSteps does."""
    bs = batches(2, seed=3)
    (jtr, jstate), (tr, state) = pair(bs[0], accum_grad=2, steps_per_epoch=2)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    for k, batch in enumerate(bs):
        jstate, jm = jtr.train_step(jstate, batch, jtr.rng)
        state, m = tr.train_step(state, to_device(batch, "cpu"),
                                 tr.generator)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        if k == 0:
            for n, p in state.model.named_parameters():
                torch.testing.assert_close(p, before[n], rtol=0, atol=0)
        assert_state_close(state, jstate, f"after batch {k + 1}")
        assert int(state.step) == int(jstate.step) == k + 1
        assert port_counts(state) == jax_counts(jstate.opt_state) == {
            "count": k, "skipped": 0}


def test_steps_per_dispatch_matches_single_steps():
    """K=4 over 6 batches: one group of 4 and a remainder of 2 single
    steps.  The port's K-step epoch equals its single steps bit for bit
    (dropout on), and the validate twin too; with dropout off it matches
    ctc_tpu's K=4 epoch, and its K=4 validation matches ctc_tpu's."""
    from ctc_tpu_torch.models import lstm_head_from_jax

    bs = batches(6, seed=2)
    runs = {}
    for k in (4, 1):
        tr, state = _port_trainer(steps_per_dispatch=k, dropout=0.3)
        state, train_m = tr.train_epoch(state, bs, epoch=0)
        runs[k] = (state, train_m, tr.validate(state, bs, epoch=0))
    (s4, m4, v4), (s1, m1, v1) = runs[4], runs[1]
    assert_same_state(s4, s1)
    assert {k: m4[k] for k in ("loss", "top1", "top5")} == {
        k: m1[k] for k in ("loss", "top1", "top5")}
    assert v4 == v1 and int(s4.step) == 6

    (jtr, jstate), (tr, state) = pair(bs[0], steps_per_dispatch=4)
    jstate, jm = jtr.train_epoch(jstate, bs, epoch=0)
    state, m = tr.train_epoch(state, bs, epoch=0)
    np.testing.assert_allclose(m["loss"], jm["loss"], **LOSS_TOL)
    assert m["top1"] == pytest.approx(jm["top1"])
    assert int(state.step) == int(jstate.step) == 6
    assert_state_close(state, jstate)
    # the validate twin from equal weights: evaluation reads the BatchNorm
    # running mean, which carries proj.bias's platform drift
    state.model.load_state_dict(lstm_head_from_jax(
        np_tree(jstate.params), np_tree(jstate.batch_stats)))
    jv, v = jtr.validate(jstate, bs, epoch=0), tr.validate(state, bs, epoch=0)
    np.testing.assert_allclose(v["loss"], jv["loss"], **LOSS_TOL)
    assert v["top1"] == pytest.approx(jv["top1"])


def test_steps_per_dispatch_with_seq_parallel():
    """K=2 through the sequence-sharded loss (4 shards): the port's K-step
    epoch equals its single steps, and matches ctc_tpu's K=2 epoch."""
    bs = batches(4, seed=8, batch_size=8, temporal=8)
    runs = {}
    for k in (2, 1):
        tr, state = _port_trainer(steps_per_dispatch=k, seq_parallel=4)
        runs[k] = tr.train_epoch(state, bs, epoch=0)
    assert_same_state(runs[2][0], runs[1][0])
    assert runs[2][1]["loss"] == runs[1][1]["loss"]

    (jtr, jstate), (tr, state) = pair(bs[0], steps_per_dispatch=2,
                                      seq_parallel=4)
    jstate, jm = jtr.train_epoch(jstate, bs, epoch=0)
    state, m = tr.train_epoch(state, bs, epoch=0)
    np.testing.assert_allclose(m["loss"], jm["loss"], **LOSS_TOL)
    assert_state_close(state, jstate)


def test_skip_nonfinite_matches_ctc_tpu_step_by_step():
    """A NaN batch is skipped by both packages: the parameters, Adam's
    moments and both counts stay.  The schedule decays every update
    (lr_decay_epochs=1, steps_per_epoch=1), so a count wrongly advanced on
    the skip would change every later learning rate tenfold."""
    bs = batches(4, seed=5, nan_at=(1,))
    (jtr, jstate), (tr, state) = pair(bs[0], skip_nonfinite=True,
                                      lr_decay_epochs=1, steps_per_epoch=1)
    for k, batch in enumerate(bs):
        moments = [t.clone() for t in state.optimizer.tensors()]
        params = [p.detach().clone() for p in state.model.parameters()]
        jstate, jm = jtr.train_step(jstate, batch, jtr.rng)
        state, m = tr.train_step(state, to_device(batch, "cpu"),
                                 tr.generator)
        if k == 1:
            assert np.isnan(float(m["loss"])) and np.isnan(float(jm["loss"]))
            for a, b in zip(params, state.model.parameters()):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            for a, b in zip(moments[:-1], state.optimizer.tensors()[:-1]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       **LOSS_TOL)
        assert_state_close(state, jstate, f"after batch {k + 1}")
        assert port_counts(state) == jax_counts(jstate.opt_state)
        assert int(state.step) == int(jstate.step) == k + 1
    assert port_counts(state) == {"count": 3, "skipped": 1}


def test_steps_per_dispatch_with_accumulation_and_a_nan_batch():
    """K=4, accum_grad=2, skip_nonfinite, and a NaN in batch 3 of 8: the
    port's epoch matches ctc_tpu's under the same flags, and its K-step
    epoch equals its single steps.  In ctc_tpu the NaN stays in the
    gradient sum (MultiSteps resets it by multiplying by 0), so every
    later update is skipped; the port does the same."""
    bs = batches(8, seed=6, nan_at=(2,))
    flags = dict(accum_grad=2, skip_nonfinite=True, steps_per_epoch=8)
    (jtr, jstate), (tr, state) = pair(bs[0], steps_per_dispatch=4, **flags)
    jstate, jm = jtr.train_epoch(jstate, bs, epoch=0)
    state, m = tr.train_epoch(state, bs, epoch=0)
    assert np.isnan(m["loss"]) and np.isnan(jm["loss"])
    assert_state_close(state, jstate)
    assert port_counts(state) == jax_counts(jstate.opt_state) == {
        "count": 1, "skipped": 3}

    runs = {}
    for k in (4, 1):
        tr, state = _port_trainer(steps_per_dispatch=k, dropout=0.3, **flags)
        runs[k] = tr.train_epoch(state, bs, epoch=0)[0]
    assert_same_state(runs[4], runs[1])


class _FlakyLoader:
    """Iterable that raises once, when iterated for epoch ``fail_epoch``."""

    def __init__(self, batches, fail_epoch):
        self.batches = batches
        self.fail_epoch = fail_epoch
        self.iterations = 0

    def __iter__(self):
        epoch = self.iterations
        self.iterations += 1
        if epoch == self.fail_epoch:
            raise RuntimeError("injected data failure")
        return iter(self.batches)


def test_fit_auto_resumes_after_crash(tmp_path, capsys):
    """max_restarts=1: the epoch that raises restores the last checkpoint
    in place and the run completes its 4 epochs; without restarts the
    crash propagates (ctc_tpu's test_fit_auto_resumes_after_crash)."""
    from ctc_tpu_torch.train import checkpoints as ckpt

    bs, val = batches(3, seed=0), batches(1, seed=1)
    tr, state = _port_trainer(steps_per_epoch=3, lr=1e-3,
                              cache_dir=str(tmp_path))
    step = state.step
    state, history = tr.fit(_FlakyLoader(bs, fail_epoch=2), val, epochs=4,
                            state=state, max_restarts=1)
    assert len(history) == 4
    assert all(np.isfinite(h["train"]["loss"]) for h in history)
    assert ("epoch 2 failed (RuntimeError: injected data failure); "
            "restored epoch 1, restart 1") in capsys.readouterr().out
    assert state.step is step and int(step) == 12
    _, epoch, _ = ckpt.load(str(tmp_path), _port_trainer()[1])
    assert epoch == 3

    tr2, state2 = _port_trainer(steps_per_epoch=3,
                                cache_dir=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="injected"):
        tr2.fit(_FlakyLoader(bs, 1), val, epochs=3, state=state2,
                max_restarts=0)


def test_device_prefetch_preserves_order_and_values():
    from ctc_tpu_torch.data.loading import device_prefetch

    bs = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    out = list(device_prefetch(bs, depth=2, device="cpu"))
    assert [int(np.asarray(b["x"])[0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    assert list(device_prefetch([], depth=2, device="cpu")) == []


def test_trainer_takes_prefetched_batches():
    """Batches that device_prefetch already converted train as host
    batches do, in K-step groups and single steps alike."""
    from ctc_tpu_torch.data.loading import device_prefetch

    bs = batches(6, seed=4)
    runs = []
    for loader in (bs, list(device_prefetch(bs, device="cpu"))):
        tr, state = _port_trainer(steps_per_dispatch=4)
        runs.append(tr.train_epoch(state, loader, epoch=0))
    assert_same_state(runs[0][0], runs[1][0])
    assert runs[0][1]["loss"] == runs[1][1]["loss"]


# ---------------------------------------------------------------------------
# on the card: K steps as one CUDA graph against K eager steps
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


GRAPH_TOL = dict(rtol=1e-5, atol=1e-6)  # ctc_tpu's own K-step tolerance
GRAPH_LR = 1e-2


def _graph_and_eager(loss, *, k=8, groups=2, nan_at=(), **flags):
    """Train ``groups`` groups of ``k`` batches through one captured graph
    (captured on the first group, replayed on each) and the same batches
    as eager steps, from the same weights and dropout generator; returns
    both states and the per-step metrics."""
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer
    from ctc_tpu_torch.train.graphs import MultiStep, host_rows

    classes = 9 if loss == "noblank" else 7
    # blank CTC: paths of at most T/2 labels, so every target is feasible
    bs = batches(k * groups, seed=11, nan_at=nan_at, batch_size=8,
                 temporal=8, classes=classes,
                 max_path=(4 if loss == "blank" else None))
    out = {}
    for mode in ("graph", "eager"):
        tr = Trainer(LSTMHead(F, classes, dropout_rate=0.3), loss_kind=loss,
                     lr=GRAPH_LR, seed=0, device="cuda", **flags)
        state = tr.init_state()
        rows = []
        if mode == "graph":
            multi = MultiStep(tr.train_step, k, train=True, device="cuda",
                              generator=tr.generator)
            for g in range(groups):
                rows += host_rows(multi(state, bs[g * k:(g + 1) * k]))
        else:
            for b in bs:
                state, m = tr.train_step(state, to_device(b, "cuda"),
                                         tr.generator)
                rows += host_rows({key: v[None] for key, v in m.items()})
        torch.cuda.synchronize()
        out[mode] = (state, rows)
    return out


def _assert_graph_equals_eager(out):
    """Metrics, parameters, BatchNorm statistics, Adam's moments and the
    counts at GRAPH_TOL; ``feature_head.proj.bias`` and the running mean
    that carries it at 2 lr an update (``tests/torch_trainer_pair.py``):
    its gradient is rounding noise, and the blank loss's emission gather
    adds the gradients of the repeated blank slot by atomics, in no fixed
    order, so that noise differs from run to run."""
    (sg, rg), (se, re_) = out["graph"], out["eager"]
    assert len(rg) == len(re_)
    for a, b in zip(rg, re_):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in a],
                                   **GRAPH_TOL)
    bias_atol = 2 * GRAPH_LR * max(int(se.optimizer.count), 1)
    for (name, x), y in zip(sg.model.state_dict().items(),
                            se.model.state_dict().values()):
        tol = (dict(rtol=0, atol=bias_atol) if name in BIAS_CARRIERS
               else GRAPH_TOL)
        torch.testing.assert_close(x, y, equal_nan=True, msg=name, **tol)
    for x, y in zip([*sg.optimizer.tensors(), sg.step],
                    [*se.optimizer.tensors(), se.step]):
        torch.testing.assert_close(x, y, equal_nan=True, **GRAPH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("loss,flags", [
    ("noblank", {}),
    ("blank", {}),
    ("noblank", {"seq_parallel": 4}),
], ids=["noblank", "blank", "seq4"])
def test_graph_steps_equal_eager_steps_on_card(cuda_device, loss, flags):
    """K=8 steps as one graph, dropout 0.3, equal 8 eager steps from the
    same state and generator: metrics, parameters, BatchNorm statistics,
    Adam's moments and the counts."""
    _assert_graph_equals_eager(_graph_and_eager(loss, **flags))


@pytest.mark.cuda
def test_graph_steps_skip_a_nan_batch_like_eager_on_card(cuda_device):
    out = _graph_and_eager("noblank", nan_at=(3,), skip_nonfinite=True)
    _assert_graph_equals_eager(out)
    assert int(out["graph"][0].optimizer.skipped) == 1


@pytest.mark.cuda
def test_graph_steps_accumulate_like_eager_on_card(cuda_device):
    out = _graph_and_eager("noblank", accum_grad=2, grad_norm_freq=2)
    _assert_graph_equals_eager(out)
    assert int(out["graph"][0].optimizer.count) == 8


@pytest.mark.cuda
def test_graph_validate_equals_eager_on_card(cuda_device):
    """The eval twin: validate with K=4 (one graph) equals K=1."""
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer

    bs = batches(8, seed=12, batch_size=8)
    metrics = []
    for k in (4, 1):
        tr = Trainer(LSTMHead(F, C), lr=1e-2, seed=0, device="cuda",
                     steps_per_dispatch=k, transition_metrics=True)
        state = tr.init_state()
        state, _ = tr.train_epoch(state, bs[:4], epoch=0)
        metrics.append(tr.validate(state, bs, epoch=0))
    assert metrics[0].keys() == metrics[1].keys()
    np.testing.assert_allclose(list(metrics[0].values()),
                               list(metrics[1].values()), **GRAPH_TOL)


@pytest.mark.cuda
def test_failed_capture_raises_on_card(cuda_device):
    """A step the graph cannot hold (a copy from pageable host memory)
    raises at capture; no eager step stands in for it."""
    from ctc_tpu_torch import losses
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer
    from ctc_tpu_torch.train.graphs import MultiStep
    from ctc_tpu_torch.train.trainer import make_train_step

    def host_bound_loss(*args, **kwargs):
        return (losses.no_blank_ctc_loss(*args, **kwargs)
                + torch.zeros(()).to(cuda_device))

    tr = Trainer(LSTMHead(F, C), device="cuda")
    state = tr.init_state()
    step = make_train_step("noblank", None, 0.0, tr.schedule,
                           loss_fn=host_bound_loss)
    multi = MultiStep(step, 2, train=True, device="cuda",
                      generator=tr.generator)
    with pytest.raises(RuntimeError, match="CUDA graph capture of 2 train"):
        multi(state, batches(2, seed=13))
