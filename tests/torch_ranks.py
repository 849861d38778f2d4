"""Rank bodies for the port's multi-process tests: each runs in a process of
its own (``ctc_tpu_torch.parallel.launch.spawn_ranks``), joins a gloo
process group on the CPU through a rendezvous file, and returns numpy
arrays to the test.  No JAX here: a spawned rank imports this module and
the port only.

Every launch is bounded (:data:`TIMEOUT`): a rank that hangs fails its test
and ends the other ranks, rather than holding the suite.
"""

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 120  # seconds, a whole launch


def spawn(target, args, world):
    """``target(rank, world, *args)`` on ``world`` gloo ranks; their
    results in rank order."""
    from ctc_tpu_torch.parallel.launch import spawn_ranks

    return spawn_ranks(target, (world, *args), world, timeout=TIMEOUT)


def _join(rank, world, rdzv):
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            world_size=world, rank=rank)


def _np_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _grads(model):
    return {k: p.grad.detach().numpy().copy()
            for k, p in model.named_parameters()}


def data_parallel_case(rank, world, rdzv, weights, batches, lr, classes,
                       feat_dim, k):
    """Train steps of ``make_sharded_train_step`` over ``batches`` from
    ``weights`` (dropout 0, constant ``lr``): per-step metrics, the reduced
    gradient of the first step, the state after each step; then the same
    steps again from ``weights`` as groups of ``k`` through
    ``make_sharded_multi_train_step``, and the states of both runs."""
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.parallel import (
        make_mesh,
        make_sharded_multi_train_step,
        make_sharded_train_step,
        replicate,
        shard_batch,
    )
    from ctc_tpu_torch.train.trainer import (
        TrainState,
        to_device,
        torch_style_adam,
    )

    _join(rank, world, rdzv)
    try:
        mesh = make_mesh(data=world, device="cpu")

        def fresh():
            model = LSTMHead(feat_dim, classes, dropout_rate=0.0)
            model.load_state_dict(
                {n: torch.as_tensor(w) for n, w in weights.items()})
            state = TrainState(model, torch_style_adam(model.parameters()))
            return replicate(state, mesh)

        state = fresh()
        step = make_sharded_train_step(state.model, mesh, "noblank",
                                       schedule=lambda count: lr)
        out = {"metrics": [], "states": [], "grads": None}
        for i, batch in enumerate(batches):
            state, m = step(state, to_device(shard_batch(batch, mesh),
                                             "cpu"))
            out["metrics"].append({key: float(v) for key, v in m.items()})
            out["states"].append(_np_state(state.model))
            if i == 0:
                out["grads"] = _grads(state.model)
        multi_state = fresh()
        multi = make_sharded_multi_train_step(
            multi_state.model, mesh, "noblank", schedule=lambda count: lr,
            k=k)
        rows = []
        for g in range(0, len(batches), k):
            group = [shard_batch(b, mesh) for b in batches[g:g + k]]
            m = multi(multi_state, group)
            rows += [float(x) for x in m["loss"]]
        out["multi_losses"] = rows
        out["multi_state"] = _np_state(multi_state.model)
        return out
    finally:
        dist.destroy_process_group()


def batch_norm_case(rank, world, rdzv, x, cot):
    """A BatchNorm-only model on this rank's rows of ``x [T, B, F]``:
    the output, the gradient of ``mean_b(sum(out * cot))`` with respect to
    this rank's rows of x (one backward through the synced statistics),
    the parameters' gradients pmean'd over the ranks, and the running
    statistics."""
    from ctc_tpu_torch.models import TemporalBatchNorm
    from ctc_tpu_torch.parallel.collectives import GradExchange

    _join(rank, world, rdzv)
    try:
        bn = TemporalBatchNorm(x.shape[2], group=dist.group.WORLD)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[2]))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[2]))
        exchange = GradExchange(bn, dist.group.WORLD)
        size = x.shape[1] // world
        rows = slice(rank * size, (rank + 1) * size)
        xs = torch.tensor(x[:, rows], requires_grad=True)
        exchange.begin()
        out = bn(xs, train=True)
        loss = (out * torch.as_tensor(cot[:, rows])).sum(dim=(0, 2)).mean()
        loss.backward()
        (mean_loss,) = exchange.finish(loss.detach())
        return {"out": out.detach().numpy(), "x_grad": xs.grad.numpy(),
                "loss": float(mean_loss), "grads": _grads(bn),
                "stats": {k: v.numpy().copy()
                          for k, v in bn.state_dict().items()
                          if k.startswith("running")}}
    finally:
        dist.destroy_process_group()


def composed_cases(rank, world, rdzv, cases, batches, weights):
    """Each case ``(name, second_axis, size, loss_kind, microbatches,
    steps)`` trains ``steps`` steps of a :class:`Trainer` on a ``(world,
    size)`` mesh from ``weights[name]`` (dropout 0), after one eval step at
    those weights; returns per case the eval loss, the train losses and the
    reduced gradient of the first step."""
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.parallel import make_mesh
    from ctc_tpu_torch.train import Trainer

    _join(rank, world, rdzv)
    try:
        out = {}
        for name, axis, size, loss_kind, microbatches, steps in cases:
            mesh = make_mesh(data=world, device="cpu", **{axis: size})
            w = weights[name]
            classes = w["input_gates.bias"].shape[0] // 4
            feat_dim = w["feature_head.proj.weight"].shape[1]
            flags = ({"model_parallel": size} if axis == "model"
                     else {"seq_parallel": size,
                           "seq_microbatches": microbatches})
            tr = Trainer(LSTMHead(feat_dim, classes, dropout_rate=0.0),
                         loss_kind=loss_kind, lr=1e-3, seed=0, mesh=mesh,
                         **flags)
            state = tr.init_state({n: torch.as_tensor(v)
                                   for n, v in w.items()})
            batch = batches[name]
            ev = tr._run_group(state, [batch], train=False)[0]
            losses, grads = [], None
            for i in range(steps):
                rows = tr._run_group(state, [batch], train=True)
                losses.append(rows[0]["loss"])
                if i == 0:
                    grads = _grads(state.model)
            out[name] = {"losses": losses, "eval_loss": ev["loss"],
                         "grads": grads}
        return out
    finally:
        dist.destroy_process_group()


def failing_rank(rank, world):
    """Rank 1 raises; rank 0 would wait for it for ever."""
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    import time

    time.sleep(600)
    return np.zeros(1)


class _FailOnce:
    """The batches, as a loader that raises once, in its ``at``-th pass
    before its second batch."""

    def __init__(self, batches, at):
        self.batches, self.at, self.passes = batches, at, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        self.passes += 1
        for i, b in enumerate(self.batches):
            if self.passes == self.at and i == 1:
                raise RuntimeError("loader fault")
            yield b


def restart_case(rank, world, rdzv, weights, batches, cache):
    """``Trainer.fit(max_restarts=1)`` on a data mesh over a loader that
    fails in epoch 1, and a run that never fails, from ``weights``: both
    final states."""
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.parallel import make_mesh
    from ctc_tpu_torch.train import Trainer

    _join(rank, world, rdzv)
    try:
        mesh = make_mesh(data=world, device="cpu")
        out = {}
        for name, loader in (("restarted", _FailOnce(batches, at=2)),
                             ("clean", batches)):
            w = {n: torch.as_tensor(v) for n, v in weights.items()}
            tr = Trainer(LSTMHead(w["feature_head.proj.weight"].shape[1],
                                  w["input_gates.bias"].shape[0] // 4,
                                  dropout_rate=0.0),
                         lr=1e-2, seed=0, mesh=mesh,
                         cache_dir=f"{cache}/{name}")
            state, history = tr.fit(loader, batches[:1], epochs=3,
                                    state=tr.init_state(w), max_restarts=1)
            out[name] = {"state": _np_state(state.model),
                         "epochs": len(history)}
        return out
    finally:
        dist.destroy_process_group()
