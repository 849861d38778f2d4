"""Data-parallel train and eval steps (port of ``ctc_tpu/parallel/steps.py``).

JAX runs the step under ``shard_map`` over the mesh's ``data`` axis and
``pmean``s the gradients, the loss, the BatchNorm statistics and the
metrics with ``lax.pmean``.  The port runs the same step on every rank of
the process group, each on its rows of the batch:

* :func:`replicate` gives the state rank 0's weights and hangs the state's
  :class:`~ctc_tpu_torch.parallel.collectives.GradExchange` on it;
* the train step all-reduces, after each backward, one flat buffer that
  holds the gradient (the parameters' ``.grad`` view it), the BatchNorm
  running statistics and the loss, top-1 and top-5, and divides by the
  rank count, so the optimizer and its guards (``skip_nonfinite``, the
  grad norm, the accumulation) see the reduced gradient on every rank
  alike;
* BatchNorm syncs its batch statistics over the ranks
  (:func:`ctc_tpu_torch.models.lstm.sync_batch_norm`);
* each rank draws its own dropout masks (JAX folds the shard index into
  the key).

``DistributedDataParallel`` is not used: its bucket hooks do not capture
into a CUDA graph, and ``ctc_tpu``'s exchange is an explicit ``pmean``.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.parallel.collectives import (
    GradExchange,
    broadcast_,
    pmean_metrics,
)
from ctc_tpu_torch.train.graphs import MultiStep
from ctc_tpu_torch.train.trainer import make_eval_step, make_train_step


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of its host's batch: the host's ranks keep equal
    contiguous row blocks in rank order, so the global batch (every host's
    batch, in host order) is JAX's ``make_array_from_process_local_data``
    array row for row.  The identity on a mesh without a data axis."""
    if mesh.data is None:
        return batch
    n, i = mesh.local_ranks, mesh.local_rank
    rows = len(next(iter(batch.values())))
    if rows % n:
        raise ValueError(f"a host batch of {rows} rows does not split over "
                         f"the host's {n} ranks")
    size = rows // n
    return {k: v[i * size:(i + 1) * size] for k, v in batch.items()}


def replicate(state, mesh):
    """Give ``state`` rank 0's parameters, BatchNorm statistics, optimizer
    tensors and batch count, in place, and its gradient exchange over the
    mesh's data axis (made once, so a captured graph stays valid when a
    restored state is replicated again).  Returns ``state``."""
    if state.exchange is None:
        state.exchange = GradExchange(state.model, mesh.group)
    tensors = [p.detach() for p in state.model.parameters()]
    tensors += list(state.model.buffers())
    if state.optimizer is not None:
        tensors += state.optimizer.tensors()
    broadcast_([*tensors, state.step], mesh.group)
    return state


def make_sharded_train_step(model, mesh, loss_kind: str = "noblank",
                            implementation=None, ce_weight: float = 0.0,
                            schedule=None, loss_fn=None):
    """The train step of :func:`ctc_tpu_torch.train.trainer.make_train_step`
    on every rank of ``mesh``'s data axis, with ``model``'s BatchNorm synced
    over the ranks and the exchange of a :func:`replicate`'d state.  A
    composed mesh passes its loss as ``loss_fn`` (the class-sharded or the
    sequence-sharded loss with ``batch_axis='data'``)."""
    # imported here: models.lstm imports this package's collectives
    from ctc_tpu_torch.models.lstm import sync_batch_norm

    sync_batch_norm(model, mesh.group)
    step = make_train_step(loss_kind, implementation, ce_weight, schedule,
                           loss_fn=loss_fn)

    def sharded_train_step(state, batch, generator=None):
        if state.exchange is None:
            raise ValueError("a data-parallel step needs a replicated "
                             "state: replicate(state, mesh) first")
        return step(state, batch, generator)

    return sharded_train_step


def make_sharded_eval_step(model, mesh, loss_kind: str = "noblank",
                           implementation=None,
                           transition_metrics: bool = False, loss_fn=None):
    """The eval step on every rank, its metrics pmean'd over the ranks in
    one all-reduce: every metric is a mean over equal shares of the batch,
    so this is the whole batch's."""
    del model  # running statistics: nothing to sync
    step = make_eval_step(loss_kind, implementation, loss_fn=loss_fn,
                          transition_metrics=transition_metrics)

    def sharded_eval_step(state, batch):
        return pmean_metrics(step(state, batch), mesh.group)

    return sharded_eval_step


def _captures(mesh) -> bool:
    """Whether a K-step group on ``mesh`` runs as one CUDA graph: on the
    card, unless the collectives are gloo's, which a graph cannot hold."""
    return mesh.devices[0].type == "cuda" and mesh.backend != "gloo"


def make_sharded_multi_train_step(model, mesh, loss_kind: str = "noblank",
                                  implementation=None,
                                  ce_weight: float = 0.0, schedule=None,
                                  loss_fn=None, *, k: int,
                                  generator: torch.Generator | None = None):
    """K data-parallel train steps a group: one CUDA graph on the card
    under NCCL, its all-reduces inside; K steps in turn under gloo and on
    the CPU, with the same result."""
    step = make_sharded_train_step(model, mesh, loss_kind, implementation,
                                   ce_weight, schedule, loss_fn)
    return MultiStep(step, k, train=True, device=mesh.devices[0],
                     generator=generator, capture=_captures(mesh))


def make_sharded_multi_eval_step(model, mesh, loss_kind: str = "noblank",
                                 implementation=None,
                                 transition_metrics: bool = False,
                                 loss_fn=None, *, k: int):
    """K data-parallel eval steps a group, as
    :func:`make_sharded_multi_train_step` runs them."""
    step = make_sharded_eval_step(model, mesh, loss_kind, implementation,
                                  transition_metrics, loss_fn)
    return MultiStep(step, k, train=False, device=mesh.devices[0],
                     capture=_captures(mesh))
