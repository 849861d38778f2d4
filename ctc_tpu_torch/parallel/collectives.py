"""Collectives over a mesh's data axis (the port's ``lax.psum`` / ``pmean``)
and the gradient exchange of a replicated train state.

:func:`psum` is differentiable: its forward all-reduces the sum over the
ranks, and its backward all-reduces the cotangents the same way, which is
how JAX transposes ``psum`` inside ``shard_map``.  Sync BatchNorm and the
composed losses reduce through it, so that each rank's backward carries
every rank's share of a cross-rank statistic.

:class:`GradExchange` is the port of ``ctc_tpu/parallel/steps.py``'s
``pmean`` of the gradients: every parameter's ``.grad`` is a view of one
flat buffer, and after a backward one all-reduce carries that batch's
gradient, the BatchNorm running statistics and the step's metrics.  The
buffer never moves, so a CUDA graph can capture the exchange (NCCL).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world_size(group) -> int:
    """Ranks in ``group``; 1 for no group."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents likewise."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum`` over the ranks of ``group`` (the identity for none)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmean``: :func:`psum` over the rank count."""
    if group is None:
        return x
    return psum(x, group) / world_size(group)


class GradExchange:
    """The data axis's exchange for a model replicated on every rank.

    On construction each parameter that trains has its ``.grad`` made a
    view of ``flat[:n_grad]``; a frozen module (a frozen I3D backbone,
    whose parameters require no gradient) keeps its parameters and its
    running statistics out of the buffer.  A train step calls
    :meth:`begin` before its backward (after the optimizer has cleared or
    kept its gradient sums) and :meth:`finish` after it: ``flat`` then
    holds this batch's local gradient, the running statistics and the
    metrics; one all-reduce and a division by the rank count make each
    their mean over the ranks, and the gradient sums kept from earlier
    batches are added back, as ``MultiSteps`` adds a pmean'd gradient to
    its sum.
    """

    #: metric slots in the buffer: a train step's loss, top-1 and top-5
    METRICS = 3

    def __init__(self, model: torch.nn.Module, group):
        self.group = group
        self.world = world_size(group)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.stats = [b for m in model.modules()
                      if any(p.requires_grad
                             for p in m.parameters(recurse=False))
                      for b in m.buffers(recurse=False)
                      if b.is_floating_point()]
        first = self.params[0]
        self.n_grad = sum(p.numel() for p in self.params)
        self.n_stats = sum(b.numel() for b in self.stats)
        self.flat = torch.zeros(self.n_grad + self.n_stats + self.METRICS,
                                dtype=first.dtype, device=first.device)
        self.kept = torch.zeros(self.n_grad, dtype=first.dtype,
                                device=first.device)
        grads = self.flat[:self.n_grad]
        off = 0
        with torch.no_grad():
            for p in self.params:
                p.grad = grads[off:off + p.numel()].view_as(p)
                off += p.numel()

    @torch.no_grad()
    def begin(self) -> None:
        """Set the gradient sums aside; the backward then writes only this
        batch's gradient into the buffer."""
        grads = self.flat[:self.n_grad]
        self.kept.copy_(grads)
        grads.zero_()

    @torch.no_grad()
    def finish(self, *metrics):
        """After the backward: the mean over the ranks of this batch's
        gradient, of the running statistics and of ``metrics`` (up to
        three 0-d tensors); the gradient sums set aside are added back.
        Returns the metrics' means."""
        n_grad, n_stats = self.n_grad, self.n_stats
        stats = self.flat[n_grad:n_grad + n_stats]
        if self.stats:
            torch.cat([b.reshape(-1) for b in self.stats], out=stats)
        tail = self.flat[n_grad + n_stats:]
        tail[:len(metrics)].copy_(torch.stack(metrics))
        if self.group is not None:
            dist.all_reduce(self.flat, group=self.group)
            self.flat.div_(self.world)
        self.flat[:n_grad].add_(self.kept)
        off = 0
        for b in self.stats:
            b.copy_(stats[off:off + b.numel()].view_as(b))
            off += b.numel()
        return tuple(tail[:len(metrics)].clone().unbind())


@torch.no_grad()
def pmean_metrics(metrics: dict, group) -> dict:
    """A dict of 0-d metric tensors, each the mean over the ranks, in one
    all-reduce."""
    if group is None:
        return metrics
    keys = list(metrics)
    packed = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(packed, group=group)
    packed.div_(world_size(group))
    return dict(zip(keys, packed.unbind()))


@torch.no_grad()
def broadcast_(tensors, group, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in place."""
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
