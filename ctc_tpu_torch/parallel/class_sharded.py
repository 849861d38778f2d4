"""Class-axis (model-parallel) sharding of the multi-label binary CTC (port
of ``ctc_tpu/parallel/class_sharded.py``).

The per-class binary scores of NoBlankBinaryCTC are independent until their
BCE terms are averaged over the classes, so the class axis splits over a
mesh's ``model`` shards: shard k computes the partial emissions ``[T, B,
L]`` of its classes on its own device, the partials are summed on the
loss's device (JAX's ``psum`` over ``model``), divided by the class count,
and the lattice runs once (rows 1-2 on the card).  Autograd sends each
shard's gradient back to its class slice.

Like the seq pipeline, one process drives the shards of its mesh row in
turn.  With ``batch_axis`` the batch is also split over the data axis's
ranks (the data x model composition): each rank holds its rows, and the
reduction is pmean'd or psum'd over the ranks.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops import dispatch
from ctc_tpu_torch.ops.logspace import clamped_log_sigmoid_pair
from ctc_tpu_torch.parallel.collectives import pmean, psum
from ctc_tpu_torch.parallel.mesh import MODEL_AXIS


def shard_class_axis(x, mesh):
    """Split ``x`` along its last axis into the mesh's equal class slices,
    slice k on shard k's device."""
    n = len(mesh.devices)
    if x.shape[-1] % n:
        raise ValueError(f"{x.shape[-1]} classes do not split into {n} "
                         "model shards; pad them first")
    c_shard = x.shape[-1] // n
    return [x[..., k * c_shard:(k + 1) * c_shard].to(dev)
            for k, dev in enumerate(mesh.devices)]


def _partial_emissions(logits, paths, first_class: int, num_classes: int):
    """One shard's share of the summed BCE emissions ``[T, B, L]``: its
    classes from global index ``first_class``, pad classes (index past
    ``num_classes``) masked out."""
    c_shard = logits.shape[2]
    global_c = first_class + torch.arange(c_shard, device=logits.device)
    valid = (global_c < num_classes).to(logits.dtype)  # [C_shard]
    log_p, log_1mp = clamped_log_sigmoid_pair(logits)
    pos = torch.einsum("blc,tbc->tbl", paths, (log_p - log_1mp) * valid)
    base = (log_1mp * valid).sum(dim=2)  # [T, B]
    return pos + base[:, :, None]


def make_class_sharded_binary_nll(mesh, num_classes: int, *,
                                  model_axis: str = MODEL_AXIS,
                                  batch_axis: str | None = None,
                                  implementation: str | None = None,
                                  reduction: str = "mean"):
    """NoBlankBinaryCTC with the class axis split over the mesh's shards.

    The returned function takes ``logits [T, B, C]``, ``paths [B, L, C]``
    and the ``[B]`` lengths, with C a multiple of the shard count (zero
    padding past ``num_classes`` is masked by global class index: a pad
    class would add log(1/2) to every cell).  ``reduction`` is ``'mean'``,
    ``'sum'`` or ``'none'``; with ``batch_axis`` (the data x model
    composition) the inputs are this rank's rows, and a mean or sum is
    taken over every rank's rows.
    """
    if mesh.axis != model_axis:
        raise ValueError(f"mesh {mesh.shape} has no {model_axis!r} axis")
    group = mesh.group if batch_axis else None
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")

    def nll_fn(logits, paths, input_lengths, target_lengths):
        out_device = logits.device
        logit_shards = shard_class_axis(logits, mesh)
        path_shards = shard_class_axis(paths, mesh)
        c_shard = logit_shards[0].shape[2]
        total = None
        for k, (lg, pt) in enumerate(zip(logit_shards, path_shards)):
            part = _partial_emissions(lg, pt, k * c_shard,
                                      num_classes).to(out_device)
            total = part if total is None else total + part
        em = total / num_classes
        nll = dispatch.lattice_nll(em, input_lengths, target_lengths,
                                   implementation=implementation)
        if reduction == "mean":  # equal shares: the pmean of means
            return pmean(nll.mean(), group)
        if reduction == "sum":
            return psum(nll.sum(), group)
        return nll

    return nll_fn


def make_class_sharded_binary_loss(mesh, *, model_axis: str = MODEL_AXIS,
                                   batch_axis: str | None = None):
    """The binary loss of :mod:`ctc_tpu_torch.losses` (the trainer's
    ``loss_fn`` signature) with the class axis split over the mesh's
    ``model`` shards, and with ``batch_axis`` the batch over the data
    axis's ranks too.  C is zero-padded to a multiple of the shard count;
    pad classes are masked by global index."""
    n = mesh.shape[model_axis]

    def loss_fn(logits, paths, input_lengths, target_lengths,
                implementation=None):
        c = logits.shape[2]
        nll_fn = make_class_sharded_binary_nll(
            mesh, num_classes=c, model_axis=model_axis,
            batch_axis=batch_axis, implementation=implementation,
            reduction="mean")
        pad = (-c) % n
        if pad:  # C=157 need not divide the shards; pads are masked
            logits = torch.nn.functional.pad(logits, (0, pad))
            paths = torch.nn.functional.pad(paths, (0, pad))
        return nll_fn(logits, paths, input_lengths, target_lengths)

    return loss_fn
