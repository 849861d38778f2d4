"""Sequence-sharded lattice: the time axis split into the shards of a seq
mesh (port of ``ctc_tpu/parallel/seq_lattice.py``).

The lattice DP is sequential in T, so a T-sharded lattice is a
carry-passing pipeline: shard k runs its T/n steps from the boundary alpha
row that shard k-1 hands it, and passes its own last row on.  JAX writes
this as ``shard_map`` with a ``ppermute`` per tick and a ``psum`` of the
per-shard finals.  Here one process drives every shard (JAX's single
controller, no process group): the hand-over is ``boundary.to(device of
shard k+1)``, the psum is a sum of the per-shard finals on the loss's
device, and autograd supplies the reverse exchange.  An interior shard's op
takes the incoming boundary as both of its init rows, so autograd sums the
two cotangents into the boundary's gradient, which is the ``g_seed`` of the
shard before it.

Per-sample NLL: sample b's final cell lies on shard
``floor((input_length[b] - 1) / t_s)``; each shard computes its candidate
with shard-local lengths, non-owners give 0, and the sum combines them.

The batch is split into ``num_microbatches`` (default n) microbatches, each
an independent pipeline.  In JAX they flow wavefront-style so that shards
work at once after an (n-1)-tick fill; one process runs the shards in turn,
so the loop here is over microbatches and then over shards, and there is no
fill or drain bubble to amortize.  The count still sets the batch of each
kernel launch.

With ``batch_axis`` (the data x seq composition) each rank of the mesh's
data axis runs its own pipeline over its rows on its row of devices, and
the loss's mean is pmean'd over the ranks; nothing else crosses ranks.

Also here: :func:`make_seq_sharded_greedy_decode`, greedy decode on
frame-sharded logits, with the previous shard's last frame label as the
boundary so that a repeat across a shard boundary collapses.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.decode.greedy import compact
from ctc_tpu_torch.losses.blank import (
    blank_alpha_init,
    blank_emissions_and_skip,
)
from ctc_tpu_torch.ops import dispatch
from ctc_tpu_torch.ops.emissions import (
    binary_ce_emissions,
    gather_log_softmax_emissions,
)
from ctc_tpu_torch.ops.lattice_cuda import noblank_alpha_init
from ctc_tpu_torch.ops.logspace import BLANK_NEG, NEG_SENTINEL
from ctc_tpu_torch.parallel.collectives import pmean

MODES = ("noblank", "noblank_logits", "binary", "blank")


def shard_time_axis(x, mesh):
    """Split ``[T, ...]`` into the mesh's n equal T-slices, slice k on
    shard k's device."""
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"T = {x.shape[0]} is not divisible by the {n} "
                         "seq shards")
    t_shard = x.shape[0] // n
    return [x[k * t_shard:(k + 1) * t_shard].to(dev)
            for k, dev in enumerate(mesh.devices)]


def _run_pipeline(em_shards, run_shard, init_rows, num_microbatches,
                  out_device):
    """The carry-passing pipeline over every microbatch.

    ``em_shards`` are the per-shard emissions ``[t_s, B, W]``;
    ``run_shard(k, mb, em_mb, rows) -> (final_mb, boundary_out)`` runs
    microbatch ``mb`` (a batch slice) of shard k from its two init rows;
    ``init_rows(size, device)`` gives shard 0's.  Returns the per-sample
    final log-probs ``[B]`` on ``out_device``.
    """
    batch = em_shards[0].shape[1]
    m_count = num_microbatches or len(em_shards)
    if batch % m_count:
        raise ValueError(f"batch {batch} is not divisible by "
                         f"num_microbatches {m_count}")
    size = batch // m_count
    finals = []
    for i in range(m_count):
        mb = slice(i * size, (i + 1) * size)
        total = None
        for k, em in enumerate(em_shards):
            if k == 0:
                rows = init_rows(size, em.device)
            else:
                incoming = boundary.to(em.device)
                rows = (incoming, incoming)
            final_mb, boundary = run_shard(k, mb, em[:, mb], rows)
            # each sample's final is nonzero on exactly one shard
            final_mb = final_mb.to(out_device)
            total = final_mb if total is None else total + final_mb
        finals.append(total)
    return torch.cat(finals)


def make_seq_sharded_lattice_nll(mesh, *, mode: str = "noblank",
                                 blank: int = 0,
                                 num_microbatches: int | None = None,
                                 batch_axis: str | None = None,
                                 implementation: str | None = None):
    """Build a sequence-sharded per-sample NLL ``[B]``.

    Modes and the returned function's arguments (the leading axis T is
    split over the mesh's shards; the batch must be divisible by
    ``num_microbatches``, default the shard count):

    * ``'noblank'``: ``(emissions [T, B, L], input_lengths, target_lengths)``
    * ``'noblank_logits'``: ``(logits [T, B, C], paths [B, L] int,
      input_lengths, target_lengths)``: NoBlankCTC, with the log-softmax
      emission gather computed per shard from its slice of the logits.
    * ``'binary'``: ``(logits [T, B, C], paths [B, L, C], input_lengths,
      target_lengths)``: NoBlankBinaryCTC, BCE emissions per shard.
    * ``'blank'``: ``(logits [T, B, C], targets [B, L], input_lengths,
      target_lengths)``: blank CTC; each shard gathers its raw logits and
      subtracts their row logsumexp before the DP.

    Each shard's microbatches run the shard ops of
    :mod:`ctc_tpu_torch.ops.dispatch`, chosen by ``implementation`` as the
    unsharded losses choose theirs: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors.  With ``batch_axis`` (the data x seq
    composition) the inputs are this rank's rows of the batch and so is the
    NLL; each rank runs its own pipeline.
    """
    if batch_axis is not None and mesh.data is None:
        raise ValueError(f"batch_axis={batch_axis!r} needs a mesh with a "
                         f"data axis, got {mesh.shape}")
    if mode not in MODES:
        raise ValueError(f"unknown seq-sharded lattice mode {mode!r}")

    def noblank_nll(em_shards, input_lengths, target_lengths, out_device):
        t_shard, _, width = em_shards[0].shape

        def init_rows(size, device):
            # shard 0: the alpha(-1) init and a sentinel advance source
            stay0 = noblank_alpha_init(size, width, device=device)
            return stay0, torch.full_like(stay0, NEG_SENTINEL)

        def run_shard(k, mb, em_mb, rows):
            dev = em_mb.device
            return dispatch.shard_lattice(
                em_mb, *rows, (input_lengths[mb] - k * t_shard).to(dev),
                target_lengths[mb].to(dev), implementation=implementation)

        return -_run_pipeline(em_shards, run_shard, init_rows,
                              num_microbatches, out_device)

    def blank_nll(logit_shards, targets, input_lengths, target_lengths,
                  out_device):
        em_skip = [blank_emissions_and_skip(lg, targets.to(lg.device), blank,
                                            normalize=True)
                   for lg in logit_shards]
        t_shard, _, width = em_skip[0][0].shape

        def init_rows(size, device):
            # shard 0: the virtual alpha(-1) row and a sentinel skip source
            init0 = blank_alpha_init(size, width, device=device)
            return init0, torch.full_like(init0, BLANK_NEG)

        def run_shard(k, mb, em_mb, rows):
            dev = em_mb.device
            return dispatch.blank_shard_lattice(
                em_mb, *rows, em_skip[k][1][mb],
                (input_lengths[mb] - k * t_shard).to(dev),
                target_lengths[mb].to(dev), implementation=implementation)

        return -_run_pipeline([em for em, _ in em_skip], run_shard,
                              init_rows, num_microbatches, out_device)

    def nll(x, *args):
        shards = shard_time_axis(x, mesh)
        if mode == "noblank":
            return noblank_nll(shards, *args, x.device)
        paths, input_lengths, target_lengths = args
        if mode == "blank":
            return blank_nll(shards, paths, input_lengths, target_lengths,
                             x.device)
        build = (gather_log_softmax_emissions if mode == "noblank_logits"
                 else binary_ce_emissions)
        em_shards = [build(lg, paths.to(lg.device)) for lg in shards]
        return noblank_nll(em_shards, input_lengths, target_lengths,
                           x.device)

    return nll


def make_seq_sharded_loss(mesh, loss_kind: str, *,
                          num_microbatches: int | None = None,
                          blank: int = 0, batch_axis: str | None = None):
    """A drop-in replacement for the :mod:`ctc_tpu_torch.losses` entry
    points with the lattice's T axis pipelined over the mesh's shards (the
    trainer's ``--seq-parallel``).

    Same call signature and reductions as the unsharded losses: noblank and
    binary take the batch mean of the NLL; blank takes the mean of the
    per-sample NLL over ``max(target_length, 1)``.  With ``batch_axis``
    each rank passes its rows, and the mean over the ranks' equal shares
    is pmean'd.
    """
    modes = {"noblank": "noblank_logits", "binary": "binary",
             "blank": "blank"}
    if loss_kind not in modes:
        raise ValueError(f"seq_parallel needs a lattice loss, got "
                         f"{loss_kind!r}")
    group = mesh.group if batch_axis else None

    def loss_fn(logits, paths, input_lengths, target_lengths,
                implementation=None):
        nll = make_seq_sharded_lattice_nll(
            mesh, mode=modes[loss_kind], blank=blank,
            num_microbatches=num_microbatches, batch_axis=batch_axis,
            implementation=implementation,
        )(logits, paths, input_lengths, target_lengths)
        if loss_kind == "blank":
            nll = nll / target_lengths.clamp(min=1).to(nll.dtype)
        return pmean(nll.mean(), group)

    return loss_fn


def make_seq_sharded_greedy_decode(mesh, *, blank: int = 0):
    """Greedy decode of T-sharded logits ``[T, B, C]``.

    Each shard takes its frames' argmax and marks what it keeps, with the
    previous shard's last frame label as the label before its first frame;
    the keep-masks are reassembled and compacted.  Returns ``(decoded [B,
    T] -1-padded, lengths [B])``.
    """

    def decode(logits, input_lengths):
        shards = shard_time_axis(logits, mesh)
        t_shard = shards[0].shape[0]
        frames, keeps = [], []
        for k, lg in enumerate(shards):
            frame = lg.argmax(dim=2).T.to(torch.int32)  # [B, t_s]
            if k == 0:
                boundary = torch.full_like(frame[:, 0], -1)
            else:
                boundary = frames[-1][:, -1].to(lg.device)
            prev = torch.cat([boundary[:, None], frame[:, :-1]], dim=1)
            t_global = k * t_shard + torch.arange(t_shard, device=lg.device)
            keep = ((t_global[None, :]
                     < input_lengths.to(lg.device)[:, None])
                    & (frame != blank) & (frame != prev))
            frames.append(frame.to(logits.device))
            keeps.append(keep.to(logits.device))
        return compact(torch.cat(frames, dim=1), torch.cat(keeps, dim=1))

    return decode
