"""Standard blank-CTC loss (port of ``ctc_tpu/losses/blank.py``; the
``torch.nn.CTCLoss`` capability).

Graves CTC over the blank-expanded label sequence
``z = [blank, l1, blank, l2, ..., lL, blank]`` (``S = 2L+1`` slots) with
stay, advance and skip transitions, where a skip may enter a label slot
whose label is not the blank and differs from the one two slots back.  The
DP runs through :func:`ctc_tpu_torch.ops.dispatch.blank_lattice_nll`: the
CUDA kernels on a CUDA tensor, the plain version on a CPU tensor.

As the JAX package's kernel path does, the lattice takes the RAW gathered
logits ``em[t, b, s] = logits[t, b, z[b, s]]`` and the log-softmax
normalization is added afterwards as one per-sample term: every lattice
path takes exactly one emission per frame, so
``nll = nll_raw + sum_{t < T_b} logsumexp_c logits[t, b, c]`` exactly, and
the ``[T, B, C]`` log-probs are never materialized.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops import dispatch
# the virtual alpha(-1) row, defined beside the lattice it seeds
from ctc_tpu_torch.ops.blank_lattice_cuda import blank_alpha_init  # noqa: F401


def _expand_targets(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """``[B, L] -> [B, 2L+1]`` blank-interleaved label sequence."""
    batch, max_l = targets.shape
    z = torch.full((batch, 2 * max_l + 1), blank, dtype=targets.dtype,
                   device=targets.device)
    z[:, 1::2] = targets
    return z


class _GatherSlots(torch.autograd.Function):
    """``scores[t, b, z[b, s]]``, whose backward sums each class's slots as
    a one-hot product, in a fixed order.  (``torch.gather``'s own backward
    adds the repeated indices, the blank's above all, by atomics on the
    card, in no fixed order, so two runs of a step would differ.)"""

    @staticmethod
    def forward(ctx, scores, z):
        ctx.save_for_backward(z)
        ctx.classes = scores.shape[2]
        return torch.gather(scores, 2, z[None].expand(scores.shape[0], -1,
                                                      -1))

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(z, ctx.classes).to(grad.dtype)
        return torch.einsum("tbs,bsc->tbc", grad, onehot), None


def blank_emissions_and_skip(scores, targets, blank, *, normalize=False):
    """Gathered emissions ``[T, B, S]`` over the blank-expanded sequence and
    the ``[B, S]`` skip-permission mask.

    Args:
      scores: ``[T, B, C]`` log-probabilities, or RAW logits with
        ``normalize=True`` (the row logsumexp is then subtracted after the
        gather, so the log-probs are never materialized).
      targets: ``[B, L]`` int labels, taken modulo ``C`` (``-1`` padding
        wraps; padded slots never feed the cells the loss reads).
      blank: the blank class id.

    A skip may enter slot ``s`` when ``s >= 2``, ``z[s] != blank`` and
    ``z[s] != z[s-2]``: a label equal to the blank id is never skipped into.
    """
    _, batch, num_classes = scores.shape
    z = _expand_targets(torch.remainder(targets.long(), num_classes), blank)
    z_prev2 = torch.cat(
        [torch.full((batch, 2), blank, dtype=z.dtype, device=z.device),
         z[:, :-2]], dim=1)
    s_idx = torch.arange(z.shape[1], device=z.device)[None, :]
    skip_ok = (s_idx >= 2) & (z != blank) & (z != z_prev2)
    em = _GatherSlots.apply(scores, z)  # [T, B, S]
    if normalize:
        em = em - torch.logsumexp(scores, dim=2)[:, :, None]
    return em, skip_ok


def min_frames(targets, target_lengths, blank: int = 0) -> torch.Tensor:
    """``[B]`` fewest frames a lattice path through each target takes: one
    a label, and one more before each label that may not be skipped into
    (a repeat of the label before it, or a label equal to the blank id).
    A sample with fewer input frames is infeasible: its loss is at the
    sentinel's scale and its gradient is not defined."""
    targets = torch.as_tensor(targets).long()
    lengths = torch.as_tensor(target_lengths, device=targets.device).long()
    prev = torch.cat([targets[:, :1], targets[:, :-1]], dim=1)
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    extra = ((pos >= 1) & (pos < lengths[:, None])
             & ((targets == blank) | (targets == prev)))
    return lengths + extra.sum(dim=1)


def ctc_loss(logits, targets, input_lengths, target_lengths, *,
             blank: int = 0, reduction: str = "mean", normalize: bool = True,
             implementation: str | None = None):
    """Blank CTC NLL.

    Args:
      logits: ``[T, B, C]`` unnormalized scores (normalized inside; pass
        ``normalize=False`` to feed log-probabilities).
      targets: ``[B, L]`` int labels (padding value irrelevant).
      input_lengths / target_lengths: ``[B]`` valid lengths.  A sample whose
        input length lies outside ``[1, T]`` has loss 0.
      blank: blank class index.
      reduction: ``'mean'`` (per-sample loss over ``max(target_length,
        1)``, then the batch mean), ``'sum'`` or ``'none'``.
      implementation: ``'torch'``, ``'cuda'`` or None (by device).

    An infeasible target (too few frames for its labels and forced blanks)
    gives a sentinel-scale loss (~1e30), not ``inf``.
    """
    max_t = logits.shape[0]
    em, skip_ok = blank_emissions_and_skip(logits, targets, blank)
    nll = dispatch.blank_lattice_nll(
        em, skip_ok, input_lengths, target_lengths,
        implementation=implementation,
    )
    if normalize:
        lse = torch.logsumexp(logits, dim=2)  # [T, B]
        own = (input_lengths >= 1) & (input_lengths <= max_t)
        t_idx = torch.arange(max_t, device=logits.device)[:, None]
        frames = (t_idx < input_lengths[None, :]) & own[None, :]
        nll = nll + torch.where(frames, lse, 0.0).sum(dim=0)
    return _reduce(nll, target_lengths, reduction)


def _reduce(nll, target_lengths, reduction):
    if reduction == "mean":
        return (nll / target_lengths.clamp(min=1).to(nll.dtype)).mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll
    raise ValueError(f"unknown reduction {reduction!r}")
