"""Blank-free CTC losses (port of ``ctc_tpu/losses/noblank.py``).

A stay/advance-only lattice over (time, label-path position), per-sample
loss ``-alpha[T_b-1, L_b-1]``, batch mean.  Emissions are log-softmax
gathers (single-label) or negative mean binary cross-entropies
(multi-label); the DP runs through :func:`ctc_tpu_torch.ops.dispatch.lattice_nll`.
"""

from __future__ import annotations

from ctc_tpu_torch.ops import dispatch
from ctc_tpu_torch.ops.emissions import (
    binary_ce_emissions,
    gather_log_softmax_emissions,
)


def _reduce(per_sample, reduction: str):
    if reduction == "mean":
        return per_sample.mean()
    if reduction == "sum":
        return per_sample.sum()
    if reduction == "none":
        return per_sample
    raise ValueError(f"unknown reduction {reduction!r}")


def no_blank_ctc_loss(logits, paths, input_lengths, target_lengths, *,
                      reduction: str = "mean",
                      implementation: str | None = None):
    """Blank-free CTC NLL over single-label class-index paths.

    Args:
      logits: ``[T, B, C]`` unnormalized class scores.
      paths: ``[B, L]`` int label paths (may be ``-1``-padded).
      input_lengths / target_lengths: ``[B]`` valid lengths.
      reduction: ``'mean'``, ``'sum'`` or ``'none'``.
      implementation: ``'torch'``, ``'cuda'`` or None (by device).
    """
    layout = dispatch.preferred_layout(implementation)
    emissions = gather_log_softmax_emissions(logits, paths, layout=layout)
    nll = dispatch.lattice_nll(
        emissions, input_lengths, target_lengths,
        implementation=implementation, layout=layout,
    )
    return _reduce(nll, reduction)


def no_blank_binary_ctc_loss(logits, paths, input_lengths, target_lengths, *,
                             reduction: str = "mean",
                             implementation: str | None = None):
    """Multi-label blank-free CTC NLL with BCE emissions.

    Args:
      logits: ``[T, B, C]`` unnormalized per-class scores.
      paths: ``[B, L, C]`` float multi-hot label paths.
      input_lengths / target_lengths: ``[B]`` valid lengths.
    """
    layout = dispatch.preferred_layout(implementation)
    emissions = binary_ce_emissions(logits, paths, layout=layout)
    nll = dispatch.lattice_nll(
        emissions, input_lengths, target_lengths,
        implementation=implementation, layout=layout,
    )
    return _reduce(nll, reduction)
