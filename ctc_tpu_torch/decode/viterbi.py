"""Viterbi alignment for the blank-free lattice (port of
``ctc_tpu/decode/viterbi.py``).

The max-product counterpart of the lattice's sum-product alpha recursion:
for a given label path, the most probable monotonic stay/advance alignment
of frames to path positions.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops.logspace import NEG_SENTINEL


def viterbi_align(emissions, input_lengths, target_lengths):
    """Best stay/advance alignment.

    Args:
      emissions: ``[T, B, L]`` per-cell emission log-scores (see
        :mod:`ctc_tpu_torch.ops.emissions`).
      input_lengths / target_lengths: ``[B]`` valid lengths.

    Returns:
      ``(alignment [T, B] int32, score [B])``: ``alignment[t, b]`` is the
      label path position active at frame t (garbage past
      ``input_lengths[b]``).
    """
    max_t, batch, max_l = emissions.shape
    dev = emissions.device
    positions = torch.arange(max_l, device=dev)[None, :]
    outside = positions >= target_lengths[:, None]
    b_idx = torch.arange(batch, device=dev)
    last = (target_lengths - 1).clamp(0, max_l - 1).long()

    sentinel = torch.full((batch, max_l), NEG_SENTINEL,
                          dtype=emissions.dtype, device=dev)
    alpha = torch.where(positions == 0, 0.0, sentinel)
    score = torch.zeros(batch, dtype=emissions.dtype, device=dev)
    advs = []
    for t in range(max_t):
        shifted = torch.cat([sentinel[:, :1], alpha[:, :-1]], dim=1)
        if t == 0:
            shifted = sentinel
        take_adv = shifted > alpha  # advance beats stay
        best = torch.where(take_adv, shifted, alpha)
        best = torch.where(outside, NEG_SENTINEL, best)
        alpha = best + emissions[t]
        score = torch.where(t == input_lengths - 1, alpha[b_idx, last], score)
        advs.append(take_adv)

    # backtrack from (input_length-1, target_length-1)
    pos = torch.zeros(batch, dtype=torch.long, device=dev)
    rows = [None] * max_t
    for t in range(max_t - 1, -1, -1):
        active = t <= input_lengths - 1
        pos = torch.where(t == input_lengths - 1, last, pos)
        rows[t] = pos
        step_back = active & (t > 0) & advs[t][b_idx, pos]
        pos = torch.where(step_back, pos - 1, pos)
    return torch.stack(rows).to(torch.int32), score
