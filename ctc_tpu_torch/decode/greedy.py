"""Greedy (best-path) CTC decoding (port of ``ctc_tpu/decode/greedy.py``).

argmax per frame -> collapse repeats -> drop blanks.  Outputs are
``-1``-padded ``[B, T]`` plus lengths.
"""

from __future__ import annotations

import torch


def collapse_repeats(labels: torch.Tensor, lengths: torch.Tensor,
                     blank: int = 0):
    """Collapse consecutive repeats, then remove blanks.

    Args:
      labels: ``[B, T]`` int frame labels.
      lengths: ``[B]`` valid frame counts.
      blank: blank id (``-1`` collapses repeats only).

    Returns:
      ``(decoded [B, T] -1-padded, out_lengths [B])``.
    """
    batch, max_t = labels.shape
    t_idx = torch.arange(max_t, device=labels.device)[None, :]
    valid = t_idx < lengths[:, None]
    prev = torch.cat(
        [torch.full((batch, 1), -1, dtype=labels.dtype, device=labels.device),
         labels[:, :-1]], dim=1)
    keep = valid & (labels != blank) & (labels != prev)
    return compact(labels, keep)


def compact(labels: torch.Tensor, keep: torch.Tensor):
    """Stable compaction: each kept label of ``[B, T]`` goes to its rank
    among the kept, ``-1`` elsewhere.  Returns ``(out [B, T], counts
    [B])``."""
    pos = torch.cumsum(keep, dim=1) - 1
    out = torch.full(labels.shape, -1, dtype=labels.dtype,
                     device=labels.device)
    b_idx, t_kept = keep.nonzero(as_tuple=True)
    out[b_idx, pos[b_idx, t_kept]] = labels[b_idx, t_kept]
    return out, keep.sum(dim=1)


def greedy_decode(logits: torch.Tensor, input_lengths: torch.Tensor, *,
                  blank: int = 0):
    """Best-path decode of ``[T, B, C]`` logits.

    Returns ``(decoded [B, T] -1-padded, lengths [B], frame_labels [B, T])``.
    """
    frame = logits.argmax(dim=2).T.to(torch.int32)  # [B, T]
    decoded, lengths = collapse_repeats(frame, input_lengths, blank)
    return decoded, lengths, frame
