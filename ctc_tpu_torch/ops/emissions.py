"""Emission scores for the blank-free lattices (port of
``ctc_tpu/ops/emissions.py``).

An emission is the per-cell log-score ``em[t, b, l]`` added at each step of
the lattice DP.  The two blank-free modes differ only here:

* ``NoBlankCTC``: ``em[t,b,l] = log_softmax(logits)[t, b, path[b, l]]``;
* ``NoBlankBinaryCTC``: the negative mean binary cross-entropy between
  ``sigmoid(logits)[t, b, :]`` and the multi-hot path row ``path[b, l, :]``.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops.logspace import clamped_log_sigmoid_pair


def gather_log_softmax_emissions(logits, paths, *, layout="tbl"):
    """``log_softmax(logits)[t, b, paths[b, l]]``.

    Args:
      logits: ``[T, B, C]`` unnormalized class scores.
      paths: ``[B, L]`` int class-index paths; ``-1`` padding wraps modulo
        ``C`` (Python negative indexing); padded cells are masked out of the
        DP, so their value never matters.
      layout: ``'tbl'`` -> ``[T, B, L]``; ``'tlb'`` -> ``[T, L, B]``.

    The gather reads the raw logits and subtracts the row logsumexp once,
    so the ``[T, B, C]`` log-probs are never materialized.
    """
    max_t, _, num_classes = logits.shape
    lse = torch.logsumexp(logits, dim=2)  # [T, B]
    idx = torch.remainder(paths.long(), num_classes)  # [B, L]
    raw = torch.gather(
        logits, 2, idx[None].expand(max_t, -1, -1)
    )  # [T, B, L]
    em = raw - lse[:, :, None]
    return em.transpose(1, 2) if layout == "tlb" else em


def binary_ce_emissions(logits, paths, *, layout="tbl"):
    """Multi-label (binary cross-entropy) emissions.

    ``em[t,b,l] = (1/C) sum_c [path[b,l,c] log p[t,b,c]
                              + (1 - path[b,l,c]) log(1 - p[t,b,c])]``
    with ``p = sigmoid(logits)`` and each log term clamped at -100
    (torch.nn.BCELoss), computed as one contraction:
    ``(einsum(path, log_p - log_1mp) + sum_c log_1mp) / C``.

    Args:
      logits: ``[T, B, C]``; paths: ``[B, L, C]`` float multi-hot.
    """
    num_classes = logits.shape[-1]
    log_p, log_1mp = clamped_log_sigmoid_pair(logits)
    diff = log_p - log_1mp
    base = log_1mp.sum(dim=2)  # [T, B]
    if layout == "tlb":
        pos = torch.einsum("blc,tbc->tlb", paths, diff)
        return (pos + base[:, None, :]) / num_classes
    pos = torch.einsum("blc,tbc->tbl", paths, diff)
    return (pos + base[:, :, None]) / num_classes
