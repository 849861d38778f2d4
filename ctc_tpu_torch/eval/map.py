"""Charades mean average precision (copy of ``ctc_tpu/eval/map.py``, which
is numpy only; the port keeps its own copy because importing ``ctc_tpu``
pulls in JAX).

Vectorized form of the reference's ``utils/map.py``, with its definitions:
per-class AP = mean over positives of precision at each true positive,
classes with no positives are NaN and excluded from the mean;
``charades_map`` first masks rows with empty ground truth to -inf.
"""

from __future__ import annotations

import numpy as np


def mean_average_precision(scores: np.ndarray, gt: np.ndarray):
    """Returns ``(mAP, weighted_ap, per_class_ap)``.

    Args:
      scores: ``[N, C]`` prediction scores.
      gt: ``[N, C]`` binary ground truth.
    """
    scores = np.asarray(scores)
    gt = np.asarray(gt)
    n, c = scores.shape
    order = np.argsort(-scores, axis=0)  # [N, C] row indices per class
    tp = np.take_along_axis(gt, order, axis=0) == 1  # [N, C]
    n_pos = tp.sum(axis=0)  # [C]
    cum_tp = np.cumsum(tp, axis=0)
    ranks = np.arange(1, n + 1)[:, None]
    prec = cum_tp / ranks
    ap = np.where(
        n_pos > 0, (prec * tp).sum(axis=0) / np.maximum(n_pos, 1), np.nan
    )
    m_ap = np.nanmean(ap)
    w_ap = ap * gt.sum(axis=0) / max(float(gt.sum()), 1e-12)
    return m_ap, w_ap, ap


def charades_map(scores: np.ndarray, gt: np.ndarray):
    """mAP with rows lacking any ground-truth label masked to -inf first."""
    fixed = np.asarray(scores, dtype=np.float64).copy()
    empty = np.sum(gt, axis=1) == 0
    fixed[empty, :] = -np.inf
    return mean_average_precision(fixed, gt)
