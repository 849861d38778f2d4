"""Metrics (port of ``ctc_tpu/train/metrics.py``: ``AverageMeter`` and
``topk_accuracy``).  Percentages are ``100 * hits / batch``."""

from __future__ import annotations

import torch


class AverageMeter:
    """Running value/average meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def topk_accuracy(output, target, topk=(1, 5)):
    """Single-label top-k accuracy over a batch.

    Args:
      output: ``[B, C]`` scores.
      target: ``[B]`` int class ids.

    Returns:
      (percentages tuple, ``[B]`` float top-1 correctness vector).
    """
    maxk = max(topk)
    batch = target.shape[0]
    pred = torch.topk(output, maxk, dim=-1).indices  # [B, maxk]
    correct = (pred == target.long()[:, None]).to(torch.float32)
    res = tuple(correct[:, :k].sum() * (100.0 / batch) for k in topk)
    return res, correct[:, 0]
