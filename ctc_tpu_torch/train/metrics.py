"""Metrics (port of ``ctc_tpu/train/metrics.py``): the reference's top-k and
DTW-style transition accuracy family.

Function map (the reference's ``train.py``):

* :func:`topk_accuracy`            == ``accuracy_s``
* :func:`multilabel_topk_accuracy` == ``accuracy``
* :func:`transition_recall`        == ``recall_time``
* :func:`transition_accuracy`      == ``accuracy_time``
* :func:`sequence_accuracy`        == ``accuracy_s_time``
* :func:`future_accuracy`          == ``accuracy_future``

Reference quirks kept for parity: percentages are ``100 * (#hits summed
over the first k prediction rows) / denominator``, so top-5 values may
exceed 100; ``future_accuracy`` divides by ``count[:k+1].sum()`` where
``k`` is the top-k *value*.

Top-k indices come from a stable descending sort, so tied scores rank the
lower class first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
order among ties).  The transition metrics take a leading batch axis: the
DTW matcher walks the T prediction columns once for the whole batch.
"""

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


def _topk_indices(output, maxk: int):
    """``[..., C] -> [..., maxk]`` indices of the top-k scores, ties to the
    lower index.

    Scores are ranked in ``jax.lax.top_k``'s total order of floats, where
    -0.0 ranks below +0.0: the f32 bits as an int32, the magnitude bits
    flipped for negative values."""
    bits = output.to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return order[..., :maxk]


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
    pred = _topk_indices(output, maxk)  # [B, maxk]
    correct = (pred == target.long()[:, None]).to(torch.float32)
    res = tuple(correct[:, :k].sum() * (100.0 / batch) for k in topk)
    return res, correct[:, 0]


def multilabel_topk_accuracy(output, target, topk=(1, 5)):
    """Multi-label precision@k: a prediction row hit counts if ``target >
    0.5`` at the predicted class.

    Args:
      output: ``[B, C]`` scores;  target: ``[B, C]`` multi-hot.
    """
    maxk = max(topk)
    batch = target.shape[0]
    pred = _topk_indices(output, maxk)  # [B, maxk]
    correct = (torch.gather(target, 1, pred) > 0.5).to(torch.float32)
    res = tuple(correct[:, :k].sum() * (100.0 / batch) for k in topk)
    return res, correct[:, 0]


def _transition_scan(pred, target, valid_len, collect_per_t: bool,
                     j_limit=None):
    """The DTW-style matcher over ``[B, K, T]`` predicted class rows.

    Walks each row's predictions left to right; at column j it finds the
    first path position ``t >= current_id`` (within ``valid_len``) whose
    multi-hot row holds the predicted class, marks a hit and moves
    ``current_id`` to ``t``.  ``current_id [B, K]`` is carried through a
    loop over the T columns, each a few ops over ``[B, K, L]``.
    ``j_limit [B]`` restricts which columns take part (the reference's
    ``recall_time`` walks only the first ``valid_len`` columns).

    Returns ``[B, K, T]`` hits, or with ``collect_per_t`` the ``[B, K, L]``
    path positions ever matched.
    """
    b, k, t = pred.shape
    path_len = target.shape[1]
    positions = torch.arange(path_len, device=pred.device)
    # present[b, k, j, l]: path row l of sample b holds prediction (k, j)
    rows = (target > 0.5).transpose(1, 2)  # [B, C, L]
    present = torch.gather(
        rows, 1, pred.reshape(b, k * t, 1).expand(b, k * t, path_len)
    ).reshape(b, k, t, path_len)
    present = present & (positions < valid_len[:, None])[:, None, None, :]
    if j_limit is not None:
        cols = torch.arange(t, device=pred.device) < j_limit[:, None]
        present = present & cols[:, None, :, None]
    current = torch.zeros((b, k), dtype=torch.long, device=pred.device)
    hits, t_hits = [], []
    for j in range(t):
        ok = present[:, :, j, :] & (positions >= current[..., None])
        any_hit = ok.any(dim=-1)
        # argmax of a 0/1 integer row: the first maximum, i.e. the first
        # True (argmax of a bool row is not defined the same way)
        t_hit = ok.to(torch.int32).argmax(dim=-1)
        current = torch.where(any_hit, t_hit, current)
        hits.append(any_hit)
        t_hits.append(t_hit)
    hits = torch.stack(hits, dim=-1)  # [B, K, T]
    if not collect_per_t:
        return hits.to(torch.float32)
    # a miss scatters into a spare column L, sliced off below
    idx = torch.where(hits, torch.stack(t_hits, dim=-1), path_len)
    per_t = torch.zeros((b, k, path_len + 1), dtype=torch.float32,
                        device=pred.device)
    per_t.scatter_add_(2, idx, torch.ones(idx.shape, device=pred.device))
    return torch.clamp(per_t[..., :path_len], max=1.0)


def _batched(output, target, valid_len):
    """Add a batch axis to one sample's operands; ``(output, target,
    valid_len, squeeze)``."""
    valid_len = torch.as_tensor(valid_len, device=output.device)
    if output.dim() == 2:
        return output[None], target[None], valid_len.reshape(1), True
    return output, target, valid_len, False


def transition_accuracy(output, target, valid_len, topk=(1, 5)):
    """Reference ``accuracy_time``: per-timestep DTW-matched accuracy.

    Args:
      output: ``[T, C]`` per-timestep scores of one sample, or ``[B, T,
        C]``.
      target: ``[Lmax, C]`` multi-hot label path (``[B, Lmax, C]``).
      valid_len: true path length, a scalar (``[B]``).

    Returns (percentages tuple, ``[T]`` top-1 hit vector), each with the
    leading batch axis of the inputs.
    """
    output, target, valid_len, squeeze = _batched(output, target, valid_len)
    maxk = max(topk)
    temporal = output.shape[1]
    pred = _topk_indices(output, maxk).transpose(1, 2)  # [B, maxk, T]
    hits = _transition_scan(pred, target, valid_len, False)  # [B, maxk, T]
    res = tuple(hits[:, :k].sum(dim=(1, 2)) * (100.0 / temporal)
                for k in topk)
    top1 = hits[:, 0]
    if squeeze:
        return tuple(r[0] for r in res), top1[0]
    return res, top1


def transition_recall(output, target, valid_len, topk=(1, 5)):
    """Reference ``recall_time``: share of label path positions matched.
    Shapes as :func:`transition_accuracy`; returns the ``[Lmax]`` top-1
    matched positions beside the percentages."""
    output, target, valid_len, squeeze = _batched(output, target, valid_len)
    maxk = max(topk)
    pred = _topk_indices(output, maxk).transpose(1, 2)  # [B, maxk, T]
    per_t = _transition_scan(pred, target, valid_len, True,
                             j_limit=valid_len)  # [B, maxk, Lmax]
    denom = torch.clamp(valid_len, min=1).to(torch.float32)
    res = tuple(per_t[:, :k].sum(dim=(1, 2)) * 100.0 / denom for k in topk)
    top1 = per_t[:, 0]
    if squeeze:
        return tuple(r[0] for r in res), top1[0]
    return res, top1


def sequence_accuracy(output, target, topk=(1, 5)):
    """Reference ``accuracy_s_time``: one future label against every
    timestep.

    Args: output ``[T, C]``; target a scalar int class.
    """
    maxk = max(topk)
    temporal = output.shape[0]
    pred = _topk_indices(output, maxk)  # [T, maxk]
    correct = (pred == torch.as_tensor(target).long()).to(torch.float32)
    res = tuple(correct[:, :k].sum() * (100.0 / temporal) for k in topk)
    return res, correct[:, 0]


def future_accuracy(output, target, topk=(1, 5)):
    """Reference ``accuracy_future``: a multi-hot future target against all
    timesteps, over the number of hit rows (min 1), with the reference's
    ``count[:k+1]`` slice.

    Args: output ``[T, C]``; target ``[C]`` multi-hot.
    """
    maxk = max(topk)
    pred = _topk_indices(output, maxk).T  # [maxk, T]
    correct = (target[pred] > 0.5).to(torch.float32)  # [maxk, T]
    count = torch.clamp(correct.sum(dim=1), min=1.0)  # [maxk]
    res = tuple(correct[:k].sum() * 100.0 / count[: k + 1].sum()
                for k in topk)
    return res, correct[0]
