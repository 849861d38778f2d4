"""Classification losses (port of ``ctc_tpu/losses/classification.py``).

* :func:`multilabel_cross_entropy`: the reference's hand-written
  multi-label CE, including its second log-sum-exp over the already
  softmaxed probabilities.
* :func:`cross_entropy`: torch.nn.CrossEntropyLoss over int targets.
* :func:`bce_with_logits`: torch.nn.BCEWithLogitsLoss.
"""

from __future__ import annotations

import torch


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def multilabel_cross_entropy(logits, targets, *, reduction: str = "mean"):
    """``loss[b] = log(sum_n exp(softmax(logits)[b, n]))
    - sum_{n: targets[b, n] == 1} softmax(logits)[b, n]`` over ``[B, N]``."""
    probs = torch.softmax(logits, dim=1)
    lse = torch.logsumexp(probs, dim=1)
    hits = torch.where(targets == 1, probs, 0.0).sum(dim=1)
    return _reduce(lse - hits, reduction)


def cross_entropy(logits, targets, *, reduction: str = "mean"):
    """Single-label softmax cross-entropy over int class targets ``[B]``."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, targets.long()[:, None])[:, 0]
    return _reduce(loss, reduction)


def bce_with_logits(logits, targets, *, reduction: str = "mean"):
    """Stable sigmoid binary cross-entropy (multi-hot targets):
    ``max(x, 0) - x t + log(1 + exp(-|x|))``."""
    loss = (
        torch.clamp(logits, min=0.0)
        - logits * targets
        + torch.log1p(torch.exp(-logits.abs()))
    )
    return _reduce(loss, reduction)
