"""Log-space numerics for the CTC-family lattices (port of
``ctc_tpu/ops/logspace.py``).

The finite sentinel ``-1e13`` stands in for log-zero: a true ``-inf`` gives
NaN gradients wherever ``-inf - (-inf)`` appears inside a log-sum-exp.  At
float32 ``exp(NEG_SENTINEL - x)`` underflows to exactly 0 for any reachable
``x``, so the sentinel is an exact log-zero in every log-add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_SENTINEL = -1.0e13

# Log-zero for the blank CTC lattice (torch.nn.CTCLoss uses a true -inf; a
# finite sentinel keeps gradients NaN-free, and at float32
# exp(BLANK_NEG - x) underflows to exactly 0 for any reachable x).
BLANK_NEG = -1.0e30

# torch.nn.BCELoss clamps each log term at -100 (a saturated sigmoid gives a
# large-but-finite penalty with zero gradient).
BCE_LOG_CLAMP = -100.0


def clamped_log_sigmoid_pair(logits: torch.Tensor):
    """Return ``(clamp(log sigmoid(x)), clamp(log(1 - sigmoid(x))))``.

    ``log p = -softplus(-x)`` and ``log(1-p) = -softplus(x)``, each clamped
    at ``BCE_LOG_CLAMP`` (zero gradient once saturated).
    """
    log_p = -F.softplus(-logits)
    log_1mp = -F.softplus(logits)
    return (
        torch.clamp(log_p, min=BCE_LOG_CLAMP),
        torch.clamp(log_1mp, min=BCE_LOG_CLAMP),
    )
