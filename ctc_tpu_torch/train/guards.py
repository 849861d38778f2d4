"""Training-health guards (port of ``ctc_tpu/train/guards.py``).

``ctc_tpu`` ships them as optax transforms.  Here they are plain functions
over tensors on the device that decide nothing on the host, so that they
also run inside a captured CUDA graph:

* :func:`skip_nonfinite_updates` commits an update (new parameters and
  optimizer state) only where every gradient is finite; otherwise the old
  values stay and ``skipped`` counts the dropped update.
* :func:`log_grad_norms` gives the global gradient norm and whether this
  update is one of every ``every``; the host prints the
  ``step {c}: global grad norm {n}`` line (:func:`grad_norm_line`) when it
  reads the step's metrics, as ``jax.debug.print`` does in ``ctc_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch


def all_finite(tensors) -> torch.Tensor:
    """0-d bool tensor: every element of every tensor is finite."""
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def skip_nonfinite_updates(grads, current, candidates, skipped, *,
                           when=None) -> torch.Tensor:
    """Write ``candidates`` into ``current`` (in place) only if every tensor
    of ``grads`` is finite, and add 1 to ``skipped`` (a 0-d count) when one
    is not.

    ``when`` (a 0-d bool tensor) gates both: an update that is not due
    (gradient accumulation's mini-steps) commits nothing and counts no
    skip.  Returns the 0-d bool ``finite``."""
    finite = all_finite(grads)
    commit = finite if when is None else finite & when
    for cur, new in zip(current, candidates):
        cur.copy_(torch.where(commit, new, cur))
    dropped = ~finite if when is None else when & ~finite
    skipped.add_(dropped.to(skipped.dtype))
    return finite


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def log_grad_norms(grads, count, every: int):
    """``(norm, due)``: the global norm of ``grads`` and whether the update
    count before this update, ``count``, is a multiple of ``every``."""
    return global_norm(grads), count % every == 0


def grad_norm_line(count, norm) -> str:
    """The line ``ctc_tpu``'s ``log_grad_norms`` prints: its int32 count and
    float32 norm formatted as numpy formats them."""
    return "step {c}: global grad norm {n}".format(c=np.int32(count),
                                                    n=np.float32(norm))
