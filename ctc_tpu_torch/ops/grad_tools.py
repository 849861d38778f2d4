"""Gradient-manipulation ops (port of ``ctc_tpu/ops/grad_tools.py``).

* :func:`balance_labels`      scales each element's gradient so positive and
  negative examples weigh equally per class (the reference's BalanceLabels /
  ScaleGrad);
* :func:`verbose_gradients`   prints each cotangent's norm;
* :func:`equalize_grad_norm`  rescales every gradient to the first one's norm;
* :func:`block_gradient`      stops the gradient (``Tensor.detach``).

Each is a ``torch.autograd.Function`` that is the identity in the forward
pass (a view of its input) and acts on the cotangents in the backward pass.
The running pos / neg counts of BalanceLabels live in an explicit
:class:`BalanceState` that the caller keeps, as in ``ctc_tpu``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


# ---------------------------------------------------------------- balance


class BalanceState(NamedTuple):
    """Running per-class positive / negative counts, ``[C]`` float32."""

    pos: torch.Tensor
    neg: torch.Tensor

    @classmethod
    def create(cls, num_classes: int, *, device="cuda") -> "BalanceState":
        """Zero counts on ``device`` (the card unless the caller asks for
        the CPU)."""
        return cls(torch.zeros(num_classes, device=device),
                   torch.zeros(num_classes, device=device))


def update_balance(state: BalanceState,
                   targets: torch.Tensor) -> BalanceState:
    """Accumulate multi-hot ``[B, C]`` targets into the running counts."""
    pos = state.pos + (targets > 0.5).sum(dim=0).to(state.pos.dtype)
    neg = state.neg + (targets <= 0.5).sum(dim=0).to(state.neg.dtype)
    return BalanceState(pos, neg)


class _BalanceLabels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, targets, pos, neg):
        ctx.save_for_backward(targets, pos, neg)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        targets, pos, neg = ctx.saved_tensors
        total = pos + neg
        w_pos = total / torch.clamp(2.0 * pos, min=1.0)
        w_neg = total / torch.clamp(2.0 * neg, min=1.0)
        weights = torch.where(targets > 0.5, w_pos[None, :], w_neg[None, :])
        return g * weights, None, None, None


def balance_labels(x: torch.Tensor, targets: torch.Tensor,
                   state: BalanceState) -> torch.Tensor:
    """Identity forward; the backward multiplies the gradient of each
    element of ``x [B, C]`` by ``total / (2 pos)`` where its target is
    positive and ``total / (2 neg)`` where it is not (each denominator at
    least 1), with the counts of ``state``.  No gradient reaches
    ``targets`` or the state."""
    return _BalanceLabels.apply(x, targets, state.pos, state.neg)


# ---------------------------------------------------------------- verbose


class _VerboseGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        for i, gi in enumerate(gs):
            norm = torch.linalg.vector_norm(gi.reshape(-1))
            print(f"verbose_gradients: input {i} grad norm {norm.item()}",
                  flush=True)
        return gs


def verbose_gradients(*xs):
    """Identity forward (the tuple, or the tensor itself for one input);
    the backward prints ``verbose_gradients: input {i} grad norm {n}`` for
    each cotangent and passes the cotangents on unchanged.

    Printing reads each norm on the host, which synchronizes with the card:
    the op cannot sit inside a captured CUDA graph (a ``--steps-per-dispatch``
    group), only in eager steps."""
    out = _VerboseGradients.apply(*xs)
    return out if len(xs) > 1 else out[0]


# ---------------------------------------------------------------- equalize


class _EqualizeGradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ref_norm = torch.linalg.vector_norm(gs[0].reshape(-1))
        out = []
        for gi in gs:
            n = torch.linalg.vector_norm(gi.reshape(-1))
            out.append(torch.where(
                n > 0, gi * (ref_norm / torch.clamp(n, min=1e-12)), gi))
        return tuple(out)


def equalize_grad_norm(*xs) -> tuple:
    """Identity forward, always a tuple (one input included); the backward
    rescales every input's gradient to the norm of the FIRST input's
    gradient, leaving a zero gradient as it is."""
    return tuple(_EqualizeGradNorm.apply(*xs))


# ---------------------------------------------------------------- block

block_gradient = torch.Tensor.detach
