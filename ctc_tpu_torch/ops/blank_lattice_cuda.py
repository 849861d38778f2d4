"""Blank CTC lattice DP: the two CUDA kernels and their plain version.

Port of ``ctc_tpu/ops/blank_lattice_pallas.py`` (kernels, and the op
``blank_lattice_nll_pallas``) and of the XLA scan in
``ctc_tpu/losses/blank.py`` (plain version).  The lattice runs over the
blank-expanded sequence ``z = [blank, l1, blank, ..., lL, blank]`` of
``S = 2L+1`` slots with stay, advance and skip transitions::

    alpha[t, s] = em[t, s] + logaddexp3(alpha[t-1, s], alpha[t-1, s-1],
                                        skip_ok[s] and t > 0
                                        ? alpha[t-1, s-2] : -1e30)

from ``alpha(-1)`` = 0 at ``s = 0`` and the sentinel elsewhere.  The
per-sample NLL is ``-logaddexp(alpha[T_b-1, 2L_b], alpha[T_b-1, 2L_b-1])``
(only the ``2L_b`` cell when ``L_b == 0``), 0 where the input length lies
outside ``[1, T]`` (the forward kernel writes it beside alpha; the plain
path's :func:`gather_nll`); the gradient is the analytic reverse occupancy
recursion with three-way softmax branch weights.  No validity mask is applied:
transitions only move to higher ``s``, so cells past ``2L_b`` never feed the
cells the loss reads, and their gradient is exactly 0.

* :func:`blank_lattice_nll_cuda` launches the kernels of
  ``csrc/blank_lattice.cu`` on a CUDA tensor and runs the plain version on a
  CPU tensor.  It takes nothing else and never falls back.
* :func:`blank_lattice_nll_plain` is the plain PyTorch version on any
  device: the CPU path, and the oracle the kernels are held to.

One T-shard of the sequence-parallel pipeline (port of
``blank_shard_lattice_pallas``) is the same recursion with its two
boundaries handed in: ``init0`` seeds the carry and ``skip0`` is the skip
source of the first local step.  :func:`blank_shard_lattice_cuda` and
:func:`blank_shard_lattice_plain` return ``(final [B], boundary_out [B, S])``:
the final log-prob (the log-add of the two final cells at local
``inlen - 1``, 0 unless ``1 <= inlen_local <= t_s``) and the last alpha row.
The shard forward kernel writes both beside alpha and reads a batch slice of
em in place; its plain version :func:`blank_shard_forward_plain` returns the
same triple.  The whole lattice is the shard whose init rows are
:func:`blank_alpha_init` and the sentinel row.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops.lattice_cuda import (
    _require,
    _require_rows,
    _to_tbl,
    backward_dims,
    backward_plan,
    forward_dims,
    forward_outputs,
    forward_plan,
    launch,
    rows_layout,
    shard_backward_plan,
    shard_forward_plan,
    validate_rows,
)
from ctc_tpu_torch.ops.logspace import BLANK_NEG

#: launches of each kernel, counted where the wrapper launches it
launch_counts = {"blank_lattice_forward": 0, "blank_lattice_backward": 0,
                 "blank_shard_forward": 0, "blank_shard_backward": 0}

_SOURCE = "blank_lattice.cu"


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain version ([T, B, S], any device)
# ---------------------------------------------------------------------------


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """``out[..., s] = x[..., s-k]``, the sentinel at ``s < k``."""
    pad = torch.full_like(x[..., :k], BLANK_NEG)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """``out[..., s] = x[..., s+k]``, 0 at ``s >= S-k``."""
    return torch.cat([x[..., k:], torch.zeros_like(x[..., :k])], dim=-1)


def _sources(alpha_prev, skip_prev, skip_ok):
    """The stay, advance and skip source scores of every cell: stay and
    advance from ``alpha_prev``, skip from ``skip_prev`` (the sentinel where
    it is not permitted)."""
    adv = _shift_right(alpha_prev, 1)
    skp = torch.where(skip_ok, _shift_right(skip_prev, 2), BLANK_NEG)
    return alpha_prev, adv, skp


def blank_alpha_init(batch, width, *, dtype=torch.float32, device=None):
    """The virtual ``alpha(-1)`` row ``[B, S]``: 0 at ``s = 0``, the
    sentinel elsewhere (shard 0's ``init0``)."""
    row = torch.full((batch, width), BLANK_NEG, dtype=dtype, device=device)
    row[:, 0] = 0.0
    return row


def blank_alpha_plain(em, skip_ok):
    """The full alpha lattice ``[T, B, S]`` (the backward's residual) from
    em ``[T, B, S]`` and the ``[B, S]`` skip mask."""
    _, batch, max_s = em.shape
    init0 = blank_alpha_init(batch, max_s, dtype=em.dtype, device=em.device)
    # skip is illegal at t == 0 (it would alias the s == 0 init cell): its
    # source there is the sentinel row
    return blank_shard_alpha_plain(em, skip_ok, init0,
                                   torch.full_like(init0, BLANK_NEG))


def blank_shard_alpha_plain(em, skip_ok, init0, skip0):
    """alpha ``[t_s, B, S]`` of one T-shard: ``init0 [B, S]`` is the carry
    before the first local step, ``skip0 [B, S]`` that step's skip source
    (the carry is the skip source of every later step)."""
    skip_ok = skip_ok.bool()
    alpha = init0
    rows = []
    for t in range(em.shape[0]):
        stay, adv, skp = _sources(alpha, alpha if t > 0 else skip0, skip_ok)
        alpha = torch.logaddexp(torch.logaddexp(stay, adv), skp) + em[t]
        rows.append(alpha)
    return torch.stack(rows)


def _final_cells(alpha, input_lengths, target_lengths):
    """alpha at the trailing-blank cell ``2L_b`` and the last-label cell
    ``2L_b - 1`` of row ``input_length - 1`` (indices clamped into the
    lattice), each ``[B]``."""
    max_t, batch, max_s = alpha.shape
    t_idx = (input_lengths - 1).clamp(0, max_t - 1).long()
    s_a = (2 * target_lengths).clamp(0, max_s - 1).long()
    s_b = (2 * target_lengths - 1).clamp(0, max_s - 1).long()
    b_idx = torch.arange(batch, device=alpha.device)
    return alpha[t_idx, b_idx, s_a], alpha[t_idx, b_idx, s_b], s_a, s_b


def gather_final(alpha, input_lengths, target_lengths):
    """The log-add of the two final cells (one when ``L_b == 0``); 0 where
    ``inlen`` is outside ``[1, T]`` (the XLA scan's final value is never set
    there, and in a shard the final cells lie on another shard)."""
    a_a, a_b, _, _ = _final_cells(alpha, input_lengths, target_lengths)
    final = torch.where(target_lengths > 0, torch.logaddexp(a_a, a_b), a_a)
    own = (input_lengths >= 1) & (input_lengths <= alpha.shape[0])
    return torch.where(own, final, 0.0)


def gather_nll(alpha, input_lengths, target_lengths):
    """``nll[b] = -`` :func:`gather_final`."""
    return -gather_final(alpha, input_lengths, target_lengths)


def blank_shard_forward_plain(em, skip_ok, input_lengths, target_lengths,
                              init0, skip0):
    """``(alpha [t_s, B, S], final [B], boundary [B, S])`` of one T-shard:
    the recursion from the init rows, :func:`gather_final` with the
    shard-local ``input_lengths``, and the last alpha row (the kernel's
    three outputs)."""
    alpha = blank_shard_alpha_plain(em, skip_ok, init0, skip0)
    return (alpha, gather_final(alpha, input_lengths, target_lengths),
            alpha[-1].clone())


def _inject_row(alpha, input_lengths, target_lengths, bar):
    """``d(final * bar) / d alpha`` at row ``input_length - 1``: the bar
    times the softmax of the two final cells, ``[B, S]``."""
    max_s = alpha.shape[2]
    a_a, a_b, s_a, s_b = _final_cells(alpha, input_lengths, target_lengths)
    has_label = target_lengths > 0
    lse_f = torch.where(has_label, torch.logaddexp(a_a, a_b), a_a)
    w_a = torch.exp(a_a - lse_f)
    w_b = torch.where(has_label, torch.exp(a_b - lse_f), 0.0)
    pos = torch.arange(max_s, device=alpha.device)[None, :]
    return (
        torch.where(pos == s_a[:, None], (bar * w_a)[:, None], 0.0)
        + torch.where((pos == s_b[:, None]) & has_label[:, None],
                      (bar * w_b)[:, None], 0.0)
    ).to(alpha.dtype)


def blank_grad_plain(alpha, skip_ok, input_lengths, target_lengths,
                     nll_bar):
    """``g = d(sum nll * nll_bar) / d em`` from the alpha lattice."""
    return blank_shard_grad_plain(alpha, skip_ok, input_lengths,
                                  target_lengths, -nll_bar,
                                  torch.zeros_like(alpha[0]))


def blank_shard_grad_plain(alpha, skip_ok, input_lengths, target_lengths,
                           final_bar, g_seed):
    """``g`` of one T-shard: ``final_bar [B]`` is the cotangent of the
    final log-prob (injected at ``t == inlen_local - 1`` only), ``g_seed
    [B, S]`` that of the outgoing boundary row (added at the last local
    row)."""
    max_t = alpha.shape[0]
    skip_ok = skip_ok.bool()
    inject = _inject_row(alpha, input_lengths, target_lengths, final_bar)
    g_next = torch.zeros_like(alpha[0])
    rows = [None] * max_t
    for t in range(max_t - 1, -1, -1):
        g_t = torch.where((input_lengths - 1 == t)[:, None], inject, 0.0)
        if t == max_t - 1:
            g_t = g_t + g_seed
        else:
            # weights of the step t -> t+1 into each cell, read off alpha[t]
            # (the step into t+1 >= 1, so skip is open)
            stay, adv, skp = _sources(alpha[t], alpha[t], skip_ok)
            lse = torch.logaddexp(torch.logaddexp(stay, adv), skp)
            from_stay = g_next * torch.exp(stay - lse)
            from_adv = _shift_left(g_next * torch.exp(adv - lse), 1)
            from_skip = _shift_left(g_next * torch.exp(skp - lse), 2)
            g_t = g_t + ((from_stay + from_adv) + from_skip)
        rows[t] = g_t
        g_next = g_t
    return torch.stack(rows)


def init_row_grads(g0, init0, skip0, skip_ok):
    """``(d init0, d skip0)`` from ``g0``, the gradient of the first local
    alpha row: one step of the same three-way softmax weights, with the
    skip source read off ``skip0``."""
    stay, adv, skp = _sources(init0, skip0, skip_ok.bool())
    lse = torch.logaddexp(torch.logaddexp(stay, adv), skp)
    d_init0 = g0 * torch.exp(stay - lse) + _shift_left(
        g0 * torch.exp(adv - lse), 1)
    d_skip0 = _shift_left(g0 * torch.exp(skp - lse), 2)
    return d_init0, d_skip0


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def blank_alpha_kernel(em, skip_ok, input_lengths, target_lengths):
    """Launch the forward kernel in
    :func:`~ctc_tpu_torch.ops.lattice_cuda.forward_plan`'s layout for the
    width: ``(alpha [T, B, S], nll [B])`` from em ``[T, B, S]`` and the
    uint8 ``[B, S]`` skip mask, nll as :func:`gather_nll` computes it."""
    plan = forward_plan(em.shape[2], blank=True)
    _require("blank_lattice_forward", em=em, skip_ok=skip_ok,
             input_lengths=input_lengths, target_lengths=target_lengths)
    return launch(_SOURCE, "blank_lattice_forward", launch_counts,
                  (em, skip_ok, input_lengths, target_lengths),
                  forward_outputs(em), forward_dims(em.shape, plan))


def blank_grad_kernel(alpha, skip_ok, input_lengths, target_lengths,
                      nll_bar):
    """Launch the backward kernel: g ``[T, B, S]`` from alpha, in
    :func:`~ctc_tpu_torch.ops.lattice_cuda.backward_plan`'s layout for the
    width."""
    plan = backward_plan(alpha.shape[2], blank=True)
    _require("blank_lattice_backward", alpha=alpha, skip_ok=skip_ok,
             input_lengths=input_lengths, target_lengths=target_lengths,
             nll_bar=nll_bar)
    return launch(_SOURCE, "blank_lattice_backward", launch_counts,
                  (alpha, skip_ok, input_lengths, target_lengths, nll_bar),
                  torch.empty_like(alpha), backward_dims(alpha.shape, plan))


def blank_shard_forward_kernel(em, skip_ok, input_lengths, target_lengths,
                               init0, skip0):
    """Launch the shard forward kernel: ``(alpha [t_s, B, S], final [B],
    boundary [B, S])`` from em, the skip mask and the ``[B, S]`` init rows,
    as :func:`blank_shard_forward_plain` computes them.  em is read in
    place through its row stride (see
    :func:`~ctc_tpu_torch.ops.lattice_cuda.rows_layout`)."""
    t_s, batch, width = em.shape
    plan = shard_forward_plan(width, blank=True)
    _require_rows("blank_shard_forward", em)
    _require("blank_shard_forward", skip_ok=skip_ok,
             input_lengths=input_lengths, target_lengths=target_lengths,
             init0=init0, skip0=skip0)
    alpha = torch.empty((t_s, batch, width), device=em.device)
    return launch(_SOURCE, "blank_shard_forward", launch_counts,
                  (em, skip_ok, input_lengths, target_lengths, init0, skip0),
                  (alpha, torch.empty((batch,), device=em.device),
                   torch.empty_like(init0)),
                  (t_s, batch, width, em.stride(0), *plan))


def blank_shard_grad_kernel(alpha, skip_ok, input_lengths, target_lengths,
                            final_bar, g_seed, init0, skip0):
    """Launch the shard backward kernel: ``(g [t_s, B, S], d init0 [B, S],
    d skip0 [B, S])`` from alpha, the final log-prob's cotangent, the
    boundary row's ``g_seed`` and the init rows (the plain path's
    :func:`blank_shard_grad_plain` and :func:`init_row_grads` in one
    launch)."""
    plan = shard_backward_plan(alpha.shape[2], weights=3, mask_bytes=1)
    _require("blank_shard_backward", alpha=alpha, skip_ok=skip_ok,
             input_lengths=input_lengths, target_lengths=target_lengths,
             final_bar=final_bar, g_seed=g_seed, init0=init0, skip0=skip0)
    return launch(_SOURCE, "blank_shard_backward", launch_counts,
                  (alpha, skip_ok, input_lengths, target_lengths, final_bar,
                   g_seed, init0, skip0),
                  (torch.empty_like(alpha), torch.empty_like(init0),
                   torch.empty_like(skip0)), (*alpha.shape, *plan))


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


def _validate(em, skip_ok, input_lengths, target_lengths):
    """Check the operands; return the uint8 skip mask and the int32 length
    vectors on em's device."""
    if em.dim() != 3:
        raise ValueError(f"emissions must be [T, B, S], got {tuple(em.shape)}")
    if em.dtype != torch.float32:
        raise TypeError(f"emissions must be float32, got {em.dtype}")
    _, batch, max_s = em.shape
    if skip_ok.shape != (batch, max_s):
        raise ValueError(
            f"skip_ok must be [{batch}, {max_s}], got {tuple(skip_ok.shape)}"
        )
    out = []
    for name, x in (("skip_ok", skip_ok), ("input_lengths", input_lengths),
                    ("target_lengths", target_lengths)):
        if name != "skip_ok" and x.shape != (batch,):
            raise ValueError(f"{name} must be [{batch}], got {tuple(x.shape)}")
        if x.device != em.device:
            raise ValueError(
                f"{name} is on {x.device}, emissions on {em.device}"
            )
        want = torch.uint8 if name == "skip_ok" else torch.int32
        out.append(x.to(want).contiguous())
    return out


class BlankLatticeNLL(torch.autograd.Function):
    """Per-sample NLL ``[B]`` of em ``[T, B, S]``; saves alpha for the
    analytic backward.  ``use_kernel`` picks the CUDA kernels for both
    passes, else the plain version."""

    @staticmethod
    def forward(ctx, em, skip_ok, input_lengths, target_lengths, use_kernel):
        em = em.contiguous()
        if use_kernel:
            alpha, nll = blank_alpha_kernel(em, skip_ok, input_lengths,
                                            target_lengths)
        else:
            alpha = blank_alpha_plain(em, skip_ok)
            nll = gather_nll(alpha, input_lengths, target_lengths)
        ctx.save_for_backward(alpha, skip_ok, input_lengths, target_lengths)
        ctx.use_kernel = use_kernel
        return nll

    @staticmethod
    def backward(ctx, nll_bar):
        alpha, skip_ok, input_lengths, target_lengths = ctx.saved_tensors
        nll_bar = nll_bar.contiguous()
        grad = blank_grad_kernel if ctx.use_kernel else blank_grad_plain
        g = grad(alpha, skip_ok, input_lengths, target_lengths, nll_bar)
        return g, None, None, None, None


def blank_lattice_nll_plain(emissions, skip_ok, input_lengths,
                            target_lengths, *, layout="tbl"):
    """Plain PyTorch blank-lattice NLL ``[B]`` on any device, analytic
    gradient."""
    em = _to_tbl(emissions, layout)
    args = _validate(em, skip_ok, input_lengths, target_lengths)
    return BlankLatticeNLL.apply(em, *args, False)


def blank_lattice_nll_cuda(emissions, skip_ok, input_lengths, target_lengths,
                           *, layout="tbl"):
    """Per-sample blank-CTC NLL ``[B]`` through the CUDA kernels (signature
    of ``blank_lattice_nll_pallas``).

    ``layout='tbl'`` takes emissions ``[T, B, S]``; ``'tlb'`` takes
    ``[T, S, B]``, transposed here.  ``skip_ok`` is the ``[B, S]`` mask of
    slots a skip may enter; lengths count frames and labels (not slots).  A
    CUDA tensor launches the kernels; a CPU tensor runs the plain version;
    any other device raises.
    """
    em = _to_tbl(emissions, layout)
    if em.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no lattice implementation for {em.device}")
    args = _validate(em, skip_ok, input_lengths, target_lengths)
    return BlankLatticeNLL.apply(em, *args, em.is_cuda)


class BlankShardLattice(torch.autograd.Function):
    """One T-shard ``(em, init0, skip0) -> (final [B], boundary_out [B,
    S])``; saves alpha for the analytic backward.  ``use_kernel`` picks the
    CUDA kernels for both passes, else the plain version.

    The cotangent of an output nobody reads (the last shard's boundary row)
    arrives as zeros: ``ctx.set_materialize_grads`` keeps its default."""

    @staticmethod
    def forward(ctx, em, init0, skip0, skip_ok, input_lengths,
                target_lengths, use_kernel):
        init0, skip0 = init0.contiguous(), skip0.contiguous()
        if use_kernel:
            alpha, final, boundary = blank_shard_forward_kernel(
                rows_layout(em), skip_ok, input_lengths, target_lengths,
                init0, skip0)
        else:
            alpha, final, boundary = blank_shard_forward_plain(
                em, skip_ok, input_lengths, target_lengths, init0, skip0)
        ctx.save_for_backward(alpha, init0, skip0, skip_ok, input_lengths,
                              target_lengths)
        ctx.use_kernel = use_kernel
        return final, boundary

    @staticmethod
    def backward(ctx, final_bar, boundary_bar):
        (alpha, init0, skip0, skip_ok, input_lengths,
         target_lengths) = ctx.saved_tensors
        args = (alpha, skip_ok, input_lengths, target_lengths,
                final_bar.contiguous(), boundary_bar.contiguous())
        if ctx.use_kernel:
            g, d_init0, d_skip0 = blank_shard_grad_kernel(*args, init0, skip0)
        else:
            g = blank_shard_grad_plain(*args)
            d_init0, d_skip0 = init_row_grads(g[0], init0, skip0, skip_ok)
        return g, d_init0, d_skip0, None, None, None, None


def blank_shard_lattice_plain(em, init0, skip0, skip_ok, input_lengths,
                              target_lengths):
    """One T-shard through the plain version, on any device; see
    :func:`blank_shard_lattice_cuda`."""
    args = _validate(em, skip_ok, input_lengths, target_lengths)
    validate_rows(em, init0=init0, skip0=skip0)
    return BlankShardLattice.apply(em, init0, skip0, *args, False)


def blank_shard_lattice_cuda(em, init0, skip0, skip_ok, input_lengths,
                             target_lengths):
    """One sequence-shard of the blank-CTC lattice (port of
    ``blank_shard_lattice_pallas``, layout ``[t_s, B, S]``).

    ``init0`` / ``skip0`` are ``[B, S]``: the incoming boundary row for both
    on an interior shard, :func:`blank_alpha_init` and the sentinel row on
    shard 0.  ``input_lengths`` are SHARD-LOCAL (``inlen - t_offset``);
    ``target_lengths`` count labels, not slots.  Returns ``(final [B],
    boundary_out [B, S])``, differentiable in em and both init rows.  A
    CUDA tensor launches the kernels; a CPU tensor runs the plain version;
    any other device raises.
    """
    if em.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no lattice implementation for {em.device}")
    args = _validate(em, skip_ok, input_lengths, target_lengths)
    validate_rows(em, init0=init0, skip0=skip0)
    return BlankShardLattice.apply(em, init0, skip0, *args, em.is_cuda)
