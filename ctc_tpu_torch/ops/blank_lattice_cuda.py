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
outside ``[1, T]``; the gradient is the analytic reverse occupancy recursion
with three-way softmax branch weights.  No validity mask is applied:
transitions only move to higher ``s``, so cells past ``2L_b`` never feed the
cells the loss reads, and their gradient is exactly 0.

* :func:`blank_lattice_nll_cuda` launches the kernels of
  ``csrc/blank_lattice.cu`` on a CUDA tensor and runs the plain version on a
  CPU tensor.  It takes nothing else and never falls back.
* :func:`blank_lattice_nll_plain` is the plain PyTorch version on any
  device: the CPU path, and the oracle the kernels are held to.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops.lattice_cuda import _check, _require, _to_tbl
from ctc_tpu_torch.ops.logspace import BLANK_NEG

#: launches of each kernel, counted where the wrapper launches it
launch_counts = {"blank_lattice_forward": 0, "blank_lattice_backward": 0}

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


def _sources(alpha_prev, skip_ok, skip_open: bool):
    """The stay, advance and skip source scores of every cell from the row
    before; the skip source is the sentinel where it is not permitted."""
    adv = _shift_right(alpha_prev, 1)
    skp = _shift_right(alpha_prev, 2)
    skp = torch.where(skip_ok & skip_open, skp, BLANK_NEG)
    return alpha_prev, adv, skp


def blank_alpha_plain(em, skip_ok):
    """The full alpha lattice ``[T, B, S]`` (the backward's residual) from
    em ``[T, B, S]`` and the ``[B, S]`` skip mask."""
    max_t, batch, max_s = em.shape
    skip_ok = skip_ok.bool()
    pos = torch.arange(max_s, device=em.device)
    alpha = torch.where(
        pos[None, :] == 0, 0.0,
        torch.full((batch, max_s), BLANK_NEG, dtype=em.dtype,
                   device=em.device),
    )
    rows = []
    for t in range(max_t):
        # skip is illegal at t == 0: it would alias the s == 0 init cell
        stay, adv, skp = _sources(alpha, skip_ok, t > 0)
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


def gather_nll(alpha, input_lengths, target_lengths):
    """``nll[b] = -logaddexp`` of the two final cells (one when
    ``L_b == 0``); 0 where ``inlen`` is outside ``[1, T]`` (the XLA scan's
    final value is never set there)."""
    a_a, a_b, _, _ = _final_cells(alpha, input_lengths, target_lengths)
    final = torch.where(target_lengths > 0, torch.logaddexp(a_a, a_b), a_a)
    own = (input_lengths >= 1) & (input_lengths <= alpha.shape[0])
    return -torch.where(own, final, 0.0)


def _inject_row(alpha, input_lengths, target_lengths, nll_bar):
    """``d(nll * nll_bar) / d alpha`` at row ``input_length - 1``: minus
    the bar times the softmax of the two final cells, ``[B, S]``."""
    max_s = alpha.shape[2]
    a_a, a_b, s_a, s_b = _final_cells(alpha, input_lengths, target_lengths)
    has_label = target_lengths > 0
    lse_f = torch.where(has_label, torch.logaddexp(a_a, a_b), a_a)
    w_a = torch.exp(a_a - lse_f)
    w_b = torch.where(has_label, torch.exp(a_b - lse_f), 0.0)
    pos = torch.arange(max_s, device=alpha.device)[None, :]
    return (
        torch.where(pos == s_a[:, None], (-nll_bar * w_a)[:, None], 0.0)
        + torch.where((pos == s_b[:, None]) & has_label[:, None],
                      (-nll_bar * w_b)[:, None], 0.0)
    ).to(alpha.dtype)


def blank_grad_plain(alpha, skip_ok, input_lengths, target_lengths,
                     nll_bar):
    """``g = d(sum nll * nll_bar) / d em`` from the alpha lattice."""
    max_t = alpha.shape[0]
    skip_ok = skip_ok.bool()
    inject = _inject_row(alpha, input_lengths, target_lengths, nll_bar)
    g_next = torch.zeros_like(alpha[0])
    rows = [None] * max_t
    for t in range(max_t - 1, -1, -1):
        g_t = torch.where((input_lengths - 1 == t)[:, None], inject, 0.0)
        if t < max_t - 1:
            # weights of the step t -> t+1 into each cell, read off alpha[t]
            # (the step into t+1 >= 1, so skip is open)
            stay, adv, skp = _sources(alpha[t], skip_ok, True)
            lse = torch.logaddexp(torch.logaddexp(stay, adv), skp)
            from_stay = g_next * torch.exp(stay - lse)
            from_adv = _shift_left(g_next * torch.exp(adv - lse), 1)
            from_skip = _shift_left(g_next * torch.exp(skp - lse), 2)
            g_t = g_t + ((from_stay + from_adv) + from_skip)
        rows[t] = g_t
        g_next = g_t
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def blank_alpha_kernel(em, skip_ok):
    """Launch the forward kernel: alpha ``[T, B, S]`` from em ``[T, B, S]``
    and the uint8 ``[B, S]`` skip mask."""
    from ctc_tpu_torch.ops import cuda_build

    _require("blank_lattice_forward", em=em, skip_ok=skip_ok)
    lib = cuda_build.load(_SOURCE)
    max_t, batch, max_s = em.shape
    alpha = torch.empty_like(em)
    with torch.cuda.device(em.device):
        stream = torch.cuda.current_stream(em.device).cuda_stream
        rc = lib.blank_lattice_forward(
            em.data_ptr(), skip_ok.data_ptr(), alpha.data_ptr(),
            max_t, batch, max_s, stream,
        )
    _check(rc, "blank_lattice_forward")
    launch_counts["blank_lattice_forward"] += 1
    return alpha


def blank_grad_kernel(alpha, skip_ok, input_lengths, target_lengths,
                      nll_bar):
    """Launch the backward kernel: g ``[T, B, S]`` from alpha."""
    from ctc_tpu_torch.ops import cuda_build

    _require("blank_lattice_backward", alpha=alpha, skip_ok=skip_ok,
             input_lengths=input_lengths, target_lengths=target_lengths,
             nll_bar=nll_bar)
    lib = cuda_build.load(_SOURCE)
    max_t, batch, max_s = alpha.shape
    g = torch.empty_like(alpha)
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        rc = lib.blank_lattice_backward(
            alpha.data_ptr(), skip_ok.data_ptr(), input_lengths.data_ptr(),
            target_lengths.data_ptr(), nll_bar.data_ptr(), g.data_ptr(),
            max_t, batch, max_s, stream,
        )
    _check(rc, "blank_lattice_backward")
    launch_counts["blank_lattice_backward"] += 1
    return g


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
            alpha = blank_alpha_kernel(em, skip_ok)
        else:
            alpha = blank_alpha_plain(em, skip_ok)
        ctx.save_for_backward(alpha, skip_ok, input_lengths, target_lengths)
        ctx.use_kernel = use_kernel
        return gather_nll(alpha, input_lengths, target_lengths)

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
