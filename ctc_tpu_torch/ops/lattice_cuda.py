"""Blank-free CTC lattice DP: the two CUDA kernels and their plain version.

Port of ``ctc_tpu/ops/lattice_pallas.py`` (kernels) and
``ctc_tpu/ops/lattice_xla.py`` (plain version).  The lattice is the
(T x L) grid of (time step, label-path position) with only ``stay``
(l -> l) and ``advance`` (l-1 -> l) transitions::

    alpha[t, l] = em[t, l] + logaddexp(alpha[t-1, l], alpha[t-1, l-1])

with cells at ``l >= target_length`` set to the -1e13 sentinel before the
emission add.  The per-sample NLL is ``-alpha[input_length-1,
target_length-1]``; the gradient is the analytic posterior recursion over
the same lattice.

* :func:`noblank_lattice_nll_cuda` launches the kernels of
  ``csrc/noblank_lattice.cu`` on a CUDA tensor and runs the plain version on
  a CPU tensor.  It takes nothing else and never falls back.
* :func:`noblank_lattice_nll_plain` is the plain PyTorch version on any
  device: the CPU path, and the oracle the kernels are held to.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops.logspace import NEG_SENTINEL

#: launches of each kernel, counted where the wrapper launches it
launch_counts = {"noblank_lattice_forward": 0, "noblank_lattice_backward": 0}

_SOURCE = "noblank_lattice.cu"


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain version ([T, B, L], any device)
# ---------------------------------------------------------------------------


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """``out[..., l] = x[..., l-1]``, the sentinel at ``l = 0``."""
    pad = torch.full_like(x[..., :1], NEG_SENTINEL)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def noblank_alpha_plain(em, target_lengths):
    """The full alpha lattice ``[T, B, L]`` (the backward's residual)."""
    max_t, batch, max_l = em.shape
    pos = torch.arange(max_l, device=em.device)
    outside = pos[None, :] >= target_lengths[:, None]
    sentinel = torch.full((batch, max_l), NEG_SENTINEL, dtype=em.dtype,
                          device=em.device)
    alpha = torch.where(pos[None, :] == 0, 0.0, sentinel)
    rows = []
    for t in range(max_t):
        # t == 0 has no advance branch; the sentinel row is still log-added
        advance = _shift_right(alpha) if t > 0 else sentinel
        lse = torch.logaddexp(alpha, advance)
        lse = torch.where(outside, sentinel, lse)
        alpha = lse + em[t]
        rows.append(alpha)
    return torch.stack(rows)


def noblank_grad_plain(alpha, input_lengths, target_lengths, nll_bar):
    """``g = d(sum nll * nll_bar) / d em`` from the alpha lattice."""
    max_t, batch, max_l = alpha.shape
    pos = torch.arange(max_l, device=alpha.device)
    inside = (pos[None, :] < target_lengths[:, None]).to(alpha.dtype)
    inject = torch.where(
        pos[None, :] == (target_lengths - 1)[:, None], -nll_bar[:, None], 0.0
    ).to(alpha.dtype)  # [B, L], lands at t == input_length - 1
    zero = torch.zeros((batch, 1), dtype=alpha.dtype, device=alpha.device)
    g_next = torch.zeros((batch, max_l), dtype=alpha.dtype,
                         device=alpha.device)
    rows = [None] * max_t
    for t in range(max_t - 1, -1, -1):
        g_t = torch.where((input_lengths - 1 == t)[:, None], inject, 0.0)
        if t < max_t - 1:
            # weights of the step t -> t+1, read off alpha[t] as
            # sigmoid(stay - advance): on degenerate lattices both branches
            # are exactly the sentinel and the split must be 1/2, 1/2
            w_raw = torch.sigmoid(alpha[t] - _shift_right(alpha[t]))
            w_stay = w_raw * inside
            w_adv = (1.0 - w_raw) * inside
            from_adv = g_next * w_adv
            g_t = g_t + (
                g_next * w_stay + torch.cat([from_adv[:, 1:], zero], dim=1)
            )
        rows[t] = g_t
        g_next = g_t
    return torch.stack(rows)


def gather_nll(alpha, input_lengths, target_lengths):
    """``nll[b] = -alpha[inlen-1, b, tgt-1]``; 0 where ``inlen`` is outside
    ``[1, T]`` (the XLA path's final cell is never set there)."""
    max_t, batch, max_l = alpha.shape
    t_idx = (input_lengths - 1).clamp(0, max_t - 1).long()
    l_idx = (target_lengths - 1).clamp(0, max_l - 1).long()
    b_idx = torch.arange(batch, device=alpha.device)
    final = alpha[t_idx, b_idx, l_idx]
    own = (input_lengths >= 1) & (input_lengths <= max_t)
    return -torch.where(own, final, 0.0)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _require(kernel: str, **tensors) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of the type
    the kernel reads (int32 lengths, a uint8 ``skip_ok`` mask, float32
    otherwise) on one device."""
    device = None
    for name, t in tensors.items():
        want = (torch.int32 if name.endswith("lengths")
                else torch.uint8 if name == "skip_ok" else torch.float32)
        if not (t.is_cuda and t.dtype == want and t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous CUDA {want} tensor, "
                f"got {t.dtype} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)")
            )
        if device is not None and t.device != device:
            raise ValueError(f"{kernel}: operands on {device} and {t.device}")
        device = t.device


def noblank_alpha_kernel(em, target_lengths):
    """Launch the forward kernel: alpha ``[T, B, L]`` from em ``[T, B, L]``."""
    from ctc_tpu_torch.ops import cuda_build

    _require("noblank_lattice_forward", em=em, target_lengths=target_lengths)
    lib = cuda_build.load(_SOURCE)
    max_t, batch, max_l = em.shape
    alpha = torch.empty_like(em)
    with torch.cuda.device(em.device):
        stream = torch.cuda.current_stream(em.device).cuda_stream
        rc = lib.noblank_lattice_forward(
            em.data_ptr(), target_lengths.data_ptr(), alpha.data_ptr(),
            max_t, batch, max_l, stream,
        )
    _check(rc, "noblank_lattice_forward")
    launch_counts["noblank_lattice_forward"] += 1
    return alpha


def noblank_grad_kernel(alpha, input_lengths, target_lengths, nll_bar):
    """Launch the backward kernel: g ``[T, B, L]`` from alpha."""
    from ctc_tpu_torch.ops import cuda_build

    _require("noblank_lattice_backward", alpha=alpha,
             input_lengths=input_lengths, target_lengths=target_lengths,
             nll_bar=nll_bar)
    lib = cuda_build.load(_SOURCE)
    max_t, batch, max_l = alpha.shape
    g = torch.empty_like(alpha)
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        rc = lib.noblank_lattice_backward(
            alpha.data_ptr(), input_lengths.data_ptr(),
            target_lengths.data_ptr(), nll_bar.data_ptr(), g.data_ptr(),
            max_t, batch, max_l, stream,
        )
    _check(rc, "noblank_lattice_backward")
    launch_counts["noblank_lattice_backward"] += 1
    return g


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


def _validate(em, input_lengths, target_lengths):
    """Check the operands and return the int32 length vectors on em's
    device."""
    if em.dim() != 3:
        raise ValueError(f"emissions must be [T, B, L], got {tuple(em.shape)}")
    if em.dtype != torch.float32:
        raise TypeError(f"emissions must be float32, got {em.dtype}")
    batch = em.shape[1]
    out = []
    for name, x in (("input_lengths", input_lengths),
                    ("target_lengths", target_lengths)):
        if x.shape != (batch,):
            raise ValueError(f"{name} must be [{batch}], got {tuple(x.shape)}")
        if x.device != em.device:
            raise ValueError(
                f"{name} is on {x.device}, emissions on {em.device}"
            )
        out.append(x.to(torch.int32).contiguous())
    return out


class NoBlankLatticeNLL(torch.autograd.Function):
    """Per-sample NLL ``[B]`` of em ``[T, B, L]``; saves alpha for the
    analytic backward.  ``use_kernel`` picks the CUDA kernels for both
    passes, else the plain version."""

    @staticmethod
    def forward(ctx, em, input_lengths, target_lengths, use_kernel):
        em = em.contiguous()
        if use_kernel:
            alpha = noblank_alpha_kernel(em, target_lengths)
        else:
            alpha = noblank_alpha_plain(em, target_lengths)
        ctx.save_for_backward(alpha, input_lengths, target_lengths)
        ctx.use_kernel = use_kernel
        return gather_nll(alpha, input_lengths, target_lengths)

    @staticmethod
    def backward(ctx, nll_bar):
        alpha, input_lengths, target_lengths = ctx.saved_tensors
        nll_bar = nll_bar.contiguous()
        if ctx.use_kernel:
            g = noblank_grad_kernel(alpha, input_lengths, target_lengths,
                                    nll_bar)
        else:
            g = noblank_grad_plain(alpha, input_lengths, target_lengths,
                                   nll_bar)
        return g, None, None, None


def _to_tbl(emissions, layout):
    if layout == "tbl":
        return emissions
    if layout == "tlb":
        return emissions.transpose(1, 2)
    raise ValueError(f"unknown layout {layout!r}")


def noblank_lattice_nll_plain(emissions, input_lengths, target_lengths, *,
                              layout="tbl"):
    """Plain PyTorch lattice NLL ``[B]`` on any device, analytic gradient."""
    em = _to_tbl(emissions, layout)
    inlen, tgt = _validate(em, input_lengths, target_lengths)
    return NoBlankLatticeNLL.apply(em, inlen, tgt, False)


def noblank_lattice_nll_cuda(emissions, input_lengths, target_lengths, *,
                             layout="tbl"):
    """Per-sample NLL ``[B]`` through the CUDA kernels (signature of
    ``noblank_lattice_nll_pallas``).

    ``layout='tbl'`` takes emissions ``[T, B, L]``; ``'tlb'`` takes
    ``[T, L, B]``, transposed here.  A CUDA tensor launches the kernels; a
    CPU tensor runs the plain version; any other device raises.
    """
    em = _to_tbl(emissions, layout)
    if em.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no lattice implementation for {em.device}")
    inlen, tgt = _validate(em, input_lengths, target_lengths)
    return NoBlankLatticeNLL.apply(em, inlen, tgt, em.is_cuda)
