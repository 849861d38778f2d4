"""Implementation dispatch for the lattice DPs (port of
``ctc_tpu/ops/dispatch.py``).

``'cuda'`` is the hand-written kernel pair and takes CUDA tensors only;
``'torch'`` is the plain PyTorch version on any device (the oracle the
kernels are held to).  ``None`` picks by the tensor's device: the kernels
for a CUDA tensor, the plain version for a CPU tensor.
"""

from __future__ import annotations

from ctc_tpu_torch.ops.blank_lattice_cuda import (
    blank_lattice_nll_cuda,
    blank_lattice_nll_plain,
    blank_shard_lattice_cuda,
    blank_shard_lattice_plain,
)
from ctc_tpu_torch.ops.lattice_cuda import (
    noblank_lattice_nll_cuda,
    noblank_lattice_nll_plain,
    noblank_shard_lattice_cuda,
    noblank_shard_lattice_plain,
)


def preferred_layout(implementation: str | None = None) -> str:
    """The emission layout the lattice consumes natively: ``[T, B, L]``.
    On the card the kernels read and write whole label rows of one sample
    contiguously, which is this layout."""
    del implementation
    return "tbl"


def _pick(emissions, implementation, cuda_fn, plain_fn):
    if implementation is None:
        implementation = "cuda" if emissions.is_cuda else "torch"
    if implementation == "cuda":
        if not emissions.is_cuda:
            raise ValueError(
                "implementation='cuda' needs CUDA tensors, got emissions on "
                f"{emissions.device}"
            )
        return cuda_fn
    if implementation == "torch":
        return plain_fn
    raise ValueError(f"unknown lattice implementation {implementation!r}")


def lattice_nll(emissions, input_lengths, target_lengths, *,
                implementation: str | None = None, layout: str = "tbl"):
    """Per-sample blank-free lattice NLL ``[B]``.

    ``emissions`` are ``[T, B, L]`` for ``layout='tbl'`` or ``[T, L, B]``
    for ``'tlb'``.
    """
    fn = _pick(emissions, implementation, noblank_lattice_nll_cuda,
               noblank_lattice_nll_plain)
    return fn(emissions, input_lengths, target_lengths, layout=layout)


def blank_lattice_nll(emissions, skip_ok, input_lengths, target_lengths, *,
                      implementation: str | None = None,
                      layout: str = "tbl"):
    """Per-sample blank-CTC lattice NLL ``[B]``.

    ``emissions`` are ``[T, B, S]`` for ``layout='tbl'`` or ``[T, S, B]``
    for ``'tlb'``; ``skip_ok`` is the ``[B, S]`` skip-permission mask.
    """
    fn = _pick(emissions, implementation, blank_lattice_nll_cuda,
               blank_lattice_nll_plain)
    return fn(emissions, skip_ok, input_lengths, target_lengths,
              layout=layout)


def shard_lattice(em, stay0, adv0, input_lengths, target_lengths, *,
                  implementation: str | None = None):
    """One T-shard of the blank-free lattice, ``em [t_s, B, L]``, with its
    ``[B, L]`` init rows and shard-local input lengths -> ``(final [B],
    boundary_out [B, L])``."""
    fn = _pick(em, implementation, noblank_shard_lattice_cuda,
               noblank_shard_lattice_plain)
    return fn(em, stay0, adv0, input_lengths, target_lengths)


def blank_shard_lattice(em, init0, skip0, skip_ok, input_lengths,
                        target_lengths, *, implementation: str | None = None):
    """One T-shard of the blank-CTC lattice, ``em [t_s, B, S]``, with its
    ``[B, S]`` init rows, the skip mask and shard-local input lengths ->
    ``(final [B], boundary_out [B, S])``."""
    fn = _pick(em, implementation, blank_shard_lattice_cuda,
               blank_shard_lattice_plain)
    return fn(em, init0, skip0, skip_ok, input_lengths, target_lengths)
