"""Implementation dispatch for the lattice DP (port of
``ctc_tpu/ops/dispatch.py``).

``'cuda'`` is the hand-written kernel pair and takes CUDA tensors only;
``'torch'`` is the plain PyTorch version on any device (the oracle the
kernels are held to).  ``None`` picks by the tensor's device: the kernels
for a CUDA tensor, the plain version for a CPU tensor.
"""

from __future__ import annotations

from ctc_tpu_torch.ops.lattice_cuda import (
    noblank_lattice_nll_cuda,
    noblank_lattice_nll_plain,
)


def preferred_layout(implementation: str | None = None) -> str:
    """The emission layout the lattice consumes natively: ``[T, B, L]``.
    On the card the kernels read and write whole label rows of one sample
    contiguously, which is this layout."""
    del implementation
    return "tbl"


def lattice_nll(emissions, input_lengths, target_lengths, *,
                implementation: str | None = None, layout: str = "tbl"):
    """Per-sample blank-free lattice NLL ``[B]``.

    ``emissions`` are ``[T, B, L]`` for ``layout='tbl'`` or ``[T, L, B]``
    for ``'tlb'``.
    """
    if implementation is None:
        implementation = "cuda" if emissions.is_cuda else "torch"
    if implementation == "cuda":
        if not emissions.is_cuda:
            raise ValueError(
                "implementation='cuda' needs CUDA tensors, got emissions on "
                f"{emissions.device}"
            )
        return noblank_lattice_nll_cuda(
            emissions, input_lengths, target_lengths, layout=layout
        )
    if implementation == "torch":
        return noblank_lattice_nll_plain(
            emissions, input_lengths, target_lengths, layout=layout
        )
    raise ValueError(f"unknown lattice implementation {implementation!r}")
