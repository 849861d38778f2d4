"""Lattice math: log-space helpers, emission scores, the lattice DP (CUDA
kernels and their plain PyTorch version)."""

from ctc_tpu_torch.ops.logspace import (
    BCE_LOG_CLAMP,
    BLANK_NEG,
    NEG_SENTINEL,
    clamped_log_sigmoid_pair,
)
from ctc_tpu_torch.ops.emissions import (
    binary_ce_emissions,
    gather_log_softmax_emissions,
)
from ctc_tpu_torch.ops.lattice_cuda import (
    noblank_lattice_nll_cuda,
    noblank_lattice_nll_plain,
)

__all__ = [
    "BCE_LOG_CLAMP",
    "BLANK_NEG",
    "NEG_SENTINEL",
    "clamped_log_sigmoid_pair",
    "binary_ce_emissions",
    "gather_log_softmax_emissions",
    "noblank_lattice_nll_cuda",
    "noblank_lattice_nll_plain",
]
