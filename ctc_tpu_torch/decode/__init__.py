"""Decoding (port of ``ctc_tpu/decode``): greedy and beam-search CTC decode,
and the blank-free Viterbi alignment."""

from ctc_tpu_torch.decode.greedy import collapse_repeats, greedy_decode
from ctc_tpu_torch.decode.beam import beam_search_decode
from ctc_tpu_torch.decode.viterbi import viterbi_align

__all__ = [
    "greedy_decode",
    "collapse_repeats",
    "beam_search_decode",
    "viterbi_align",
]
