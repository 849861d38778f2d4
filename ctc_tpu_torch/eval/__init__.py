"""Evaluation (port of ``ctc_tpu/eval``): so far the window decode and
alignment of ``eval/video.py``."""

from ctc_tpu_torch.eval.video import align_windows, decode_windows

__all__ = ["align_windows", "decode_windows"]
