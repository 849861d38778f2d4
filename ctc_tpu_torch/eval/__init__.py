"""Video-level evaluation: Charades mAP and visual-relation tagging (port
of ``ctc_tpu/eval``); :mod:`ctc_tpu_torch.eval.video` drives them and
decodes and aligns windows."""

from ctc_tpu_torch.eval.map import charades_map, mean_average_precision
from ctc_tpu_torch.eval.relation import (
    compose_ov_predictions,
    compose_predictions,
    eval_tagging_scores,
    eval_visual_relation,
    voc_ap,
)

__all__ = [
    "mean_average_precision",
    "charades_map",
    "eval_tagging_scores",
    "voc_ap",
    "eval_visual_relation",
    "compose_predictions",
    "compose_ov_predictions",
]
