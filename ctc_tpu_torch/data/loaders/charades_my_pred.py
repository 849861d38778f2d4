"""Own-video ('my dataset') evaluation loader, the reference's default
``--my-dataset charades_my_pred`` (port of
``ctc_tpu/data/loaders/charades_my_pred.py``): dense stride-1 windows over
the self-recorded video with the hardcoded label dict.

Returns ``(data, None)`` with the extracted ``features``
(see :mod:`ctc_tpu_torch.data.loaders.myvideo`).
"""

from __future__ import annotations

from ctc_tpu_torch.data.charades_variants import MYVIDEO_LABELS, prepare_my_pred
from ctc_tpu_torch.data.loaders.myvideo import own_video


def get(cfg, labels: dict | None = None):
    return own_video(cfg, labels or MYVIDEO_LABELS, prepare_my_pred,
                     "features_my_pred")
