"""Own-video eval loader, c_class twin, ``--my-dataset myvideo_c_class``
(port of ``ctc_tpu/data/loaders/myvideo_c_class.py``).

157-class start-time index paths with ``adjust_time=4`` and the frames
offset by 50, for blank-CTC models over the combined class space.  Eval
convention: ``(data, None)`` with the extracted ``features`` (see
:mod:`ctc_tpu_torch.data.loaders.myvideo`).
"""

from __future__ import annotations

from ctc_tpu_torch.data.charades_variants import (
    MYVIDEO_LABELS,
    prepare_myvideo_c_class,
)
from ctc_tpu_torch.data.loaders.myvideo import own_video


def get(cfg, labels: dict | None = None):
    return own_video(cfg, labels or MYVIDEO_LABELS, prepare_myvideo_c_class,
                     "features_myvideo_c_class")
