"""Own-video eval loader, ver3 twin, ``--my-dataset myvideo_ver3`` (port of
``ctc_tpu/data/loaders/myvideo_ver3.py``).

Current-time o/v single-label targets on a fixed ``temporal``-step time
grid.  Eval convention: ``(data, None)`` with the extracted ``features``
(see :mod:`ctc_tpu_torch.data.loaders.myvideo`).
"""

from __future__ import annotations

from ctc_tpu_torch.data.charades_variants import (
    MYVIDEO_LABELS,
    prepare_myvideo_ver3,
)
from ctc_tpu_torch.data.loaders.myvideo import own_video


def get(cfg, labels: dict | None = None):
    return own_video(cfg, labels or MYVIDEO_LABELS, prepare_myvideo_ver3,
                     "features_myvideo_ver3")
