"""Own-video eval loader, v1 twin, ``--my-dataset myvideo`` (port of
``ctc_tpu/data/loaders/myvideo.py``).

Start-time class-index o/v paths (+1-shifted to spare index 0 for a blank
slot) padded to the corpus max path length, at FPS=29.94.  Eval convention:
``(data, None)``.  These loaders always extract features from the frames
(ROADMAP Queue 1 item 12), so with frames on disk they raise until it
lands; with none they return the empty windows.
"""

from __future__ import annotations

import os
from glob import glob

from ctc_tpu_torch.data.charades_variants import MYVIDEO_LABELS, prepare_myvideo
from ctc_tpu_torch.data.features import extraction_not_ported


def _frame_counts(cfg, labels):
    return {
        vid: len(glob(os.path.join(cfg.rgb_my_data, vid, "*.jpg")))
        for vid in labels
    }


def own_video(cfg, labels, prepare, name):
    """``(data, None)`` for windows with no frames; else the features
    would be extracted (item 12)."""
    data = prepare(labels, _frame_counts(cfg, labels), cfg.temporal, cfg.gap,
                   rgb_root=cfg.rgb_my_data)
    if len(data["ids"]) == 0:
        return data, None
    raise extraction_not_ported(f"--my-dataset {name}")


def get(cfg, labels: dict | None = None):
    return own_video(cfg, labels or MYVIDEO_LABELS, prepare_myvideo,
                     "myvideo")
