"""Own-video eval loader, v1 twin, ``--my-dataset myvideo`` (port of
``ctc_tpu/data/loaders/myvideo.py``).

Start-time class-index o/v paths (+1-shifted to spare index 0 for a blank
slot) padded to the corpus max path length, at FPS=29.94.  Eval convention:
``(data, None)`` with the windows' ``features``, which the own-video
loaders always extract from the frames with the frozen I3D (cached under
``<cache>/<cache key>``); with no frames on disk the windows are empty.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from ctc_tpu_torch.data.charades_variants import MYVIDEO_LABELS, prepare_myvideo
from ctc_tpu_torch.data.features import extract_split_features


def _frame_counts(cfg, labels):
    return {
        vid: len(glob(os.path.join(cfg.rgb_my_data, vid, "*.jpg")))
        for vid in labels
    }


def own_video(cfg, labels, prepare, cache_key):
    """``(data, None)``: the windows of ``prepare`` with their extracted
    ``features`` under ``<cache>/<cache_key>``."""
    data = prepare(labels, _frame_counts(cfg, labels), cfg.temporal, cfg.gap,
                   rgb_root=cfg.rgb_my_data)
    if len(data["ids"]) == 0:
        return data, None
    from ctc_tpu_torch.data.loaders.charades_ctc_next_pred import _extractor

    feats = extract_split_features(
        data, _extractor(cfg), os.path.join(cfg.cache, cache_key),
        gap=cfg.gap, inputsize=cfg.inputsize,
    )
    data["features"] = np.asarray(feats)
    return data, None


def get(cfg, labels: dict | None = None):
    return own_video(cfg, labels or MYVIDEO_LABELS, prepare_myvideo,
                     "features_myvideo")
