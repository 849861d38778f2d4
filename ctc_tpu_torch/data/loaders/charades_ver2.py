"""Loader for the ver2 CTC+prediction dataset, ``--dataset charades_ver2``
(port of ``ctc_tpu/data/loaders/charades_ver2.py``).

First-window-only sampling: one sample per video starting at the first
label, multi-hot o/v paths padded to ``temporal`` with -1, and the first
label past the window end included as the final (future) path step.  Train
with ``--loss binary`` over the object paths.  ``get_val_video`` pairs the
val windows with the ver2 groundtruth table for video-level evaluation; it
reads the ``features_ver2_val`` features of ``get()`` (same windows).
"""

from __future__ import annotations

import numpy as np

from ctc_tpu_torch.data import charades as charades_data
from ctc_tpu_torch.data.charades_variants import (
    prepare_ver2,
    prepare_ver2_future_groundtruth,
    prepare_ver2_groundtruth,
)
from ctc_tpu_torch.data.loaders._common import (
    prepared_split,
    split_batches,
    split_features,
)


def collate_ver2(data: dict, indices, features: np.ndarray) -> dict:
    """Multi-hot object-path batch; the last in-length path step is the
    reference's future label, so it doubles as the top-k metric target."""
    idx = list(indices)
    paths = np.stack(
        [np.asarray(data["o_targets"][i], np.float32) for i in idx]
    )
    paths = np.where(paths < 0, 0.0, paths)
    lengths = np.asarray([int(data["times"][i]) for i in idx], np.int64)
    temporal = features.shape[1]
    future = np.asarray(
        [int(np.argmax(paths[row, max(lengths[row] - 1, 0)]))
         for row in range(len(idx))],
        np.int32,
    )
    return {
        "feats": np.asarray(features, np.float32),
        "paths": paths,
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": lengths,
        "future_target": future,
    }


def _prepare(cfg):
    def prepare(labels, frame_counts):
        return prepare_ver2(
            labels, frame_counts, cfg.temporal, cfg.gap, cfg.num_trans,
            rgb_root=cfg.rgb_data,
        )

    return prepare


def get(cfg):
    return tuple(
        split_batches(cfg, split, csv_file, _prepare(cfg), "features_ver2",
                      collate_ver2)
        for split, csv_file in
        (("train", cfg.train_file), ("val", cfg.val_file))
    )


def get_val_video(cfg):
    """Val windows + ver2 ``[s, o, v]`` gt_table + features for video-level
    evaluation (ROADMAP Queue 1 item 10)."""
    labels, data = prepared_split(cfg, cfg.val_file, _prepare(cfg))
    gt_table = prepare_ver2_groundtruth(
        labels, cfg.temporal, cfg.gap, cfg.num_trans
    )
    if len(data["ids"]) == 0:
        return data, gt_table
    # same windows as get()'s val split -> same features
    data["features"] = np.asarray(
        split_features(cfg, data, "features_ver2", "val")
    )
    return data, gt_table


def get_future_groundtruth(cfg):
    """Future-label gt_table, for future-prediction video scoring."""
    labels = charades_data.parse_charades_csv(cfg.val_file)
    return prepare_ver2_future_groundtruth(labels, cfg.temporal, cfg.gap)
