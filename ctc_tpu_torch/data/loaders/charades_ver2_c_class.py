"""Loader for the 157-class single-label variant, standard blank CTC (port
of ``ctc_tpu/data/loaders/charades_ver2_c_class.py``).

Batches pair cached I3D features with the ``c_target`` class-index paths of
:func:`ctc_tpu_torch.data.charades_variants.prepare_c_class`; train with
``--loss blank`` (the reference trains these with torch.nn.CTCLoss over the
combined classes).
"""

from __future__ import annotations

import numpy as np

from ctc_tpu_torch.data.charades_variants import prepare_c_class
from ctc_tpu_torch.data.loaders._common import split_batches


def collate_c_class(data: dict, indices, features: np.ndarray) -> dict:
    idx = list(indices)
    paths = np.stack([np.asarray(data["c_targets"][i]) for i in idx])
    temporal = features.shape[1]
    return {
        "feats": np.asarray(features, np.float32),
        "paths": paths.astype(np.int32),
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": np.asarray([data["times"][i] for i in idx], np.int64),
        "future_target": np.asarray(
            [np.asarray(data["c_targets"][i])[max(data["times"][i] - 1, 0)]
             for i in idx],
            np.int32,
        ),
    }


def get(cfg):
    def prepare_for(split):
        def prepare(labels, frame_counts):
            return prepare_c_class(
                labels, frame_counts, split, cfg.temporal, cfg.gap,
                rgb_root=cfg.rgb_data,
            )

        return prepare

    return tuple(
        split_batches(cfg, split, csv_file, prepare_for(split),
                      "features_cclass", collate_c_class)
        for split, csv_file in
        (("train", cfg.train_file), ("val", cfg.val_file))
    )
