"""Loader for the ver3 future-CE dataset, ``--dataset charades_ver3`` (port
of ``ctc_tpu/data/loaders/charades_ver3.py``).

Same first-window sampling as ver2 but the target is a *single* future-time
multi-hot o/v vector: a plain classification problem over the future
label, not a lattice path.  Train with a final-step loss: ``--loss bce`` or
``--loss mlce`` (multi-hot objects), or ``--loss ce`` (the first future
verb as a class index).
"""

from __future__ import annotations

import functools

import numpy as np

from ctc_tpu_torch.data.charades_variants import prepare_ver3
from ctc_tpu_torch.data.loaders._common import split_batches


def collate_ver3(data: dict, indices, features: np.ndarray, loss: str) -> dict:
    idx = list(indices)
    o = np.stack([np.asarray(data["o_targets"][i], np.float32) for i in idx])
    v = np.stack([np.asarray(data["v_targets"][i], np.float32) for i in idx])
    temporal = features.shape[1]
    if loss == "ce":
        paths = np.argmax(v, axis=1).astype(np.int32)  # first future verb
        future = paths
    else:
        paths = o
        future = np.argmax(o, axis=1).astype(np.int32)
    return {
        "feats": np.asarray(features, np.float32),
        "paths": paths,
        # lengths are unused by final-step losses; kept for the batch contract
        "input_lengths": np.full((len(idx),), temporal, np.int64),
        "target_lengths": np.ones((len(idx),), np.int64),
        "future_target": future,
    }


def get(cfg):
    def prepare_for(split):
        def prepare(labels, frame_counts):
            return prepare_ver3(
                labels, frame_counts, split, cfg.temporal, cfg.gap,
                cfg.num_trans, rgb_root=cfg.rgb_data,
            )

        return prepare

    collate = functools.partial(collate_ver3, loss=cfg.loss)
    return tuple(
        split_batches(cfg, split, csv_file, prepare_for(split),
                      "features_ver3", collate)
        for split, csv_file in
        (("train", cfg.train_file), ("val", cfg.val_file))
    )
